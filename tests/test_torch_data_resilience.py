"""The feed of the port's pretraining held to the JAX package's on the
CPU: the resilient shard reader (retries, injected shard errors, the skip
and abort policies, the fault records), the loader's spawned workers, the
device prefetcher and the ``h2d_wait`` sub-phase of the step windows.

Same shards, same seeds: items and batches byte-equal, fault records equal
key for key. The JAX loader's workers are never spawned here (they import
JAX); the port's are held to its own thread path and to the JAX thread
path."""

import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from bert_pytorch_tpu.data import dataset as jax_dataset
from bert_pytorch_tpu.data.device_prefetch import (
    DevicePrefetcher as JaxPrefetcher)
from bert_pytorch_tpu.data.loader import DataLoader as JaxLoader
from bert_pytorch_tpu.data.sampler import DistributedSampler as JaxSampler
from bert_pytorch_tpu.telemetry.step_timer import StepTimer as JaxTimer
from bert_pytorch_tpu.testing import faults as jax_faults
from bert_pytorch_tpu_torch import pretrain
from bert_pytorch_tpu_torch.data import dataset as port_dataset
from bert_pytorch_tpu_torch.data.device_prefetch import (DevicePrefetcher,
                                                         HostToDevice)
from bert_pytorch_tpu_torch.data.loader import DataLoader
from bert_pytorch_tpu_torch.data.sampler import DistributedSampler
from bert_pytorch_tpu_torch.telemetry import schema
from bert_pytorch_tpu_torch.telemetry.step_timer import StepTimer
from bert_pytorch_tpu_torch.testing import faults as port_faults
from bert_pytorch_tpu_torch.tools.make_synthetic_data import make_shard

from loader_rows import RowsDataset

SEQ, VOCAB, ROWS = 32, 128, 24
MASKING = dict(mask_token_index=4, max_pred_per_seq=5, masked_lm_prob=0.15,
               vocab_size=VOCAB, seed=3)


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("resilience")
    for s in range(3):
        make_shard(str(root / f"shard_{s}.hdf5"), ROWS, SEQ, VOCAB, seed=s)
    return root


def _files(root):
    return sorted(str(root / f) for f in os.listdir(root)
                  if f.endswith(".hdf5"))


def _read_all(cls, files, spec="", **kwargs):
    """(items, fault records) of every row of a dataset built under the
    armed ``spec`` (both packages' plans disarmed after)."""
    records = []
    try:
        port_faults.arm(spec)
        jax_faults.arm(spec)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ds = cls(files, on_fault=records.append,
                     retry_base_delay_s=0.001, **MASKING, **kwargs)
            items = [ds[i] for i in range(len(ds))]
            # The read-ahead of the next (cyclic) shard ends under this
            # plan, not the next test's.
            ds._next_file_thread.join()
    finally:
        port_faults.arm("")
        jax_faults.arm("")
    return items, records


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("spec", ["", "shard_errorx2", "shard_errorx5"])
def test_reader_matches_jax_under_injected_errors(shard_dir, spec):
    """Byte-equal items and the same fault records (kinds, keys, values)
    with no fault, two injected errors (retried within one read), and
    five (spread over reads: each read retries twice)."""
    files = _files(shard_dir)
    want, want_records = _read_all(jax_dataset.ShardedPretrainingDataset,
                                   files, spec)
    got, got_records = _read_all(port_dataset.ShardedPretrainingDataset,
                                 files, spec)
    _assert_items_equal(got, want)
    assert got_records == want_records
    kinds = [r["fault"] for r in got_records]
    if spec:
        assert {"injected_shard_error", "shard_read_retry"} <= set(kinds)
        for r in got_records:
            assert schema.validate_record(r) == []
    else:
        assert kinds == []


def test_reader_skips_or_aborts_like_jax(shard_dir, tmp_path):
    """An unreadable shard: 'skip' keeps the rest with the JAX records
    (the retries, then shard_skipped); 'abort' raises DataReadError in
    both packages."""
    broken = tmp_path / "shard_1b.hdf5"
    broken.write_bytes(b"not an hdf5 file")
    files = _files(shard_dir) + [str(broken)]
    want, want_records = _read_all(jax_dataset.ShardedPretrainingDataset,
                                   files, shard_error_policy="skip")
    got, got_records = _read_all(port_dataset.ShardedPretrainingDataset,
                                 files, shard_error_policy="skip")
    _assert_items_equal(got, want)
    assert len(got) == 3 * ROWS
    assert got_records == want_records
    assert [r["fault"] for r in got_records] == [
        "shard_read_retry", "shard_read_retry", "shard_skipped"]
    with pytest.raises(port_dataset.DataReadError, match="abort"):
        _read_all(port_dataset.ShardedPretrainingDataset, files,
                  shard_error_policy="abort")
    with pytest.raises(jax_dataset.DataReadError, match="abort"):
        _read_all(jax_dataset.ShardedPretrainingDataset, files,
                  shard_error_policy="abort")
    with pytest.raises(ValueError, match="shard_error_policy"):
        port_dataset.ShardedPretrainingDataset(
            files, shard_error_policy="ignore", **MASKING)


def test_mid_stream_read_failure_raises(shard_dir, tmp_path):
    """A verified shard that stops reading past the retries raises
    DataReadError at the swap (the index space is fixed at start-up)."""
    files = [str(tmp_path / f"s{i}.hdf5") for i in range(2)]
    for i, path in enumerate(files):
        make_shard(path, ROWS, SEQ, VOCAB, seed=i)
    ds = port_dataset.ShardedPretrainingDataset(
        files, read_retries=1, retry_base_delay_s=0.001, **MASKING)
    ds[0]
    ds._next_file_thread.join()
    os.remove(files[1])
    ds._next_file_thread = ds._async_load_file(1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(port_dataset.DataReadError, match="2 attempt"):
            ds[ROWS]


def test_dataset_pickles_without_its_stream(shard_dir):
    import pickle

    ds = port_dataset.ShardedPretrainingDataset(
        _files(shard_dir), on_fault=lambda r: None, **MASKING)
    first = ds[0]
    back = pickle.loads(pickle.dumps(ds))
    assert back.data is None and back.on_fault is None
    assert back._next_file_thread is None and back.file_idx is None
    _assert_items_equal([back[0], back[ROWS + 1]], [first, ds[ROWS + 1]])


def _batches(loader):
    out, indices = [], []
    for batch in loader:
        out.append(batch)
        indices.append(loader.sampler.index)
    return out, indices


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            assert np.array_equal(a[key], b[key]), key


@pytest.mark.parametrize("start", [0, 16], ids=["fresh", "resumed"])
def test_process_workers_match_the_thread_paths(shard_dir, start):
    """num_workers 2 (spawned) against the port's thread path and the JAX
    thread path, from a fresh and a mid-epoch sampler: byte-equal batches
    in order, and the live sampler.index after each delivered batch."""
    files = _files(shard_dir)

    def port_loader(workers):
        ds = port_dataset.ShardedPretrainingDataset(files, **MASKING)
        sampler = DistributedSampler(ds)
        sampler.index = start
        return DataLoader(ds, sampler, batch_size=8, num_workers=workers)

    jds = jax_dataset.ShardedPretrainingDataset(files, **MASKING)
    jsampler = JaxSampler(jds, num_replicas=1, rank=0)
    jsampler.index = start
    want, _ = _batches(JaxLoader(jds, jsampler, batch_size=8))
    threaded, _ = _batches(port_loader(0))
    loader = port_loader(2)
    got, indices = _batches(loader)
    _assert_batches_equal(threaded, want)
    _assert_batches_equal(got, want)
    assert len(got) == (3 * ROWS - start) // 8
    assert indices == [start + 8 * (b + 1) for b in range(len(got))]
    assert loader.sampler.index == 0  # the epoch completed
    assert len(loader.worker_first_batch_s) == 2
    assert all(s > 0 for s in loader.worker_first_batch_s)


def test_a_dead_worker_is_named():
    loader = DataLoader(RowsDataset(32, die_at=12),
                        DistributedSampler(RowsDataset(32)), batch_size=4,
                        num_workers=2)
    with pytest.raises(RuntimeError, match="DataLoader worker 1 died "
                                           r"\(exit code 3\)"):
        _batches(loader)


def test_leaving_an_epoch_stops_the_workers():
    """Two batches of sixteen, then the epoch is left: both workers (each
    blocked on a full queue) are gone within the drain's 5 s, not left to
    a join timeout."""
    import multiprocessing

    loader = DataLoader(RowsDataset(64, seq=4096),
                        DistributedSampler(RowsDataset(64)), batch_size=4,
                        num_workers=2)
    batches = iter(loader)
    next(batches), next(batches)
    time.sleep(1.0)  # the workers fill their queues and block
    t0 = time.perf_counter()
    batches.close()
    assert time.perf_counter() - t0 < 5.0
    assert multiprocessing.active_children() == []


def _stage_rows(host):
    return {k: v * 1 for k, v in host.items()}


def _put_rows(host, put):
    return {k: put(v) for k, v in host.items()}


def test_prefetcher_matches_jax_and_closes_mid_epoch():
    """Depth 2 and 0 against the JAX prefetcher on the same host batches:
    the same items and gauge keys; close() after one item leaves no live
    thread (its own, the loader's producer)."""
    def loader():
        return DataLoader(RowsDataset(40), DistributedSampler(RowsDataset(40)),
                          batch_size=4)

    want = list(JaxPrefetcher(iter(loader()), stage=_stage_rows, depth=2))
    for depth in (2, 0):
        stage = HostToDevice("cpu", _put_rows)
        got = list(DevicePrefetcher(iter(loader()), stage=stage,
                                    depth=depth))
        assert len(got) == len(want) == 10
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for key in a:
                assert a[key].dtype == torch.int64
                assert np.array_equal(a[key].numpy(), b[key])
    before = set(threading.enumerate())
    pp = DevicePrefetcher(iter(loader()),
                          stage=HostToDevice("cpu", _put_rows), depth=2)
    next(pp)
    started = set(threading.enumerate()) - before
    assert len(started) >= 2  # the prefetcher's and the loader's
    pp.close()
    deadline = time.time() + 5.0
    while any(t.is_alive() for t in started) and time.time() < deadline:
        time.sleep(0.05)
    assert not [t for t in started if t.is_alive()]
    with pytest.raises(StopIteration):
        next(pp)
    jp = JaxPrefetcher(iter(loader()), stage=_stage_rows, depth=2)
    pp = DevicePrefetcher(iter(loader()),
                          stage=HostToDevice("cpu", _put_rows), depth=2)
    next(jp), next(pp)
    assert pp.snapshot().keys() == jp.snapshot().keys()
    jp.close()
    pp.close()


def test_host_to_device_stages_dtypes_and_microbatches():
    """int32 on the wire becomes int64, float fp32, bool bool; the
    runner's stage stacks [A*B] into [A, B]."""
    stage = HostToDevice("cpu", _put_rows)
    value = stage.deliver(stage({
        "ids": np.arange(6, dtype=np.int32).reshape(2, 3),
        "labels": np.ones(2, np.float64), "valid": np.ones(2, bool)}))
    assert [value[k].dtype for k in ("ids", "labels", "valid")] == [
        torch.int64, torch.float32, torch.bool]
    prefetcher = pretrain.device_prefetch(
        DataLoader(RowsDataset(16), DistributedSampler(RowsDataset(16)),
                   batch_size=8), accum_steps=2, device="cpu", depth=2)
    batches = list(prefetcher)
    assert len(batches) == 2
    assert batches[0]["input_ids"].shape == (2, 4, 8)
    assert batches[1]["input_ids"][1, 3, 0] == 15
    if not torch.cuda.is_available():
        # No card: no side stream, so no stage (never a quiet CPU one).
        with pytest.raises((RuntimeError, AssertionError)):
            HostToDevice("cuda", _put_rows)


def test_prefetcher_surfaces_errors_and_h2d_share():
    def broken():
        yield {"a": np.zeros(2, np.int32)}
        raise OSError("the loader failed")

    clock = iter(np.arange(0.0, 100.0, 0.5)).__next__
    p = DevicePrefetcher(broken(), stage=HostToDevice("cpu", _put_rows),
                         depth=0, clock=clock)
    next(p)
    assert p.pop_h2d_wait_s() == 0.5 and p.pop_h2d_wait_s() == 0.0
    with pytest.raises(OSError, match="loader failed"):
        next(p)
    with pytest.raises(StopIteration):
        next(p)


def _drive(timer, script):
    """Feed a timer one fake-clock step per (data, h2d, host, device)
    entry; return its window records."""
    windows = []
    now = [0.0]
    timer._clock = lambda: now[0]
    for i, (data, h2d, host, device) in enumerate(script):
        timer.data_start()
        now[0] += data
        timer.data_end()
        if h2d is not None:
            timer.note_h2d(h2d)
        now[0] += host
        timer.dispatch_end()
        if timer.should_sync():
            now[0] += device
            if isinstance(timer, JaxTimer):
                timer.device_sync(None)
            else:
                timer.device_sync()
        w = timer.step_done(i + 1)
        if w:
            windows.append(w)
    last = timer.flush(len(script))
    return windows + ([last] if last else [])


def test_step_timer_h2d_windows_equal_jax(monkeypatch):
    """One fake-clock script (an h2d share above the data wait on one
    step, none noted on another) through both timers: the same window
    records, h2d_wait <= data_wait everywhere, schema-clean."""
    import jax

    monkeypatch.setattr(jax, "block_until_ready", lambda x: x)
    script = [(0.2, 0.1, 0.3, 0.4), (0.05, 0.5, 0.3, 0.4),
              (0.0, None, 0.3, 0.4), (0.3, 0.3, 0.1, 0.2),
              (0.1, 0.02, 0.2, 0.2)]
    want = _drive(JaxTimer(window=2, sync_every=1), script)
    got = _drive(StepTimer(window=2, sync_every=1), script)
    assert got == want and len(got) == 3
    for w in got:
        for suffix in ("p50_s", "p95_s", "max_s"):
            assert w[f"h2d_wait_{suffix}"] <= w[f"data_wait_{suffix}"]
        assert schema.validate_record(w) == []
    bare = _drive(StepTimer(window=5, sync_every=1), [
        (0.1, None, 0.1, 0.1)] * 5)
    assert not any(k.startswith("h2d") for k in bare[0])
