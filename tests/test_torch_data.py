"""The port's pretraining data path (dataset, on-the-fly packing, sampler,
loader, synthetic batches) held against the JAX package's on the CPU.

Shards are written with the JAX package's own synthetic-data tool; the
port must yield the JAX dataset's samples exactly (the same dynamic
masking from the same per-sample seeds), unpacked, offline-packed and
packed on the fly.
"""

import numpy as np
import pytest

from bert_pytorch_tpu.data.dataset import (
    ShardedPretrainingDataset as JaxDataset)
from bert_pytorch_tpu.data.loader import DataLoader as JaxLoader
from bert_pytorch_tpu.data.packing import (
    PackedPretrainingDataset as JaxPacked)
from bert_pytorch_tpu.data.sampler import DistributedSampler as JaxSampler
from bert_pytorch_tpu.tools.make_synthetic_data import make_shard
from bert_pytorch_tpu_torch.data import dataset, loader, packing, sampler
from bert_pytorch_tpu_torch.tools.make_synthetic_data import (
    synthetic_pretraining_batch, synthetic_samples)

VOCAB, SEQ = 300, 48
DATASET_ARGS = (4, 8, 0.15, VOCAB)  # mask id, max pred, prob, vocab


@pytest.fixture(scope="module")
def shard_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_data")
    out = {}
    for kind, kw in (("unpacked", {}), ("legacy", {"legacy": True}),
                     ("packed", {"packed": True, "mixed_lengths": True,
                                 "max_sequences_per_pack": 4}),
                     ("mixed", {"mixed_lengths": True})):
        d = root / kind
        d.mkdir()
        for s in range(2):
            make_shard(str(d / f"shard_{s}.hdf5"), 20, SEQ, VOCAB, seed=s,
                       **kw)
        out[kind] = sorted(str(p) for p in d.glob("*.hdf5"))
    return out


def _samples(ds, n=None):
    return [ds[i] for i in range(len(ds) if n is None else n)]


def _assert_same(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", ["unpacked", "legacy", "packed"])
def test_dataset_matches_jax_exactly(shard_dirs, kind):
    files = shard_dirs[kind]
    ours = dataset.ShardedPretrainingDataset(files, *DATASET_ARGS, seed=3)
    ref = JaxDataset(files, *DATASET_ARGS, seed=3)
    assert len(ours) == len(ref) and ours.packed == ref.packed
    _assert_same(_samples(ours), _samples(ref))
    # Epochs re-draw the masks, identically on both sides.
    ours.set_epoch(1)
    ref.set_epoch(1)
    _assert_same(_samples(ours, 6), _samples(ref, 6))


def test_on_the_fly_packing_matches_jax(shard_dirs):
    files = shard_dirs["mixed"]
    ours = packing.PackedPretrainingDataset(
        dataset.ShardedPretrainingDataset(files, *DATASET_ARGS, seed=5), 4)
    ref = JaxPacked(JaxDataset(files, *DATASET_ARGS, seed=5), 4)
    assert ours.packs == ref.packs and len(ours) < ours.n_samples
    assert ours.occupancy == pytest.approx(ref.occupancy)
    _assert_same(_samples(ours), _samples(ref))


@pytest.mark.parametrize("kind", ["unpacked", "packed"])
def test_loader_batches_match_jax(shard_dirs, kind):
    files = shard_dirs[kind]
    ours_ds = dataset.ShardedPretrainingDataset(files, *DATASET_ARGS, seed=1)
    ref_ds = JaxDataset(files, *DATASET_ARGS, seed=1)
    ours = list(loader.DataLoader(ours_ds, sampler.DistributedSampler(ours_ds),
                                  batch_size=4))
    ref = list(JaxLoader(ref_ds, JaxSampler(ref_ds, 1, 0), batch_size=4))
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("drop_last", [False, True])
def test_sampler_chunks_like_jax(shard_dirs, drop_last):
    ds = dataset.ShardedPretrainingDataset(shard_dirs["unpacked"],
                                           *DATASET_ARGS, seed=0)
    for rank in range(3):
        ours = sampler.DistributedSampler(ds, 3, rank, drop_last=drop_last)
        ref = JaxSampler(ds, 3, rank, drop_last=drop_last)
        assert list(ours) == list(ref)
        assert list(ours) == list(ref)  # an epoch restarts the chunk


def test_dataset_rejects_what_it_cannot_read(shard_dirs, tmp_path):
    bad = tmp_path / "broken.hdf5"
    bad.write_bytes(b"not an hdf5 file")
    with pytest.warns(UserWarning, match="Skipping"):
        ds = dataset.ShardedPretrainingDataset(
            shard_dirs["unpacked"] + [str(bad)], *DATASET_ARGS, seed=0)
    assert len(ds) == 40
    with pytest.warns(UserWarning, match="Skipping"), pytest.raises(
            RuntimeError, match="Unable to open any valid data files"):
        dataset.ShardedPretrainingDataset([str(bad)], *DATASET_ARGS)
    with pytest.raises(ValueError, match="mix"):
        dataset.ShardedPretrainingDataset(
            shard_dirs["unpacked"] + shard_dirs["packed"], *DATASET_ARGS)
    assert dataset.input_files(str(tmp_path)) == [str(bad)]


def test_synthetic_batch_is_masked_like_the_dataset():
    batch = synthetic_pretraining_batch(0, 6, 64, 1000, max_pred_per_seq=10)
    ids, specials, _ = synthetic_samples(np.random.default_rng(0), 6, 64,
                                         1000)
    labels = batch["masked_lm_labels"]
    for row, special in enumerate(specials):
        n = special[-1] + 1
        assert batch["input_mask"][row].sum() == n
        masked = labels[row] != -1
        assert 1 <= masked.sum() <= 10
        assert not masked[special].any() and not masked[n:].any()
        # Labels are the original ids; unmasked positions keep theirs.
        np.testing.assert_array_equal(labels[row][masked], ids[row][masked])
        np.testing.assert_array_equal(batch["input_ids"][row][~masked],
                                      ids[row][~masked])
    assert batch["next_sentence_labels"].shape == (6,)
    again = synthetic_pretraining_batch(0, 6, 64, 1000, max_pred_per_seq=10)
    for key in batch:
        np.testing.assert_array_equal(batch[key], again[key])
