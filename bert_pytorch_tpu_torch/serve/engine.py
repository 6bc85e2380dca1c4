"""Bucketed inference engine for the BERT serving heads: the port of the
JAX package's ``serve/engine.py``.

The :class:`InferenceEngine` owns the device side of serving:

* **weights** — each task head takes a state dict converted from the JAX
  package's params (:func:`~bert_pytorch_tpu_torch.models.convert.
  from_jax_params`) or, without one, seeded random init (demo mode);
* **warmup** — one forward per (task head, length bucket, packedness) at
  startup, so the first request pays no kernel build, library load or
  cuBLAS set-up; ``startup["cold_start_s"]`` records what that took;
* **batch planning** — :meth:`plan_batch` picks the SMALLEST bucket whose
  budget fits the flushed group (and, with packing on, the first-fit-
  decreasing row assignment of ``data/packing.py``), returning requests
  that do not fit for the batcher to requeue;
* **execution + demultiplexing** — three composable steps, so the
  pipelined dispatch plane (serve/service.py) can run them on different
  stages: :meth:`stage` pads/packs the group into the fixed
  (max_batch_size, bucket) shape (host only — the assembler stage),
  :meth:`execute_staged` runs the forward (the ONLY device call — the
  executor stage), and :meth:`demux` slices each request's own output
  back out (host conversion — the completion stage). :meth:`execute`
  composes the three.

Batch shapes are FIXED at (max_batch_size, bucket): a partially full group
pads with all-zero rows (attention mask 0 — rows are independent under the
padding/block-diagonal mask, so a request's result does not depend on what
else rides in its batch).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.data.packing import first_fit_decreasing
from bert_pytorch_tpu_torch.models import bert as models
from bert_pytorch_tpu_torch.serve import tasks as tasks_lib
from bert_pytorch_tpu_torch.serve.batcher import Request
from bert_pytorch_tpu_torch.serve.cli import ATTENTION_BACKENDS, resolve_device


class SwapBusy(RuntimeError):
    """A second hot-swap was requested while one is already in flight
    (serve/http.py maps this to HTTP 409). Hot-swap itself is not ported
    yet; the HTTP layer keeps the mapping."""


class TaskSpec:
    """One served head: its model (weights on the engine's device) and its
    request handler."""

    def __init__(self, name: str, model: torch.nn.Module, handler):
        self.name = name
        self.model = model
        self.handler = handler


class BatchPlan:
    """Output of :meth:`InferenceEngine.plan_batch`."""

    def __init__(self, bucket: int, rows: List[List[Request]],
                 leftover: List[Request], packed: bool):
        self.bucket = bucket
        self.rows = rows          # per dispatched row, its member requests
        self.leftover = leftover  # did not fit; requeue at queue front
        self.packed = packed

    @property
    def requests(self) -> List[Request]:
        return [r for row in self.rows for r in row]


class StagedBatch:
    """A plan staged into its fixed-shape host arrays, ready for the device
    (output of :meth:`InferenceEngine.stage`).

    ``args`` is the positional argument tuple of the head's forward;
    ``offsets`` maps request id -> (row, token offset, pack slot) for
    :meth:`InferenceEngine.demux`; ``pack_s`` is the host seconds spent
    filling the arrays. ``staged_at`` is stamped by the dispatch plane when
    staging completes."""

    def __init__(self, task: str, plan: BatchPlan, args: tuple,
                 offsets: Dict[int, Tuple[int, int, int]], pack_s: float):
        self.task = task
        self.plan = plan
        self.args = args
        self.offsets = offsets
        self.pack_s = pack_s
        self.staged_at: Optional[float] = None


class InferenceEngine:
    def __init__(
        self,
        config: BertConfig,
        tokenizer,
        tasks: Dict[str, dict],
        buckets: Sequence[int] = (64, 128),
        max_batch_size: int = 8,
        max_requests_per_pack: int = 1,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
        clock: Callable[[], float] = time.perf_counter,
        attention_backend: str = "flash_infer",
        device: str = "cuda",
    ):
        """``tasks`` maps task name -> options: ``classify`` reads
        ``labels``; any task may carry ``weights``, a state dict from
        ``from_jax_params`` for that head (absent = seeded random init from
        ``seed`` + the task's index). ``attention_backend`` routes the
        encoder's attention (ops/attention.py): ``"flash_infer"`` is the
        forward-only CUDA kernel (its plain version on the CPU),
        ``"dense"`` the plain tensor path. ``device`` defaults to ``cuda``
        and raises where there is none."""
        if attention_backend not in ATTENTION_BACKENDS:
            raise ValueError(f"attention_backend must be one of "
                             f"{ATTENTION_BACKENDS}, got {attention_backend!r}")
        self.device = resolve_device(device)
        self.attention_backend = attention_backend
        self.config = config
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 8:
            raise ValueError(f"buckets must be >= 8, got {buckets}")
        if max(self.buckets) > config.max_position_embeddings:
            raise ValueError(
                f"largest bucket {max(self.buckets)} exceeds "
                f"max_position_embeddings {config.max_position_embeddings}")
        self.max_batch_size = int(max_batch_size)
        self.max_requests_per_pack = max(1, int(max_requests_per_pack))
        self.pack = self.max_requests_per_pack > 1
        self.dtype = dtype
        self._clock = clock
        self.startup: Optional[dict] = None
        # Forwards run so far (warmup included). Written only by the one
        # device-calling thread; read by the chip smoke to tie kernel
        # launches to forwards.
        self.forwards = 0
        handlers = tasks_lib.build_handlers(tokenizer, tasks)
        self.tasks: Dict[str, TaskSpec] = {}
        for name, options in tasks.items():
            options = options or {}
            model = self._build_task(name, options, seed=seed + len(self.tasks))
            self.tasks[name] = TaskSpec(name, model, handlers[name])
        self.warmed = False

    # -- construction ----------------------------------------------------

    def _build_task(self, name: str, options: dict,
                    seed: int) -> torch.nn.Module:
        cfg = self.config
        kwargs = dict(dtype=self.dtype,
                      attention_backend=self.attention_backend,
                      device=self.device)
        if name == "fill_mask":
            model = models.BertForMaskedLM(cfg, **kwargs)
        elif name == "classify":
            labels = options.get("labels") or ["0", "1"]
            model = models.BertForSequenceClassification(
                cfg, num_labels=len(labels), **kwargs)
        else:
            raise ValueError(f"unknown serve task {name!r}")
        weights = options.get("weights")
        if weights is not None:
            model.load_state_dict(weights, strict=True)
        else:
            generator = torch.Generator(device=self.device).manual_seed(seed)
            models.init_weights(model, cfg.initializer_range, generator)
        return model.eval()

    def warmup(self) -> int:
        """Run every (task, bucket[, packed]) forward the serving loop can
        dispatch once, on all-zero inputs; returns the number of forwards.
        Records :attr:`startup` (``cold_start_s`` covers the kernel build
        and load at the first fused-attention launch)."""
        t0 = self._clock()
        count = 0
        B, K = self.max_batch_size, self.max_requests_per_pack
        for spec in self.tasks.values():
            pooled = spec.handler.output_kind == "pooled"
            for bucket in self.buckets:
                zeros = np.zeros((B, bucket), np.int32)
                for packed in ((False, True) if self.pack else (False,)):
                    if not packed:
                        args = (zeros,) * 3
                    elif pooled:
                        args = (zeros,) * 4 + (np.zeros((B, K), np.int32),)
                    else:
                        args = (zeros,) * 4
                    self._run(spec, args)
                    count += 1
        self.startup = {
            "cold_start_s": round(self._clock() - t0, 3),
            "warmup_forwards": count,
            "attention_backend": self.attention_backend,
            "device": str(self.device),
            "dtype": str(self.dtype).replace("torch.", ""),
            "weight_bytes": sum(
                p.numel() * p.element_size()
                for s in self.tasks.values() for p in s.model.parameters()),
        }
        self.warmed = True
        return count

    # -- planning --------------------------------------------------------

    def select_bucket(self, length: int) -> int:
        """Smallest bucket that fits ``length``; the largest bucket for
        over-long requests (prepare() already truncated to it)."""
        for bucket in self.buckets:
            if length <= bucket:
                return bucket
        return self.buckets[-1]

    def max_len(self) -> int:
        return self.buckets[-1]

    def plan_batch(self, requests: List[Request],
                   packed: Optional[bool] = None) -> BatchPlan:
        """Assign a flushed request group to rows of the smallest workable
        bucket. Unpacked: one request per row, first ``max_batch_size``
        requests, bucket = smallest fitting the longest. Packed: the bucket
        whose FFD packing minimizes the total dispatched token budget
        (ties -> the smaller bucket); requests falling outside the first
        ``max_batch_size`` rows are leftover for the batcher to requeue."""
        if packed is None:
            packed = self.pack
        if not requests:
            raise ValueError("plan_batch needs at least one request")
        if not packed:
            take = requests[: self.max_batch_size]
            leftover = requests[self.max_batch_size:]
            bucket = self.select_bucket(max(r.length for r in take))
            return BatchPlan(bucket, [[r] for r in take], leftover, False)

        lengths = [r.length for r in requests]
        # Every dispatch costs a FULL (max_batch_size x bucket) budget
        # regardless of fill, so the right bucket minimizes the total
        # dispatched budget INCLUDING the extra dispatches a smaller
        # bucket forces.
        chosen_bucket, chosen_packs, best_budget = None, None, None
        for bucket in self.buckets:
            if max(lengths) > bucket:
                continue
            packs = first_fit_decreasing(
                lengths, bucket, self.max_requests_per_pack)
            dispatches = -(-len(packs) // self.max_batch_size)
            budget = dispatches * self.max_batch_size * bucket
            if best_budget is None or budget < best_budget:
                chosen_bucket, chosen_packs, best_budget = (
                    bucket, packs, budget)
        if chosen_packs is None:  # nothing fits: largest bucket, truncate
            chosen_bucket = self.buckets[-1]
            chosen_packs = first_fit_decreasing(
                lengths, chosen_bucket, self.max_requests_per_pack)
        rows = [[requests[i] for i in pack]
                for pack in chosen_packs[: self.max_batch_size]]
        leftover_idx = sorted(
            i for pack in chosen_packs[self.max_batch_size:] for i in pack)
        return BatchPlan(chosen_bucket, rows,
                         [requests[i] for i in leftover_idx], True)

    # -- execution -------------------------------------------------------

    def stage(self, task: str, plan: BatchPlan) -> StagedBatch:
        """Pack/pad one planned batch into its fixed-shape host arrays.
        HOST-ONLY — never touches the device, so the assembler stage runs
        it concurrently with the executor's forward."""
        spec = self.tasks[task]
        t_host0 = self._clock()
        B, S = self.max_batch_size, plan.bucket
        ids = np.zeros((B, S), np.int32)
        seg = np.zeros((B, S), np.int32)
        mask = np.zeros((B, S), np.int32)
        offsets: Dict[int, Tuple[int, int, int]] = {}  # id -> (row, off, slot)
        if plan.packed:
            K = self.max_requests_per_pack
            sids = np.zeros((B, S), np.int32)
            cpos = np.zeros((B, K), np.int32)
            for r, row in enumerate(plan.rows):
                offset = 0
                for k, req in enumerate(row):
                    n = req.length
                    ids[r, offset:offset + n] = req.features["input_ids"]
                    seg[r, offset:offset + n] = req.features["segment_ids"]
                    mask[r, offset:offset + n] = 1
                    sids[r, offset:offset + n] = k + 1
                    cpos[r, k] = offset
                    offsets[req.id] = (r, offset, k)
                    offset += n
            if spec.handler.output_kind == "pooled":
                args = (ids, seg, mask, sids, cpos)
            else:
                args = (ids, seg, mask, sids)
        else:
            for r, row in enumerate(plan.rows):
                (req,) = row
                n = req.length
                ids[r, :n] = req.features["input_ids"]
                seg[r, :n] = req.features["segment_ids"]
                mask[r, :n] = 1
                offsets[req.id] = (r, 0, 0)
            args = (ids, seg, mask)
        return StagedBatch(task, plan, args, offsets,
                           pack_s=self._clock() - t_host0)

    def _run(self, spec: TaskSpec, args: tuple) -> torch.Tensor:
        """One forward on host arrays (ids, segments, mask[, sequence ids
        [, cls positions]]), synchronized with the device."""
        with torch.inference_mode():
            tensors = [torch.from_numpy(a).to(self.device) for a in args]
            out = spec.model(*tensors)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.forwards += 1
        return out

    def execute_staged(self, staged: StagedBatch
                       ) -> Tuple[torch.Tensor, dict]:
        """Run one staged batch's forward (incl. the device sync); returns
        (device output, info dict). The ONLY method on the serving path
        that touches the device — in pipelined dispatch, only the executor
        stage calls it."""
        spec = self.tasks[staged.task]
        plan = staged.plan
        t0 = self._clock()
        out = self._run(spec, staged.args)
        info = {
            "bucket": plan.bucket,
            "rows": self.max_batch_size,
            "real_tokens": sum(r.length for r in plan.requests),
            "device_s": self._clock() - t0,
            "pack_s": staged.pack_s,
            "compiles": 0,
            "packed": plan.packed,
        }
        return out, info

    def demux(self, staged: StagedBatch, out: torch.Tensor) -> List[object]:
        """Slice each request's own output back out of the batch output
        (host conversion + per-request views, in ``plan.requests`` order).
        The completion stage runs it, so client decode never blocks the
        next device step."""
        spec = self.tasks[staged.task]
        plan = staged.plan
        host = out.to("cpu").float().numpy()
        pooled = spec.handler.output_kind == "pooled"
        results: List[object] = []
        for req in plan.requests:
            r, off, slot = staged.offsets[req.id]
            if pooled:
                results.append(host[r, slot] if plan.packed else host[r])
            else:
                results.append(host[r, off:off + req.length])
        return results

    def execute(self, task: str, plan: BatchPlan
                ) -> Tuple[List[object], dict]:
        """Run one planned batch end to end (stage -> execute_staged ->
        demux on the calling thread); returns (per-request output slices in
        ``plan.requests`` order, info dict)."""
        staged = self.stage(task, plan)
        out, info = self.execute_staged(staged)
        return self.demux(staged, out), info

    def run_direct(self, task: str, payload: dict) -> dict:
        """One request end to end through the SAME batched path (a batch of
        one) — the offline-scoring and parity-test entry point."""
        spec = self.tasks[task]
        features = spec.handler.prepare(payload, self.max_len())
        req = Request(task, features, payload)
        plan = self.plan_batch([req], packed=False)
        outputs, _ = self.execute(task, plan)
        return spec.handler.postprocess(features, outputs[0], payload)
