"""Bucketed inference engine for the BERT serving heads: the port of the
JAX package's ``serve/engine.py``.

The :class:`InferenceEngine` owns the device side of serving:

* **weights** — each task head (``fill_mask``, ``classify``, ``squad``,
  ``ner``) loads a JAX package checkpoint params-only
  (:func:`~bert_pytorch_tpu_torch.utils.checkpoint.load_params_only`:
  only the ``model`` subtree decodes, module by module, quantized as it
  arrives), or takes a state dict converted from the JAX params in memory
  (:func:`~bert_pytorch_tpu_torch.models.convert.from_jax_params`), or,
  with neither, seeded random init (demo mode); ``quantize``
  (``"bf16"``/``"int8"``, ops/quant.py) selects the serving storage;
* **hot-swap** — :meth:`swap_params` loads one head's new checkpoint off
  the dispatch path and flips (model, version, epoch) in one lock
  acquisition; :meth:`execute_staged` takes the three in one acquisition
  too, so a batch runs on exactly one version, and counts torn serves;
* **fused epilogues** — with ``fuse_epilogues``, fill_mask gathers its
  [MASK] rows before the vocab projection ([B, epilogue_slots, V] out
  instead of [B, S, V]; a batch whose rows need more slots runs the
  unfused forward), and squad stacks its start and end logits into one
  [B, 2, S] output (``stack_span``: one transfer to the host);
* **measured attention geometry** — with ``autotune`` ``"load"`` or
  ``"measure"``, the tile geometry of kernel #4 or #5 per (bucket,
  max_batch_size * heads) comes from a winners file
  (ops/kernels/autotune.py), measured at start-up where it has none;
  one ``kind="autotune"`` record per bucket says where each came from,
  and the per-bucket forward names (:meth:`forward_name`, listed in
  ``startup["forwards"]``) carry the winner's digest, as the JAX engine's
  do;
* **warmup** — one forward per (task head, length bucket, packedness) at
  startup, so the first request pays no kernel build, library load or
  cuBLAS set-up; ``startup["cold_start_s"]`` records what that took, and
  ``compiles_cold``/``compiles_warm`` the kernel libraries it built with
  ``nvcc`` and found built (the ``compile`` records of its
  :class:`~bert_pytorch_tpu_torch.telemetry.compile_events.CompileMonitor`),
  so a restart on a built tree shows ``compiles_cold == 0``;
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

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.data.packing import first_fit_decreasing
from bert_pytorch_tpu_torch.models import bert as models
from bert_pytorch_tpu_torch.models.convert import quantize_state_dict
from bert_pytorch_tpu_torch.ops import quant as quant_ops
from bert_pytorch_tpu_torch.ops.kernels import autotune as tune
from bert_pytorch_tpu_torch.serve import tasks as tasks_lib
from bert_pytorch_tpu_torch.serve.batcher import Request
from bert_pytorch_tpu_torch.serve.cli import (ATTENTION_BACKENDS,
                                              AUTOTUNE_MODES, resolve_device)
from bert_pytorch_tpu_torch.telemetry.compile_events import CompileMonitor
from bert_pytorch_tpu_torch.testing import faults
from bert_pytorch_tpu_torch.utils import checkpoint as ckpt_util


class SwapBusy(RuntimeError):
    """A second hot-swap was requested while one is already in flight
    (loads cannot overlap; serve/http.py maps this to HTTP 409)."""


class SwapUnsupported(RuntimeError):
    """Hot-swap was requested of an engine that has no ``swap_params``,
    such as a test's stand-in engine (serve/http.py maps this to HTTP 404,
    as /profilez answers without a capture controller)."""


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
    staging completes.

    ``fused`` selects the head's fused-epilogue forward: for a
    ``"gather"`` head, ``positions`` ([B, epilogue_slots] row positions)
    are gathered before the vocab projection and ``gather_slots`` maps
    request id -> (row, first slot, slot count) into its
    [B, epilogue_slots, V] output; a ``"stack_span"`` head returns one
    [B, 2, S] output."""

    def __init__(self, task: str, plan: BatchPlan, args: tuple,
                 offsets: Dict[int, Tuple[int, int, int]], pack_s: float,
                 fused: bool = False,
                 positions: Optional[np.ndarray] = None,
                 gather_slots: Optional[Dict[int, Tuple[int, int, int]]]
                 = None):
        self.task = task
        self.plan = plan
        self.args = args
        self.offsets = offsets
        self.pack_s = pack_s
        self.fused = fused
        self.positions = positions
        self.gather_slots = gather_slots or {}
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
        quantize: Optional[str] = None,
        fuse_epilogues: bool = False,
        epilogue_slots: int = 8,
        version: str = "v0",
        monitor: Optional[CompileMonitor] = None,
        autotune: str = "off",
        autotune_cache: Optional[str] = None,
    ):
        """``tasks`` maps task name -> options: ``classify`` and ``ner``
        read ``labels``, ``squad`` ``do_lower_case`` and
        ``max_query_length``; any task may carry ``checkpoint``, the path
        of a JAX package checkpoint whose ``model`` subtree is that head's
        params, or ``weights``, a state dict from ``from_jax_params``
        (with neither: seeded random init from ``seed`` + the task's
        index). ``version`` names the weights served, until
        :meth:`swap_params` changes it. ``attention_backend`` routes the
        encoder's attention (ops/attention.py): ``"flash_infer"`` is the
        forward-only CUDA kernel (its plain version on the CPU),
        ``"flash_infer_int8"`` its int8-score twin, ``"dense"`` the plain
        tensor path. ``device`` defaults to ``cuda`` and raises where there
        is none.

        ``quantize`` (None/``"none"``, ``"bf16"``, ``"int8"``) selects the
        weight storage (ops/quant.py): int8 runs int8 GEMMs with per-token
        activation scales. ``fuse_epilogues`` gathers fill_mask's [MASK]
        rows before the vocab projection and stacks squad's start and end
        logits; ``epilogue_slots`` is the per-row gather quota, past which
        a batch runs the unfused forward. ``monitor`` receives the kernel
        builds of the warmup as ``compile`` records (a silent one of its
        own when none is given).

        ``autotune`` drives the measured tile geometry of the serving
        kernels (ops/kernels/autotune.py) for the ``flash_infer*``
        backends: ``"load"`` reads the winners in ``autotune_cache``, a
        JSON file (kept beside the kernel build directory), ``"measure"``
        also times the candidates of every (bucket, max_batch_size *
        heads) shape without one and writes the file back. It runs here,
        before any forward, as the JAX engine's does; the registry is
        process-global, so the winners apply to every engine of the
        process that serves those shapes."""
        if attention_backend not in ATTENTION_BACKENDS:
            raise ValueError(f"attention_backend must be one of "
                             f"{ATTENTION_BACKENDS}, got {attention_backend!r}")
        if autotune not in AUTOTUNE_MODES:
            raise ValueError(
                f"autotune must be off|load|measure, got {autotune!r}")
        if autotune != "off" and not autotune_cache:
            # A forgotten cache would quietly serve the default geometry
            # and measure again at every restart: fail at construction.
            raise ValueError(
                f"autotune={autotune!r} requires autotune_cache (the "
                "winners JSON path beside the kernel build directory)")
        if autotune != "off" and attention_backend not in (
                "flash_infer", "flash_infer_int8"):
            # Only the serving kernels have a geometry to tune: silently
            # doing nothing under dense would let an operator believe the
            # measured geometry is in use.
            raise ValueError(
                f"autotune={autotune!r} tunes the serving attention "
                f"kernels; attention_backend={attention_backend!r} has "
                "no geometry to tune (use flash_infer or flash_infer_int8)")
        self.autotune = autotune
        self.autotune_cache = autotune_cache
        self.quantize = quant_ops.check_mode(
            None if quantize in (None, "none") else quantize)
        self.fuse_epilogues = bool(fuse_epilogues)
        self.epilogue_slots = int(epilogue_slots)
        if self.fuse_epilogues and self.epilogue_slots < 1:
            raise ValueError(
                f"epilogue_slots must be >= 1, got {epilogue_slots}")
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
        self.monitor = monitor or CompileMonitor()
        # compile records of libraries the autotune measurement built (the
        # warmup counts them as start-up's); its records, one per bucket.
        self._autotune_compiles: List[dict] = []
        self.autotune_records: List[dict] = []
        # The kernels' launch counts when the forwards began: a
        # measurement's launches at start-up are not the forwards'.
        self._launch_base: Dict[str, int] = {}
        self._setup_autotune()
        # Forwards run so far (warmup included). Written only by the one
        # device-calling thread; read by the chip smoke to tie kernel
        # launches to forwards.
        self.forwards = 0
        # Hot-swap state: _swap_lock makes (spec.model, serving_version,
        # _swap_epoch) flip as one unit; execute_staged reads all three in
        # one acquisition, and a model that changed without the epoch
        # changing counts as a torn serve.
        self._swap_lock = threading.Lock()
        self.serving_version = str(version)
        self._swap_epoch = 0
        self._swaps = 0
        self._torn_serves = 0
        self._swap_inflight = False
        handlers = tasks_lib.build_handlers(tokenizer, tasks)
        self.tasks: Dict[str, TaskSpec] = {}
        # Per task, the (options, seed) it was built from: swap_params
        # builds the same head for the incoming checkpoint.
        self._task_build: Dict[str, Tuple[dict, int]] = {}
        # Seconds each head took to build and load its weights.
        self.load_s: Dict[str, float] = {}
        for name, options in tasks.items():
            options = options or {}
            task_seed = seed + len(self.tasks)
            t0 = self._clock()
            model = self._build_task(name, options, seed=task_seed)
            self.load_s[name] = self._clock() - t0
            self.tasks[name] = TaskSpec(name, model, handlers[name])
            self._task_build[name] = (
                {k: v for k, v in options.items() if k != "weights"},
                task_seed)
        self.warmed = False

    # -- construction ----------------------------------------------------

    def _autotune_kernel(self) -> Optional[str]:
        """The autotune registry's name of the kernel this engine's
        attention runs, or None for a backend without a geometry."""
        return {"flash_infer": "infer",
                "flash_infer_int8": "infer_int8"}.get(self.attention_backend)

    def _autotune_bh(self) -> int:
        """B*H of every serving forward: batches are padded to
        max_batch_size rows."""
        return self.max_batch_size * self.config.num_attention_heads

    def _setup_autotune(self) -> None:
        """Load (and in ``"measure"`` mode, fill) the geometry winners
        before any forward: one ``kind="autotune"`` record per bucket says
        where its geometry came from — ``measured`` now, ``cached`` from
        the file, or ``heuristic``, the kernels' default (64, 64, 1). A
        bucket with no candidate but the default (a length 64 does not
        divide, or a head dim with the default tile only) is not measured.
        On the card, measuring builds the kernel library first, with the
        monitor installed: warmup then counts that build as start-up's."""
        if self.autotune == "off":
            return
        from bert_pytorch_tpu_torch.ops.kernels import build

        kernel = self._autotune_kernel()
        tune.load_winners(self.autotune_cache, self.device)
        bh = self._autotune_bh()
        depth = self.config.hidden_size // self.config.num_attention_heads
        measured = 0
        for bucket in self.buckets:
            geom = tune.lookup(kernel, bucket, bh)
            record = {"kind": "autotune", "tag": "telemetry",
                      "kernel": kernel, "seq": bucket, "bh": bh}
            grid = tune.candidates(bucket, bh, depth, kernel)
            if geom is not None:
                record["source"] = "cached"
                record["winner"] = {"block_q": geom[0], "block_k": geom[1],
                                    "bh_block": geom[2]}
            elif self.autotune == "measure" and len(grid) > 1:
                if self.device.type == "cuda" and not self._autotune_compiles:
                    before = len(self.monitor.events)
                    with self.monitor.installed():
                        build.ensure(self.kernel_libraries())
                    self._autotune_compiles = self.monitor.events[before:]
                t0 = self._clock()
                result = tune.measure(
                    kernel, bucket, bh, depth,
                    heads=self.config.num_attention_heads, dtype=self.dtype,
                    device=self.device)
                measured += 1
                record.update(source="measured", winner=result["winner"],
                              candidates=result["candidates"],
                              failed=result["failed"],
                              launches_per_round=result["launches"],
                              measured_ms=result["measured_ms"],
                              spread_ms=result["spread_ms"],
                              measure_s=round(self._clock() - t0, 3))
            else:
                record["source"] = "heuristic"
            record["digest"] = tune.name_digest(kernel, bucket, bh)
            self.autotune_records.append(record)
            self.monitor.note(record)
        if measured:
            tune.save_winners(self.autotune_cache, self.device)
            from bert_pytorch_tpu_torch.ops.kernels import attention

            self._launch_base = {
                name: getattr(attention, name).launches
                for name in self.kernel_libraries()}

    def forward_name(self, task: str, bucket: int, packed: bool = False,
                     fused: bool = False) -> str:
        """The per-bucket forward's name, the JAX engine's
        ``serve_<task>_b<bucket>[_packed][_fused]_<quant>``, plus
        ``_g<digest>`` of the autotune winner that forward runs (none at
        the default geometry), so a name says which geometry ran."""
        name = (f"serve_{task}_b{bucket}{'_packed' if packed else ''}"
                f"{'_fused' if fused else ''}_{self.quantize or 'fp32'}")
        kernel = self._autotune_kernel()
        if kernel is None:
            return name
        digest = tune.name_digest(kernel, bucket, self._autotune_bh())
        return f"{name}_g{digest}" if digest else name

    def _build_task(self, name: str, options: dict,
                    seed: int) -> torch.nn.Module:
        cfg = self.config

        def build(quant, device=self.device):
            kwargs = dict(dtype=self.dtype,
                          attention_backend=self.attention_backend,
                          device=device, quant=quant)
            if name == "fill_mask":
                return models.BertForMaskedLM(cfg, **kwargs)
            if name == "classify":
                labels = options.get("labels") or ["0", "1"]
                return models.BertForSequenceClassification(
                    cfg, num_labels=len(labels), **kwargs)
            if name == "squad":
                return models.BertForQuestionAnswering(cfg, **kwargs)
            if name == "ner":
                labels = options.get("labels") or ["O"]
                # +1: label ids start at 1, id 0 is reserved.
                return models.BertForTokenClassification(
                    cfg, num_labels=len(labels) + 1, **kwargs)
            raise ValueError(f"unknown serve task {name!r}")

        checkpoint = options.get("checkpoint")
        if checkpoint:
            # The fp32 layout (shapes only, on the meta device) is the
            # load target; each module is cast or quantized as its bytes
            # decode and moves to the device at once.
            target = build(None, "meta").state_dict()
            state = ckpt_util.load_params_only(
                checkpoint, target, quantize=self.quantize,
                device=self.device)
            model = build(self.quantize)
            model.load_state_dict(state, strict=True)
            return model.eval()
        weights = options.get("weights")
        if weights is not None and any(
                t.dtype != torch.float32 for t in weights.values()):
            # Already quantized (from_jax_params of a quantize_params tree).
            model = build(self.quantize)
            model.load_state_dict(weights, strict=True)
            return model.eval()
        # The fp32 model is always built first: it takes the given (or the
        # seeded demo) weights, which quantize after loading.
        model = build(None)
        if weights is not None:
            model.load_state_dict(weights, strict=True)
        else:
            generator = torch.Generator(device=self.device).manual_seed(seed)
            models.init_weights(model, cfg.initializer_range, generator)
        if self.quantize:
            state = quantize_state_dict(model.state_dict(), self.quantize)
            del model
            model = build(self.quantize)
            model.load_state_dict(state, strict=True)
        return model.eval()

    def kernel_libraries(self) -> Tuple[str, ...]:
        """The CUDA kernel libraries this engine's forwards launch (none
        on the CPU, where the kernels' plain versions run)."""
        if self.device.type != "cuda":
            return ()
        return {"flash_infer": ("flash_attention_infer",),
                "flash_infer_int8": ("flash_attention_infer_int8",)}.get(
                    self.attention_backend, ())

    def kernel_launches(self) -> Dict[str, int]:
        """Launches of each CUDA kernel this engine's forwards run (the
        wrappers' counts, named as :meth:`kernel_libraries`; a fresh
        process starts them at 0, so a replica's ``/statsz`` reads the
        launches of its own forwards: an autotune measurement's launches,
        made before them, are left out)."""
        from bert_pytorch_tpu_torch.ops.kernels import attention

        return {name: getattr(attention, name).launches
                - self._launch_base.get(name, 0)
                for name in self.kernel_libraries()}

    def cuda_memory(self) -> Optional[Dict[str, int]]:
        """The caching allocator's reserved bytes on the card, now and at
        their peak (None on the CPU): a replica's own card memory, which
        ``nvidia-smi`` cannot always tell apart per process."""
        if self.device.type != "cuda":
            return None
        return {"reserved_bytes": torch.cuda.memory_reserved(self.device),
                "max_reserved_bytes":
                    torch.cuda.max_memory_reserved(self.device)}

    def warmup(self) -> int:
        """Run every (task, bucket[, packed]) forward the serving loop can
        dispatch once, on all-zero inputs; returns the number of forwards.
        Records :attr:`startup`: ``cold_start_s`` covers the kernel
        libraries' build and load, which come first, with the monitor
        installed while they load; the ``compile`` records it gets there
        — one per library, a ``miss`` where ``nvcc`` ran, a ``hit`` where
        it was built already — are start-up's ``compiles_cold`` and
        ``compiles_warm`` (the JAX engine's split). A build outside the
        warmup is never counted as start-up's."""
        from bert_pytorch_tpu_torch.ops.kernels import build

        t0 = self._clock()
        count = 0
        if self._autotune_compiles:
            # The autotune measurement built and loaded them.
            compiles = list(self._autotune_compiles)
        else:
            before = len(self.monitor.events)
            with self.monitor.installed():
                build.ensure(self.kernel_libraries())
            compiles = [e for e in self.monitor.events[before:]
                        if e.get("kind") == "compile"]
        forwards = []
        B, K = self.max_batch_size, self.max_requests_per_pack
        slots = np.zeros((B, self.epilogue_slots), np.int32)
        for spec in self.tasks.values():
            pooled = spec.handler.output_kind == "pooled"
            epilogue = self._epilogue(spec)
            # A gather head runs both forwards (the unfused one past the
            # slot quota); a stack_span head only its fused one.
            fused = {"gather": (False, True), "stack_span": (True,)}.get(
                epilogue, (False,))
            for bucket in self.buckets:
                zeros = np.zeros((B, bucket), np.int32)
                for packed in ((False, True) if self.pack else (False,)):
                    if not packed:
                        args = (zeros,) * 3
                    elif pooled:
                        args = (zeros,) * 4 + (np.zeros((B, K), np.int32),)
                    else:
                        args = (zeros,) * 4
                    for is_fused in fused:
                        self._run(spec.model, args,
                                  slots if is_fused and epilogue == "gather"
                                  else None,
                                  stack=is_fused and epilogue == "stack_span")
                        forwards.append(self.forward_name(
                            spec.name, bucket, packed, is_fused))
                        count += 1
        by_task = {name: quant_ops.weight_bytes(spec.model)
                   for name, spec in self.tasks.items()}
        self.startup = {
            "cold_start_s": round(self._clock() - t0, 3),
            "compiles": len(compiles),
            "compiles_cold": sum(e["cache"] == "miss" for e in compiles),
            "compiles_warm": sum(e["cache"] == "hit" for e in compiles),
            "warmup_forwards": count,
            "attention_backend": self.attention_backend,
            "device": str(self.device),
            "dtype": str(self.dtype).replace("torch.", ""),
            "quantize": self.quantize or "none",
            "fuse_epilogues": self.fuse_epilogues,
            "autotune": self.autotune,
            "forwards": forwards,
            "weight_bytes": sum(by_task.values()),
            "weight_bytes_by_task": by_task,
            "load_s_by_task": {k: round(v, 3) for k, v in self.load_s.items()},
        }
        self.warmed = True
        return count

    def _epilogue(self, spec: TaskSpec) -> Optional[str]:
        """The fused epilogue ``spec``'s forward takes (None unfused)."""
        return spec.handler.epilogue if self.fuse_epilogues else None

    # -- hot swap --------------------------------------------------------

    def version(self) -> str:
        """The serving model version (flipped with the model; what
        /healthz, /statsz and /metricsz report)."""
        with self._swap_lock:
            return self.serving_version

    def swap_stats(self) -> dict:
        """Swap counters for /statsz: the serving version, completed swaps,
        and torn serves (forwards whose model changed without the
        epoch-bumping flip; 0 by construction)."""
        with self._swap_lock:
            return {"version": self.serving_version,
                    "swaps": self._swaps,
                    "torn_serves": self._torn_serves}

    def swap_params(self, task: str, checkpoint: str, version: str,
                    emit: Optional[Callable[[dict], None]] = None) -> dict:
        """Hot-swap one task's weights to ``checkpoint``, stamping the
        engine as serving ``version``. Raises ``ValueError`` for an unknown
        task, ``FileNotFoundError`` for a missing file and
        :class:`SwapBusy` when a swap is already in flight (serve/http.py
        maps them to 404, 400 and 409).

        The new head loads off the dispatch path, built from the task's
        original options and seed with the same quantization as startup
        (streamed, module by module); a failed load raises and leaves the
        old version serving. The flip replaces the model, the version
        stamp and the swap epoch in one lock acquisition; a batch that
        took the old model runs it to completion. The kernels the head
        runs are built and loaded once per process, at warmup, so a swap
        builds none: the info keeps the JAX engine's ``compiles`` keys,
        at 0."""
        spec = self.tasks.get(task)
        if spec is None:
            raise ValueError(
                f"unknown task {task!r} (serving: {sorted(self.tasks)})")
        if not checkpoint or not os.path.isfile(checkpoint):
            raise FileNotFoundError(f"swap checkpoint missing: "
                                    f"{checkpoint!r}")
        with self._swap_lock:
            if self._swap_inflight:
                raise SwapBusy(
                    "a hot-swap is already in flight; retry after it "
                    "completes")
            self._swap_inflight = True
            swap_attempt = self._swaps + 1
        try:
            options, seed = self._task_build[task]
            t0 = self._clock()
            model = self._build_task(
                task, dict(options, checkpoint=checkpoint), seed=seed)
            load_s = self._clock() - t0
            # Chaos hook (testing/faults.py swap_hold): hold the window
            # between the load and the flip open.
            faults.get_plan().serve_swap_check(swap_attempt, emit=emit)
            with self._swap_lock:
                from_version = self.serving_version
                spec.model = model
                self.serving_version = str(version)
                self._swap_epoch += 1
                self._swaps += 1
        finally:
            with self._swap_lock:
                self._swap_inflight = False
        return {
            "task": task,
            "version": str(version),
            "from_version": from_version,
            "checkpoint": checkpoint,
            "load_s": round(load_s, 3),
            "compiles": 0,
            "compiles_cold": 0,
            "compiles_warm": 0,
        }

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
        it concurrently with the executor's forward.

        A fused-epilogue engine also stages, for a ``"gather"`` head, the
        [B, epilogue_slots] absolute row positions of every request's
        positions of interest (zero-padded: unused slots gather position 0
        harmlessly); a batch whose rows overflow the quota stages for the
        unfused forward instead. A ``"stack_span"`` head always stages
        fused."""
        spec = self.tasks[task]
        t_host0 = self._clock()
        B, S = self.max_batch_size, plan.bucket
        ids = np.zeros((B, S), np.int32)
        seg = np.zeros((B, S), np.int32)
        mask = np.zeros((B, S), np.int32)
        offsets: Dict[int, Tuple[int, int, int]] = {}  # id -> (row, off, slot)
        epilogue = self._epilogue(spec)
        positions, gather_slots = (self._gather_slots(spec, plan)
                                   if epilogue == "gather" else (None, {}))
        fused = positions is not None or epilogue == "stack_span"
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
                           pack_s=self._clock() - t_host0, fused=fused,
                           positions=positions, gather_slots=gather_slots)

    def _gather_slots(self, spec: TaskSpec, plan: BatchPlan):
        """([B, epilogue_slots] absolute row positions, request id -> (row,
        first slot, slot count)) of the positions of interest of a
        ``"gather"`` head; (None, {}) when a row needs more slots than the
        quota, so the batch runs the unfused forward."""
        positions = np.zeros((self.max_batch_size, self.epilogue_slots),
                             np.int32)
        slots: Dict[int, Tuple[int, int, int]] = {}
        for r, row in enumerate(plan.rows):
            used, offset = 0, 0
            for req in row:
                pts = spec.handler.gather_positions(req.features)
                if used + len(pts) > self.epilogue_slots:
                    return None, {}
                positions[r, used:used + len(pts)] = [offset + p for p in pts]
                slots[req.id] = (r, used, len(pts))
                used += len(pts)
                offset += req.length if plan.packed else 0
        return positions, slots

    def _run(self, model: torch.nn.Module, args: tuple,
             positions: Optional[np.ndarray] = None,
             stack: bool = False) -> torch.Tensor:
        """One forward of ``model`` on host arrays (ids, segments, mask[,
        sequence ids[, cls positions]]), synchronized with the device;
        ``positions`` selects the fused gather forward
        (``output_positions``), ``stack`` stacks a span head's (start,
        end) into one [B, 2, S] tensor."""
        # One "serve_forward" range per forward: a /profilez trace counts
        # the forwards of its window by it.
        with torch.inference_mode(), \
                torch.profiler.record_function("serve_forward"):
            tensors = [torch.from_numpy(a).to(self.device) for a in args]
            kwargs = {}
            if positions is not None:
                kwargs["output_positions"] = torch.from_numpy(positions).to(
                    self.device)
            out = model(*tensors, **kwargs)
            if stack:
                out = torch.stack(out, dim=1)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.forwards += 1
        return out

    def execute_staged(self, staged: StagedBatch) -> Tuple[object, dict]:
        """Run one staged batch's forward (incl. the device sync); returns
        (device output, info dict). The ONLY method on the serving path
        that touches the device — in pipelined dispatch, only the executor
        stage calls it.

        The model, its swap epoch and the version are read in ONE lock
        acquisition, so the whole forward runs on one consistent version
        whenever a hot-swap flips the head; a model that changed while the
        epoch did not (a change that bypassed the flip) counts as a torn
        serve."""
        spec = self.tasks[staged.task]
        plan = staged.plan
        t0 = self._clock()
        with self._swap_lock:
            model = spec.model
            epoch = self._swap_epoch
            version = self.serving_version
        out = self._run(model, staged.args, staged.positions,
                        stack=staged.fused
                        and spec.handler.epilogue == "stack_span")
        faults.get_plan().serve_forward_check()
        with self._swap_lock:
            if spec.model is not model and self._swap_epoch == epoch:
                self._torn_serves += 1
        info = {
            "bucket": plan.bucket,
            "rows": self.max_batch_size,
            "real_tokens": sum(r.length for r in plan.requests),
            "device_s": self._clock() - t0,
            "pack_s": staged.pack_s,
            "compiles": 0,
            "packed": plan.packed,
            "fused": staged.fused,
            "version": version,
        }
        return out, info

    def demux(self, staged: StagedBatch, out) -> List[object]:
        """Slice each request's own output back out of the batch output
        (host conversion + per-request views, in ``plan.requests`` order).
        The completion stage runs it, so client decode never blocks the
        next device step. A fused gather batch hands each request its own
        run of gathered rows as a :class:`~bert_pytorch_tpu_torch.serve.
        tasks.GatheredTokens`; a span head's output, stacked [B, 2, S] or
        a (start, end) pair, becomes each request's (start, end) slices."""
        spec = self.tasks[staged.task]
        plan = staged.plan
        kind = spec.handler.output_kind
        if kind == "span":
            if staged.fused:
                both = out.to("cpu").float().numpy()  # one transfer
                start, end = both[:, 0], both[:, 1]
            else:
                start, end = (t.to("cpu").float().numpy() for t in out)
        else:
            host = out.to("cpu").float().numpy()
        gathered = staged.fused and spec.handler.epilogue == "gather"
        results: List[object] = []
        for req in plan.requests:
            r, off, slot = staged.offsets[req.id]
            n = req.length
            if kind == "pooled":
                results.append(host[r, slot] if plan.packed else host[r])
            elif kind == "span":
                results.append((start[r, off:off + n], end[r, off:off + n]))
            elif gathered:
                row, first, count = staged.gather_slots[req.id]
                results.append(tasks_lib.GatheredTokens(
                    host[row, first:first + count]))
            else:
                results.append(host[r, off:off + n])
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
