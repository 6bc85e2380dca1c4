"""Pretraining engine: the train step (first-order, or preconditioned by
K-FAC) and the eval step, the port of the JAX package's ``pretrain.py``
(``make_train_step`` with fp16 loss scaling and the bucketed overlap;
``make_kfac_fns`` as :func:`make_kfac_loss`; ``make_eval_step``;
``stack_microbatches``; ``device_prefetch``).

One optimizer step consumes a batch of [A, B, ...] arrays: A microbatches
run forward and backward in turn, their gradients accumulate in the fp32
``.grad`` of the master parameters, are divided by A, and one optimizer
step follows (reference run_pretraining.py:405-460). Each microbatch draws
its dropout seeds (embeddings + one per layer) from the step's
``torch.Generator`` before its forward, as the JAX step splits its rng per
microbatch and per layer. With K-FAC the averaged gradients are
preconditioned before the optimizer, in the JAX step's order (factors
captured in the step's own backward, due inverses, precondition,
``grad_norm``, optimizer). In fp16 each microbatch's loss is multiplied
by the loss scale before its backward, and the optimizer (a
``DynamicLossScale``) unscales, skips an overflowing step and adjusts the
scale.

Across ranks (``data_parallel``, a :class:`DataParallel`) the step is the
JAX step over the GLOBAL batch: each rank holds its rows of every
microbatch, computes its local loss SUMS, and divides them by the global
masked-token and NSP counts (one all-reduce of two counts per microbatch,
no gradient through it; JAX pretrain.py:263-275), so the sum of the
ranks' gradients is the global-mean gradient whatever masked counts the
ranks hold. That sum is taken once per optimizer step, after the last
microbatch: by parallel/overlap.py's reducer (one flat all-reduce, or
three availability buckets with ``--overlap_grad_reduce``) for replicated
parameters, by FSDP2's reduce-scatter (a sum) for sharded ones. The
loss, ``mlm_accuracy`` and ``real_tokens`` are global (one all-reduce of
the metric sums). Each rank folds its index into the dropout seeds
(models/bert.py ``fold_dropout_seeds``; rank 0 keeps them).

Under the model-parallel axes (``DataParallel.layout``, parallel/mesh.py)
the rows are the data coordinate's: the ranks along ``pipe``, ``seq``
and ``model`` that share one read the same rows and draw the same seeds
(folded with the data coordinate and the seq shard). A ``seq`` rank runs
its S/n slice of every row (:func:`local_inputs`): the masked positions
are chosen over the whole row, and each rank scores those that fall in
its slice; the NSP head reads [CLS] on seq rank 0. The masked counts,
the loss sums and the gradients of replicated parameters are summed over
the ``grad`` group (data coordinate x seq; under ``fsdp`` FSDP2 sums the
shards over the data coordinate and the step adds the ``seq`` sum).
``model`` ranks run their parts of every layer
(parallel/tensor_parallel.py). ``pipe`` runs :func:`make_pp_train_step`,
the GPipe step (JAX ``make_pp_train_step``). K-FAC preconditions each
tapped layer's whole gradient on every rank, gathered over FSDP shards,
``model`` parts and ``pipe`` stages, and keeps this rank's part
(:func:`precondition_whole`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from bert_pytorch_tpu_torch.models.bert import (draw_dropout_seeds,
                                                fold_dropout_seeds)
from bert_pytorch_tpu_torch.models.losses import pretraining_loss_sums
from bert_pytorch_tpu_torch.parallel import pipeline, sharding
from bert_pytorch_tpu_torch.parallel import state as state_lib
from bert_pytorch_tpu_torch.parallel.mesh import (AXIS_MODEL, AXIS_PIPE,
                                                  AXIS_SEQ)
from bert_pytorch_tpu_torch.parallel.overlap import (GradReducer,
                                                     all_reduce_flat)
from bert_pytorch_tpu_torch.parallel.sharding import local
from bert_pytorch_tpu_torch.optim.transforms import (DynamicLossScale,
                                                     global_norm)
from bert_pytorch_tpu_torch.telemetry import model_stats


def _mlm_positions(labels: torch.Tensor, max_pred_per_seq: Optional[int]):
    """(labels [B, P], masked positions [B, P]) when P < S: the first P
    masked positions of each row in index order, then the lowest unmasked
    ones (``jax.lax.top_k`` on the label mask keeps the lowest index first
    among ties; a stable sort gives the same order). (labels, None) when P
    covers the row."""
    if max_pred_per_seq is None or max_pred_per_seq >= labels.shape[-1]:
        return labels, None
    is_masked = (labels != -1).to(torch.int32)
    positions = torch.argsort(-is_masked, dim=1, stable=True)[
        :, :max_pred_per_seq]
    return torch.gather(labels, 1, positions), positions


def local_inputs(mb: Dict[str, torch.Tensor],
                 max_pred_per_seq: Optional[int], seq=None) -> dict:
    """One microbatch as this rank's model takes it: ``input_ids``,
    ``segment_ids``, ``input_mask`` (and packed ``sequence_ids``,
    ``cls_positions``), the MLM ``positions`` (None: every position) and
    ``labels``, and the NSP ``nsp_labels``. With ``seq`` (the ``seq``
    ``AxisGroup``) the token arrays are this rank's S/n slice; the masked
    positions are chosen over the whole row, and those outside the slice
    carry label -1 (position 0); the NSP labels are -1 except on seq rank
    0, which holds [CLS]. Packed rows and a length the group does not
    divide are refused, as the JAX ring refuses them."""
    labels, positions = _mlm_positions(mb["masked_lm_labels"],
                                       max_pred_per_seq)
    out = {key: mb.get(key) for key in ("input_ids", "segment_ids",
                                        "input_mask", "sequence_ids",
                                        "cls_positions")}
    out.update(labels=labels, positions=positions,
               nsp_labels=mb["next_sentence_labels"])
    if seq is None:
        return out
    if mb.get("sequence_ids") is not None:
        raise ValueError(
            "packed batches cannot shard the sequence axis "
            "(MeshSpec.validate(packed=True) rejects seq>1)")
    length = mb["input_ids"].shape[-1]
    if length % seq.size:
        raise ValueError(f"seq={seq.size}: sequence length {length} is not "
                         "divisible by the mesh 'seq' axis")
    width = length // seq.size
    lo = seq.index * width
    for key in ("input_ids", "segment_ids", "input_mask"):
        out[key] = mb[key][:, lo:lo + width]
    if positions is None:
        positions = torch.arange(length, device=labels.device).expand(
            labels.shape)
    inside = (positions >= lo) & (positions < lo + width)
    out["labels"] = torch.where(inside, labels, torch.full_like(labels, -1))
    out["positions"] = torch.where(inside, positions - lo,
                                   torch.zeros_like(positions))
    if seq.index:
        out["nsp_labels"] = torch.full_like(out["nsp_labels"], -1)
    return out


def microbatch_sums(model, mb: Dict[str, torch.Tensor], next_sentence: bool,
                    max_pred_per_seq: Optional[int], dropout_seeds=None,
                    seq=None):
    """The shared apply of one microbatch and its loss sums:
    ``pretraining_loss_sums``' ``(mlm_sum, mlm_count, nsp_sum,
    nsp_count, mlm_correct)`` (over this rank's positions under
    ``seq``)."""
    x = local_inputs(mb, max_pred_per_seq, seq)
    return _loss_sums(model(
        x["input_ids"], x["segment_ids"], x["input_mask"], x["positions"],
        x["sequence_ids"], x["cls_positions"], dropout_seeds), x,
        next_sentence)


def _loss_sums(logits, x: dict, next_sentence: bool):
    """``pretraining_loss_sums`` of the heads' (MLM, NSP) ``logits`` on
    :func:`local_inputs`' microbatch ``x``."""
    mlm_logits, nsp_logits = logits
    return pretraining_loss_sums(
        mlm_logits, nsp_logits if next_sentence else None, x["labels"],
        x["nsp_labels"] if next_sentence else None)


def label_counts(x: dict, next_sentence: bool) -> torch.Tensor:
    """[masked, NSP] label counts of :func:`local_inputs`' microbatch
    (fp32; no model needed)."""
    n_mlm = (x["labels"] != -1).sum()
    n_nsp = ((x["nsp_labels"] != -1).sum() if next_sentence
             else torch.zeros_like(n_mlm))
    return torch.stack([n_mlm, n_nsp]).float()


def _mean_loss(mlm_sum, nsp_sum, counts: torch.Tensor, next_sentence: bool):
    """The loss from its sums over ``counts`` [..., 2] (masked, NSP)."""
    counts = counts.clamp(min=1)
    loss = mlm_sum / counts[..., 0]
    if next_sentence:
        loss = loss + nsp_sum / counts[..., 1]
    return loss


def pretraining_loss_and_accuracy(model, mb: Dict[str, torch.Tensor],
                                  next_sentence: bool,
                                  max_pred_per_seq: Optional[int],
                                  dropout_seeds=None):
    """The loss and MLM accuracy of one microbatch on its own."""
    mlm_sum, n_mlm, nsp_sum, n_nsp, correct = microbatch_sums(
        model, mb, next_sentence, max_pred_per_seq, dropout_seeds)
    counts = torch.stack([n_mlm, n_nsp]).float()
    return (_mean_loss(mlm_sum, nsp_sum, counts, next_sentence),
            correct / counts[0].clamp(min=1))


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """The step's place among the ranks that split each microbatch (all
    the ranks of the default process group, over which the counts, the
    metric sums and the replicated gradients reduce): ``rank`` of
    ``world_size`` (its rows of the batch, its dropout fold), ``fsdp``
    (the model is FSDP2-sharded: FSDP reduces the gradients) and
    ``overlap`` (``--overlap_grad_reduce``: bucketed, launched during the
    last backward). ``layout`` (a ``parallel.mesh.Layout``): the reductions
    run over its ``grad`` group and the dropout fold is its
    ``dropout_index`` (see the module docstring)."""

    rank: int = 0
    world_size: int = 1
    fsdp: bool = False
    overlap: bool = False
    layout: object = None

    @property
    def group(self):
        """The group the counts, sums and replicated gradients reduce
        over (None: the default group, or no reduction for one rank)."""
        return None if self.layout is None else self.layout.groups["grad"]

    @property
    def reduces(self) -> bool:
        return self.layout is None or self.group is not None

    @property
    def fold(self) -> int:
        return self.rank if self.layout is None else self.layout.dropout_index

    def axis(self, name):
        return None if self.layout is None else self.layout.axis(name)


def make_kfac_loss(model: torch.nn.Module, next_sentence: bool = True,
                   max_pred_per_seq: Optional[int] = None, group=None):
    """``apply_loss(mb, dropout_seeds) -> loss`` for ``KFAC``'s stats pass
    (the JAX ``make_kfac_fns``), sharing the train step's loss. Its forward
    runs without remat, as the JAX stats twin is built (``remat="none"``:
    a small decoupled batch, where remat would only cost recompute). With
    ``group`` (the data coordinate's) the loss is this rank's sums over
    the group's counts, as the JAX stats pass's loss over the global
    stats batch."""

    def apply_loss(mb, dropout_seeds=None):
        encoder = model.bert.encoder
        saved, encoder.remat = encoder.remat, "none"
        try:
            mlm_sum, n_mlm, nsp_sum, n_nsp, _ = microbatch_sums(
                model, mb, next_sentence, max_pred_per_seq, dropout_seeds)
        finally:
            encoder.remat = saved
        counts = torch.stack([n_mlm, n_nsp]).float()
        if group is not None:
            dist.all_reduce(counts, group=group)
        return _mean_loss(mlm_sum, nsp_sum, counts, next_sentence)

    return apply_loss


def make_train_step(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    schedule: Optional[Callable[[int], float]] = None,
                    next_sentence: bool = True,
                    max_pred_per_seq: Optional[int] = None,
                    generator: Optional[torch.Generator] = None,
                    kfac=None, kfac_fused: bool = False,
                    kfac_factor_interval: int = 1,
                    kfac_inv_interval: int = 0,
                    kfac_capture_microbatches: str = "first",
                    stats_every: int = 0, stats_phase: int = 0,
                    loss_scale: bool = False,
                    data_parallel: Optional[DataParallel] = None):
    """Build ``step(batch) -> metrics`` for [A, B, ...] batches
    (input_ids/segment_ids/input_mask/masked_lm_labels [A, B, S],
    next_sentence_labels [A, B] or [A, B, K], and for packed rows
    sequence_ids [A, B, S] and cls_positions [A, B, K]) already on the
    model's device. The model's parameters are updated in place.

    Metrics (device tensors; reading one synchronises): ``loss`` and
    ``mlm_accuracy`` (means over the microbatches), ``grad_norm`` (of the
    averaged gradients, preconditioned with K-FAC, before LAMB's
    clipping), ``finite``, ``real_tokens`` (the non-pad tokens of the step)
    and, with a ``schedule``, ``learning_rate`` (at the pre-step count).

    ``generator`` (CPU) draws the dropout seeds; a model whose dropout
    rates are 0 draws them and drops nothing.

    ``kfac`` (an ``optim.KFAC`` on ``model``, initialised): the step is
    ``step(batch, kfac_state)`` and preconditions the averaged gradients
    with ``lr = schedule(count)`` before the optimizer (needs a
    ``schedule``). ``kfac_fused`` (the JAX ``kfac_capture_model``)
    captures the factors in the step's own backward on steps where
    ``count % kfac_factor_interval == 0``: microbatch 0's
    (``kfac_capture_microbatches="first"``) or every microbatch's
    (``"all"``, summed over A·B·S rows); with ``kfac_inv_interval`` > 0 the
    inverses are rebuilt inside the step, from the factors it just
    captured, where ``count % kfac_inv_interval == 0``. ``kfac_state`` is
    updated in place. Without ``kfac_fused`` the caller drives
    ``kfac.update_factors`` / ``update_inverses`` (the stats flow).

    ``loss_scale=True`` is the fp16 mode (the JAX ``loss_scale``):
    ``optimizer`` is a ``DynamicLossScale``; each microbatch's loss is
    multiplied by its current scale before the backward, ``grad_norm``
    is the true norm (the scaled norm over the scale), ``loss_scale``
    reports the scale the step used, and the grad-health block (when
    ``stats_every`` > 0) runs on every step with its grad norms unscaled.
    An overflowing step's ``grad_norm`` is inf, so ``finite`` is 0 and
    the sentinel sees it as the JAX runner's does.

    ``data_parallel`` (a :class:`DataParallel`): ``batch`` holds this
    rank's rows of each microbatch and the step is the global-batch step
    of the module docstring; the metrics are global. K-FAC across ranks
    sums its statistics over ``kfac.group`` (optim/kfac.py) and
    preconditions whole gradients (:func:`precondition_whole`). The overlap
    composes with neither FSDP nor fp16 loss scaling (the JAX rule); a
    ``pipe`` axis takes :func:`make_pp_train_step`."""
    dp = data_parallel
    if dp is not None and dp.layout is not None and dp.layout.spec.pipe > 1:
        raise ValueError("a pipe axis runs make_pp_train_step")
    if dp is not None and dp.overlap and (dp.fsdp or loss_scale):
        raise ValueError(
            "overlap_grad_reduce composes with the plain first-order dp "
            "path only (no fsdp, no fp16 loss scaling)")
    if kfac is not None and schedule is None:
        raise ValueError("kfac preconditioning requires a schedule")
    if kfac is not None and loss_scale:
        raise ValueError(
            "loss_scale composes with first-order optimizers only; K-FAC "
            "runs in bf16/f32 where no scaler is needed")
    if loss_scale and not isinstance(optimizer, DynamicLossScale):
        raise ValueError("loss_scale needs a DynamicLossScale optimizer")
    if kfac_fused and kfac is None:
        raise ValueError("kfac_fused (the JAX kfac_capture_model) requires "
                         "kfac")
    if kfac_fused and kfac_factor_interval < 1:
        raise ValueError(
            f"kfac_factor_interval must be >= 1, got {kfac_factor_interval}")
    if kfac_inv_interval and not kfac_fused:
        raise ValueError(
            "kfac_inv_interval (inverse updates inside the step) requires the "
            "fused capture (kfac_fused); the stats flow calls "
            "kfac.update_inverses itself")
    if kfac_capture_microbatches not in ("first", "all"):
        raise ValueError(
            f"kfac_capture_microbatches must be first|all, got "
            f"{kfac_capture_microbatches!r}")
    num_layers = model.config.num_hidden_layers
    generator = generator or torch.Generator().manual_seed(0)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    params = [p for _, p in named]
    reducer = (GradReducer(named, dp.overlap, dp.group)
               if dp is not None and not dp.fsdp and dp.reduces else None)
    seq = dp.axis(AXIS_SEQ) if dp is not None else None
    whole_names = _whole_names(model, dp)

    def step(batch: Dict[str, torch.Tensor],
             kfac_state=None) -> Dict[str, torch.Tensor]:
        accum_steps = batch["input_ids"].shape[0]
        count = optimizer.param_groups[0]["count"]
        if kfac is not None and kfac_state is None:
            raise ValueError("a K-FAC step takes step(batch, kfac_state)")
        capture = kfac_fused and count % kfac_factor_interval == 0
        scale = optimizer.scale if loss_scale else None
        sums = kfac.zero_statistics() if capture else None
        for p in params:
            p.grad = None
        loss_sums, counts = [], []
        for a in range(accum_steps):
            mb = {key: value[a] for key, value in batch.items()}
            seeds = draw_dropout_seeds(generator, num_layers)
            if dp is not None:
                seeds = fold_dropout_seeds(seeds, dp.fold)
                # The step's one reduction rides the last backward.
                last = a == accum_steps - 1
                if dp.fsdp:
                    model.set_requires_gradient_sync(last)
                elif last and reducer is not None:
                    reducer.arm()
            tapped = capture and (a == 0
                                  or kfac_capture_microbatches == "all")
            # Armed through the backward: a remat recompute runs the taps.
            with kfac.capture(sums) if tapped else contextlib.nullcontext():
                mlm_sum, n_mlm, nsp_sum, n_nsp, correct = microbatch_sums(
                    model, mb, next_sentence, max_pred_per_seq, seeds, seq)
                # The normalizers, from labels alone (no gradient), over
                # the global microbatch.
                mb_counts = torch.stack([n_mlm, n_nsp]).float()
                if dp is not None and dp.reduces:
                    dist.all_reduce(mb_counts, group=dp.group)
                loss = _mean_loss(mlm_sum, nsp_sum, mb_counts, next_sentence)
                (loss if scale is None else loss * scale).backward()
            loss_sums.append(torch.stack([mlm_sum.detach(), nsp_sum.detach(),
                                          correct.float()]))
            counts.append(mb_counts)
        if capture:
            shape = batch["input_ids"].shape
            rows = shape[1] * shape[2] * (
                accum_steps if kfac_capture_microbatches == "all" else 1)
            kfac.reduce_statistics(sums)
            kfac.ema_factors(kfac_state, sums, rows * kfac.replicas,
                             kfac.grad_scale({key: value[0] for key, value
                                              in batch.items()})
                             * kfac.replicas)
        if kfac_fused and kfac_inv_interval and (
                count % kfac_inv_interval == 0):
            kfac.inverse_factors(kfac_state)
        if reducer is not None:
            reducer.finish()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if dp is not None and dp.fsdp:
            _sum_unreduced(params, dp)
        for p in params:
            p.grad.div_(accum_steps)
        if kfac is not None:
            precondition_whole(kfac, kfac_state, named,
                               None if dp is None else dp.layout,
                               schedule(count))
        return _update_and_metrics(
            optimizer, named, torch.stack(loss_sums), torch.stack(counts),
            batch["input_mask"], dp, seq, next_sentence, schedule, count,
            stats_every, stats_phase, whole_names, scale)

    step.reducer = reducer
    return step


def _update_and_metrics(optimizer, named, loss_sums: torch.Tensor,
                        counts: torch.Tensor, input_mask: torch.Tensor,
                        dp: Optional[DataParallel], seq, next_sentence: bool,
                        schedule, count: int, stats_every: int,
                        stats_phase: int, whole_names, scale=None,
                        pipe=None) -> Dict[str, torch.Tensor]:
    """The tail of both train steps: the gradient norm, the optimizer step
    (with the grad-health block) and the metrics, from the step's
    per-microbatch sums ``loss_sums`` [A, 3] (MLM, NSP, correct; zeros
    off the last stage under ``pipe``) and global label ``counts`` [A,
    2]. Every metric sum is taken over the ranks in one all-reduce; under
    ``pipe`` the last stage's sums are handed to every stage. ``scale``:
    the fp16 loss scale the gradients carry."""
    params = [p for _, p in named]
    gnorm = global_norm([p.grad for p in params], params)
    if scale is not None:
        gnorm = gnorm / scale  # the gradients carry the loss scale
    health = model_stats.step_with_health(
        optimizer, named, 1 if scale is not None and stats_every > 0
        else stats_every, stats_phase, grad_scale=scale,
        whole_names=whole_names)
    totals = torch.cat([loss_sums.reshape(-1),
                        _real_tokens(input_mask, seq)])
    if dp is not None and dp.reduces:
        dist.all_reduce(totals, group=dp.group)
    by_mb = totals[:-1].reshape(-1, 3)
    if pipe is not None:
        dist.broadcast(by_mb, pipe.ranks[-1], group=pipe.group)
    losses = _mean_loss(by_mb[:, 0], by_mb[:, 1], counts, next_sentence)
    metrics = {
        "loss": losses.mean(),
        "mlm_accuracy": (by_mb[:, 2] / counts[:, 0].clamp(min=1)).mean(),
        "grad_norm": gnorm,
        "finite": (torch.isfinite(losses.sum())
                   & torch.isfinite(gnorm)).float(),
        "real_tokens": totals[-1],
    }
    if scale is not None:
        metrics["loss_scale"] = torch.tensor(scale)
    if schedule is not None:
        metrics["learning_rate"] = torch.tensor(float(schedule(count)))
    if health is not None:
        metrics["grad_health"] = health
    return metrics


def _whole_names(model, dp) -> Optional[list]:
    """The single-process model's parameter names when ``model`` is split
    over ``pipe``/``model`` (the grad-health block's names), else None."""
    layout = dp.layout if dp is not None else None
    if layout is None or not layout.model_parallel:
        return None
    return sorted(state_lib.full_shapes(
        model, layout.axis(AXIS_MODEL), layout.axis(AXIS_PIPE),
        model.config.num_hidden_layers))


def _real_tokens(input_mask: torch.Tensor, seq) -> torch.Tensor:
    """The non-pad tokens of ``input_mask`` [A, B, S] this rank counts
    (its slice under ``seq``), fp32 [1]."""
    if seq is not None:
        width = input_mask.shape[-1] // seq.size
        input_mask = input_mask[..., seq.index * width:
                                (seq.index + 1) * width]
    return input_mask.sum().float().reshape(1)


def make_pp_train_step(model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer,
                       schedule: Optional[Callable[[int], float]] = None,
                       next_sentence: bool = True,
                       max_pred_per_seq: Optional[int] = None,
                       generator: Optional[torch.Generator] = None,
                       kfac=None, stats_every: int = 0,
                       stats_phase: int = 0,
                       data_parallel: Optional[DataParallel] = None):
    """The train step with the encoder run as a GPipe pipeline over the
    ``pipe`` axis (the JAX ``make_pp_train_step``; parallel/pipeline.py):
    ``step(batch[, kfac_state]) -> metrics`` as :func:`make_train_step`'s.

    The accumulation microbatches are the pipeline's microbatches (at
    least as many as stages). Stage 0 embeds each microbatch, every stage
    runs its layers (with ``seq``, the ring inside them; with ``model``,
    its part of each), the last stage runs the heads and the loss: each
    microbatch's local sums over its global counts, the gradients summed
    over the microbatches and divided by A, as the JAX step's mean of
    per-microbatch losses. The gradients are then summed over the
    ``grad`` group (one flat all-reduce; under ``fsdp`` FSDP2's
    reduce-scatter in the last microbatch's backward, then the ``seq``
    sum) and those of the replicated parameters (embeddings, heads) over
    ``pipe``. The metrics are the last stage's, handed to every stage.

    ``kfac`` (stats flow only, as the JAX runner falls back under
    ``pipe``): :func:`precondition_whole`. fp16 loss scaling is refused
    with a pipeline, as in JAX."""
    dp = data_parallel
    if dp is None or dp.layout is None or dp.layout.spec.pipe < 2:
        raise ValueError("make_pp_train_step needs a layout with pipe >= 2")
    if isinstance(optimizer, DynamicLossScale):
        raise ValueError("fp16 loss scaling is not supported with pipeline "
                         "parallelism; use bf16 (the JAX rule)")
    if kfac is not None and schedule is None:
        raise ValueError("kfac preconditioning requires a schedule")
    layout = dp.layout
    pipe, seq = layout.axis(AXIS_PIPE), layout.axis(AXIS_SEQ)
    num_layers = model.config.num_hidden_layers
    generator = generator or torch.Generator().manual_seed(0)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    params = [p for _, p in named]
    replicated = [p for n, p in named if ".encoder.layers." not in n]
    is_last = pipe.index == pipe.size - 1
    whole_names = _whole_names(model, dp)

    def step(batch: Dict[str, torch.Tensor],
             kfac_state=None) -> Dict[str, torch.Tensor]:
        accum_steps = batch["input_ids"].shape[0]
        pipeline.check_microbatches(accum_steps, pipe.size)
        count = optimizer.param_groups[0]["count"]
        if kfac is not None and kfac_state is None:
            raise ValueError("a K-FAC step takes step(batch, kfac_state)")
        for p in params:
            p.grad = None
        inputs, seeds = [], []
        for a in range(accum_steps):
            mb = {key: value[a] for key, value in batch.items()}
            inputs.append(local_inputs(mb, max_pred_per_seq, seq))
            seeds.append(fold_dropout_seeds(
                draw_dropout_seeds(generator, num_layers), dp.fold))
        counts = torch.stack([label_counts(x, next_sentence)
                              for x in inputs])
        if dp.group is not None:
            dist.all_reduce(counts, group=dp.group)
        part, like = _stage_fns(model, inputs, seeds, pipe)

        def stage(a, hidden):
            out = part(a, hidden)
            if not is_last:
                return out
            mlm_sum, _, nsp_sum, _, correct = _loss_sums(
                out, inputs[a], next_sentence)
            loss = _mean_loss(mlm_sum, nsp_sum, counts[a], next_sentence)
            return loss, torch.stack([mlm_sum.detach(), nsp_sum.detach(),
                                      correct.float()])

        def before_backward(a):
            # FSDP reduces once a step, in the last microbatch's backward.
            model.set_requires_gradient_sync(a == accum_steps - 1)

        results = pipeline.gpipe(accum_steps, pipe, stage, like,
                                 before_backward=(before_backward if dp.fsdp
                                                  else None))
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        _sum_unreduced(params, dp)
        all_reduce_flat([local(p.grad) for p in replicated], pipe.group)
        for p in params:
            p.grad.div_(accum_steps)
        if kfac is not None:
            precondition_whole(kfac, kfac_state, named, layout,
                               float(schedule(count)))
        sums = (torch.stack([r[1] for r in results]) if is_last else
                torch.zeros((accum_steps, 3), device=counts.device))
        return _update_and_metrics(
            optimizer, named, sums, counts, batch["input_mask"], dp, seq,
            next_sentence, schedule, count, stats_every, stats_phase,
            whole_names, pipe=pipe)

    step.reducer = None
    return step


def _stage_fns(model, inputs: list, seeds: Optional[list], pipe):
    """``pipeline.gpipe``'s (part, like) over microbatches ``inputs``
    (:func:`local_inputs`' dicts) with their dropout ``seeds`` (None: no
    dropout): ``part(m, x)`` is one ``stage_forward`` call (models/bert.py),
    on the last stage the heads' (MLM, NSP) logits."""
    bert = model.bert
    biases = [bert.attention_bias(x["input_ids"], x["input_mask"],
                                  x["sequence_ids"]) for x in inputs]
    first, last = pipe.index == 0, pipe.index == pipe.size - 1

    def part(a, hidden):
        x = inputs[a]
        return model.stage_forward(
            hidden, x["input_ids"], x["segment_ids"], biases[a],
            x["sequence_ids"], x["cls_positions"], x["positions"],
            None if seeds is None else seeds[a], first=first, last=last)

    def like(a):
        ids = inputs[a]["input_ids"]
        return torch.empty(tuple(ids.shape) + (model.config.hidden_size,),
                           dtype=bert.embeddings.word_embeddings.dtype,
                           device=ids.device)

    return part, like


def _sum_unreduced(params, dp: DataParallel) -> None:
    """Sum the gradients of ``params`` over the part of the ``grad`` group
    that the step's own reduction left out: all of it without FSDP (one
    flat all-reduce); under FSDP2, which sums over ``data x fsdp``, the
    ``seq`` group (one flat all-reduce of the local shards)."""
    group = dp.group
    if dp.fsdp:
        group = dp.layout.groups[AXIS_SEQ] if dp.layout is not None else None
    if group is not None:
        all_reduce_flat([local(p.grad) for p in params], group)


def precondition_whole(kfac, kfac_state, named, layout, lr: float) -> None:
    """K-FAC's preconditioning of the tapped layers' averaged gradients
    (``.grad`` of ``named``, in place) on a split model: each is gathered
    whole, over its FSDP shards (parallel/sharding.py ``gather_like``),
    then its ``model`` parts and ``pipe`` stages (parallel/state.py),
    preconditioned alike on every rank (so the kl-clip sum counts every
    parameter once), and this rank's part put back. ``layout`` None (one
    process) or a layout that splits nothing preconditions in place."""
    if layout is None or not (layout.model_parallel or layout.spec.fsdp > 1):
        pre = kfac.precondition(kfac_state, {n: p.grad for n, p in named},
                                lr)
        for name, p in named:
            p.grad = pre[name]
        return
    tapped = {f"{m}.{leaf}" for spec in kfac.specs for m in spec.modules
              for leaf in ("weight", "bias")}
    mine = {n: p for n, p in named if n in tapped}
    whole = {n: sharding.gather_like(local(p.grad), p)
             for n, p in sorted(mine.items())}
    full = state_lib.gather_full(whole, layout.axis(AXIS_MODEL),
                                 layout.axis(AXIS_PIPE),
                                 kfac.model.config.num_hidden_layers)
    pre = kfac.precondition(kfac_state, full, lr)
    model_axis = layout.axis(AXIS_MODEL)
    for name, p in mine.items():
        part = state_lib.local_state(pre, [name], model_axis)[name]
        p.grad = sharding.as_like(part.contiguous(), p)


def make_eval_step(model: torch.nn.Module, next_sentence: bool = True,
                   data_parallel: Optional[DataParallel] = None):
    """Deterministic forward + loss for held-out evaluation, on every
    position (no masked-position gather), packed batches included. With
    ``data_parallel`` the batch is this rank's rows and the loss and
    accuracy are the global batch's (local sums over global counts, one
    all-reduce); under ``pipe`` the forward runs through the stages
    (the last stage's sums handed to every stage)."""
    dp = data_parallel
    seq = dp.axis(AXIS_SEQ) if dp is not None else None
    pipe = dp.axis(AXIS_PIPE) if dp is not None else None

    def pp_sums(batch):
        x = local_inputs(batch, None, seq)
        part, like = _stage_fns(model, [x], None, pipe)
        last = pipe.index == pipe.size - 1
        results = pipeline.gpipe(
            1, pipe, lambda a, hidden: (
                torch.stack([v.float() for v in _loss_sums(
                    part(a, hidden), x, next_sentence)]) if last
                else part(a, hidden)),
            like, backward=False)
        sums = (results[0] if results else
                torch.zeros(5, device=batch["input_ids"].device))
        dist.broadcast(sums, pipe.ranks[-1], group=pipe.group)
        return sums

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]):
        if pipe is not None:
            sums = pp_sums(batch)
        else:
            sums = torch.stack([v.float() for v in microbatch_sums(
                model, batch, next_sentence, None, None, seq)])
        if dp is not None and dp.reduces:
            dist.all_reduce(sums, group=dp.group)
        mlm_sum, n_mlm, nsp_sum, n_nsp, correct = sums
        return (_mean_loss(mlm_sum, nsp_sum, torch.stack([n_mlm, n_nsp]),
                           next_sentence),
                correct / n_mlm.clamp(min=1))

    return eval_step


def stack_microbatches(batch: dict, accum_steps: int) -> dict:
    """[A*B, ...] host batch -> [A, B, ...] (numpy arrays or tensors)."""
    out = {}
    for key, value in batch.items():
        if value.shape[0] % accum_steps != 0:
            raise ValueError(
                f"batch dim {value.shape[0]} not divisible by accumulation "
                f"steps {accum_steps}")
        out[key] = value.reshape(
            (accum_steps, value.shape[0] // accum_steps)
            + tuple(value.shape[1:]))
    return out


def device_prefetch(loader, accum_steps: int, device, depth: int = 2):
    """The loader's global batches stacked into [A, B, ...] microbatches
    and staged on ``device`` ``depth`` ahead (the JAX ``device_prefetch``):
    a :class:`~bert_pytorch_tpu_torch.data.device_prefetch.
    DevicePrefetcher` whose thread stacks each batch and copies it through
    pinned memory on a side CUDA stream (int32 on the wire, int64 on the
    card); the loop receives it on its own stream. ``depth <= 0`` stages
    inline on the loop's thread. Attach the result to ``TrainTelemetry``
    for the ``h2d_wait`` sub-phase; close it when the epoch is left."""
    from bert_pytorch_tpu_torch.data.device_prefetch import prefetch

    return prefetch(loader, device, depth, prepare=lambda host, put: {
        k: put(v) for k, v in stack_microbatches(host, accum_steps).items()})


def to_device(batch: dict, device) -> Dict[str, torch.Tensor]:
    """numpy int arrays (or tensors) -> int64 tensors on ``device``."""
    return {key: torch.as_tensor(np.asarray(value) if not isinstance(
        value, torch.Tensor) else value).to(device=device, dtype=torch.int64,
                                             non_blocking=True)
            for key, value in batch.items()}
