"""K-FAC preconditioner on one GPU: the port of the JAX package's
``optim/kfac.py`` (the reference drives ``kfac_pytorch``, reference
run_pretraining.py:320-355; SURVEY.md §2.2).

- **Factor capture.** The model's taps (``models/bert.py``
  ``kfac_input_tap``/``kfac_output_tap``), armed by :meth:`KFAC.capture`,
  add Σ x̃x̃ᵀ of each covered Dense layer's input (bias coordinate
  appended) and Σ ĝĝᵀ of its output's fp32 cotangent into fp32 sums, in
  backward nodes: once per backward, whatever the remat. The train step's
  own backward is captured (``pretrain.make_train_step(kfac_fused=True)``,
  the JAX ``kfac_capture_model``), or a separate stats pass
  (:meth:`KFAC.update_factors`).
- **State.** :class:`KFACState` holds its tensors on the model's device,
  keyed as the JAX state is: the flat ``/``-joined tap paths of the JAX
  tapped model, the encoder's leaves stacked to (L, d, d) and (L, d)
  (``a``/``qa``/``la`` by the A-factor path, shared by q/k/v; ``g``/``qg``/
  ``lg`` by the output-tap path); ``a`` and ``g`` fp32, ``qa`` and ``qg``
  in ``inv_dtype`` (bf16 by default), ``la`` and ``lg`` fp32, ``count`` an
  int32 scalar. :meth:`KFACState.state_dict` is the ``preconditioner``
  subtree of a training checkpoint in the JAX layout.
- **Cadence.** Factors every ``factor_interval`` optimizer steps (EMA with
  ``factor_decay``; the first update replaces the zeros), inverses every
  ``inv_interval``, preconditioning every step.
- **Inverses.** ``inv_method="cholesky"`` (default): (F + √γ·I)⁻¹ from
  ``torch.linalg.cholesky_ex`` and ``torch.cholesky_inverse``, ``la``/``lg``
  ones; a factor whose Cholesky fails raises :class:`FactorNotPositiveDefinite`
  naming its key (nothing falls back to ``eigen``). ``"eigen"``:
  ``torch.linalg.eigh``, eigenvalues clamped at 0. Stacked factors are
  inverted one layer at a time (the JAX ``lax.map``): a batched call over
  BERT-large's (24, 4097, 4097) MLP factor would need a workspace of
  several GB.
- **Preconditioning.** For a Dense layer y = x W + b (W [in, out], the
  transpose of the torch weight) with W̃ = [W; b] of shape (d_in + 1,
  d_out): P = A⁻¹ W̃ G⁻¹ (cholesky) or the eigenbasis form
  P = Q_A [(Q_Aᵀ W̃ Q_G) / (λ_A λ_Gᵀ + γ)] Q_Gᵀ (eigen), then every layer
  is rescaled by ν = min(1, √(kl_clip / Σ P·W̃·lr²)).

The state's tensors are updated in place (the JAX methods return a new
state); each method returns the state too, so call sites read as the JAX
ones.

Across ranks every rank holds the whole state. ``group`` is the group
whose ranks hold other rows or other tokens of the batch: the data
coordinate's (``dcn x data x fsdp``, parallel/mesh.py) for a whole model,
and for the fused capture of a split model its ``grad`` group (``x seq``:
each seq rank's taps see its S/seq tokens). The factor statistics are
summed over the group before the EMA; the rows and the per-sample scale
count the ``replicas`` (the data replicas), and the inverses are split by
layer over the group, (factor, layer) in turn, then gathered (a sum of
zero-filled parts: the port of ``kfac_state_shardings``' split of the
stacked factors over ``(data, fsdp)``). Under ``model`` the taps of a
split layer gather its features over the ``model`` group before the
statistic (models/bert.py), so the ``model`` ranks hold the same sums and
nothing is summed over ``model``. The step preconditions whole gradients,
gathered over FSDP shards, ``model`` parts and ``pipe`` stages
(pretrain.py ``precondition_whole``). The runner's stats pass on a split
or ring model runs on a whole-model twin that takes the run's weights
gathered whole (run_pretraining.py ``prepare_kfac``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

# The encoder layer index in a module name ("bert.encoder.layers.3.x"):
# the JAX encoder stacks those layers on a leading axis instead.
_LAYER = re.compile(r"\.encoder\.layers\.(\d+)(?=\.|$)")
FIELDS = ("a", "g", "qa", "la", "qg", "lg")


class FactorNotPositiveDefinite(RuntimeError):
    """A damped factor's Cholesky factorization failed."""


@dataclasses.dataclass
class KFACState:
    """EMA Kronecker factors and their inverses (cholesky) or
    eigendecompositions (eigen); the JAX ``KFACState`` field for field."""

    count: torch.Tensor  # number of factor updates applied (int32 scalar)
    a: Dict[str, torch.Tensor]
    g: Dict[str, torch.Tensor]
    qa: Dict[str, torch.Tensor]
    la: Dict[str, torch.Tensor]
    qg: Dict[str, torch.Tensor]
    lg: Dict[str, torch.Tensor]

    def state_dict(self) -> dict:
        """The JAX state's checkpoint tree (flax's ``to_state_dict`` of the
        dataclass): the tensors themselves, not copies."""
        return {"count": self.count,
                **{name: dict(getattr(self, name)) for name in FIELDS}}

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for name in FIELDS
                   for t in getattr(self, name).values()) + 4


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One preconditioned Dense layer (the JAX ``LayerSpec``), with the
    port's module of each stacked layer."""

    g_key: str  # flat '/'-joined path of the output tap
    a_key: str  # flat path of the shared input-statistic tap
    kernel_path: Tuple[str, ...]
    bias_path: Tuple[str, ...]
    a_dim: int  # d_in + 1
    g_dim: int
    stacked: bool  # True for the encoder's (L, ...) layers
    modules: Tuple[str, ...]  # the port's module names, one per layer


def build_layer_specs(model: torch.nn.Module) -> Tuple[LayerSpec, ...]:
    """Every tapped Dense layer of ``model`` (modules with ``KFAC_TAPS``),
    under the JAX tap paths, in the JAX order (sorted by path), at the
    whole model's widths (a layer split over ``model`` counts every
    part)."""
    from bert_pytorch_tpu_torch.parallel.tensor_parallel import split_of

    layout = getattr(model, "layout", None)
    parts = layout.spec.model if layout is not None else 1
    found: Dict[str, dict] = {}
    for name, module in model.named_modules():
        for dense, a_name in getattr(module, "KFAC_TAPS", ()):
            parent = tuple(_LAYER.sub(".encoder.layers", name).split("."))
            g_key = "/".join(parent + (f"{dense}__{a_name}",))
            shape = list(getattr(module, dense).weight.shape)
            split = split_of(f"{name}.{dense}.weight")
            if split is not None:
                shape[split[0]] *= parts
            spec = found.setdefault(g_key, {
                "a_key": "/".join(parent + (f"{a_name}_a",)),
                "kernel_path": parent + (dense, "kernel"),
                "bias_path": parent + (dense, "bias"),
                "a_dim": shape[1] + 1, "g_dim": shape[0],
                "stacked": _LAYER.search(name) is not None, "modules": []})
            spec["modules"].append(f"{name}.{dense}")
    return tuple(LayerSpec(g_key=key, **dict(v, modules=tuple(v["modules"])))
                 for key, v in sorted(found.items(),
                                      key=lambda kv: kv[0].split("/")))


def _tapped_modules(model: torch.nn.Module):
    """(module, layer index or None, JAX path of its parent) of every
    module with taps."""
    for name, module in model.named_modules():
        if getattr(module, "KFAC_TAPS", None):
            m = _LAYER.search(name)
            yield (module, None if m is None else int(m.group(1)),
                   _LAYER.sub(".encoder.layers", name).replace(".", "/"))


class KFAC:
    """K-FAC preconditioner bound to a model with taps.

    Parameters
    ----------
    model:
        the model whose taps capture the factors (``BertForPreTraining``).
    apply_loss:
        ``(batch, dropout_seeds) -> loss`` for the stats pass
        (``pretrain.make_kfac_loss``; the JAX ``make_kfac_fns``); only
        :meth:`update_factors` needs it.
    grad_scale:
        ``batch -> scalar`` rescaling raw output gradients to per-sample
        scale; defaults to the batch size of ``input_ids``.
    skip_layers:
        substrings matched against tap paths; matching layers are not
        preconditioned (the reference's --kfac_skip_layers; the default
        skip set, predictions head and embeddings, is never tapped).
    group:
        the process group whose ranks hold other rows or tokens (None on
        one rank): the statistics are summed and the inverses split over
        it (see the module docstring).
    replicas:
        the data replicas whose rows one factor update covers (the rows
        and the per-sample scale count them); the group's size when None.
    """

    def __init__(self, model: torch.nn.Module,
                 apply_loss: Optional[Callable] = None, *,
                 factor_decay: float = 0.95, damping: float = 0.003,
                 kl_clip: float = 0.001, inv_dtype=torch.bfloat16,
                 inv_method: str = "cholesky",
                 grad_scale: Optional[Callable[[dict], float]] = None,
                 skip_layers: Tuple[str, ...] = (), group=None,
                 replicas: Optional[int] = None):
        if inv_method not in ("cholesky", "eigen"):
            raise ValueError(
                f"inv_method must be cholesky|eigen, got {inv_method!r}")
        self.model = model
        self.apply_loss = apply_loss
        self.factor_decay = factor_decay
        self.damping = damping
        self.kl_clip = kl_clip
        self.inv_dtype = inv_dtype
        self.inv_method = inv_method
        self.grad_scale = grad_scale or (
            lambda batch: batch["input_ids"].shape[0])
        self.skip_layers = tuple(skip_layers)
        self.specs: Tuple[LayerSpec, ...] = ()
        self.device = next(model.parameters()).device
        self.group = group
        # The data replicas whose rows one factor update covers.
        self.replicas = replicas or (
            1 if group is None else dist.get_world_size(group))

    # ------------------------------------------------------------------ init

    def init(self) -> KFACState:
        """Find the taps and build the zeroed state (identity inverses)."""
        self.specs = tuple(
            s for s in build_layer_specs(self.model)
            if not any(skip in s.g_key for skip in self.skip_layers))
        if not self.specs:
            raise ValueError("no K-FAC taps found — does the model have "
                             "KFAC_TAPS modules (and did skip_layers exclude "
                             "everything)?")
        a, g, qa, la, qg, lg = {}, {}, {}, {}, {}, {}
        kw = {"device": self.device}
        for spec in self.specs:
            lead = (len(spec.modules),) if spec.stacked else ()

            def eye(d):
                return torch.eye(d, dtype=self.inv_dtype, **kw).expand(
                    lead + (d, d)).clone()

            if spec.a_key not in a:
                a[spec.a_key] = self._zeros(lead + (spec.a_dim, spec.a_dim))
                qa[spec.a_key] = eye(spec.a_dim)
                la[spec.a_key] = torch.ones(lead + (spec.a_dim,), **kw)
            g[spec.g_key] = self._zeros(lead + (spec.g_dim, spec.g_dim))
            qg[spec.g_key] = eye(spec.g_dim)
            lg[spec.g_key] = torch.ones(lead + (spec.g_dim,), **kw)
        return KFACState(count=torch.zeros((), dtype=torch.int32, **kw),
                         a=a, g=g, qa=qa, la=la, qg=qg, lg=lg)

    def _zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    # --------------------------------------------------------------- capture

    def zero_statistics(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Zeroed fp32 sums ``{"a": {a_key: ...}, "g": {g_key: ...}}`` in
        the state's shapes, for :meth:`capture` to add into."""
        sums: Dict[str, Dict[str, torch.Tensor]] = {"a": {}, "g": {}}
        for spec in self.specs:
            lead = (len(spec.modules),) if spec.stacked else ()
            if spec.a_key not in sums["a"]:
                sums["a"][spec.a_key] = self._zeros(
                    lead + (spec.a_dim, spec.a_dim))
            sums["g"][spec.g_key] = self._zeros(
                lead + (spec.g_dim, spec.g_dim))
        return sums

    @contextlib.contextmanager
    def capture(self, sums):
        """Arm the model's taps to add into ``sums``
        (:meth:`zero_statistics`) for the forwards AND backwards run inside
        (a remat recompute in the backward must see the same taps)."""
        flat = dict(sums["a"], **sums["g"])
        armed = []
        try:
            for module, layer, parent in _tapped_modules(self.model):
                sink = {}
                for dense, a_name in module.KFAC_TAPS:
                    for name in (f"{a_name}_a", f"{dense}__{a_name}"):
                        out = flat.get(f"{parent}/{name}")
                        if out is not None:
                            sink[name] = out if layer is None else out[layer]
                module.kfac_sink = sink
                armed.append(module)
            yield sums
        finally:
            for module in armed:
                module.kfac_sink = None

    # --------------------------------------------------------------- factors

    def update_factors(self, state: KFACState, batch: Dict[str, torch.Tensor],
                       dropout_seeds=None) -> KFACState:
        """The stats pass: one tapped forward and backward of
        ``apply_loss`` on ``batch`` (one microbatch [B, S]), then the EMA.
        The backward asks only for the gradient of the model's first
        parameter (the word embeddings, below every tapped layer), so every
        tap fires and no parameter's ``.grad`` changes."""
        if self.apply_loss is None:
            raise ValueError("update_factors needs apply_loss (the stats "
                             "pass's loss)")
        first = next(self.model.parameters())
        sums = self.zero_statistics()
        with record_function("kfac.stats_pass"), self.capture(sums):
            loss = self.apply_loss(batch, dropout_seeds)
            torch.autograd.grad(loss, [first])
        rows = batch["input_ids"].shape[0] * batch["input_ids"].shape[1]
        self.reduce_statistics(sums)
        return self.ema_factors(state, sums, rows * self.replicas,
                                self.grad_scale(batch) * self.replicas)

    def reduce_statistics(self, sums) -> None:
        """Sum captured statistics over the data group (in place; one
        flat all-reduce)."""
        if self.group is None:
            return
        tensors = [t for part in ("a", "g") for t in sums[part].values()]
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()

    @record_function("kfac.ema")
    def ema_factors(self, state: KFACState, sums, rows: int,
                    scale: float) -> KFACState:
        """Fold captured sums into the factors: G = Σĝĝᵀ·scale²/rows (the
        raw cotangent rescaled to per-sample gradients), A = Σx̃x̃ᵀ/rows,
        each an EMA with ``factor_decay`` (the first update replaces the
        zeros); ``count`` += 1. ``sums`` is consumed (scaled in place)."""
        first = state.count == 0
        keep = torch.where(first, 0.0, self.factor_decay)
        take = torch.where(first, 1.0, 1.0 - self.factor_decay)
        scale = float(scale)
        for key, total in sums["g"].items():
            new = total.mul_(scale * scale).div_(rows)
            state.g[key].mul_(keep).add_(new.mul_(take))
        for key, total in sums["a"].items():
            state.a[key].mul_(keep).add_(total.div_(rows).mul_(take))
        state.count.add_(1)
        return state

    # -------------------------------------------------------------- inverses

    @record_function("kfac.inverses")
    def inverse_factors(self, state: KFACState) -> KFACState:
        """Recompute ``qa``/``la``/``qg``/``lg`` from the factors, one layer
        at a time; across ranks each (factor, layer) on one rank of the
        group in turn, then gathered."""
        n = 1 if self.group is None else dist.get_world_size(self.group)
        me = 0 if self.group is None else dist.get_rank(self.group)
        unit = 0
        for factors, ops, values in ((state.a, state.qa, state.la),
                                     (state.g, state.qg, state.lg)):
            for key, fac in factors.items():
                stacked = fac.dim() == 3
                layers = fac if stacked else fac[None]
                op = ops[key] if stacked else ops[key][None]
                lam = values[key] if stacked else values[key][None]
                mine = [(unit + i) % n == me for i in range(len(layers))]
                unit += len(layers)
                if self.inv_method == "eigen":
                    for i, one in enumerate(layers):
                        if not mine[i]:
                            op[i].zero_()
                            lam[i].zero_()
                            continue
                        w, v = torch.linalg.eigh(one)
                        op[i].copy_(v)
                        lam[i].copy_(w.clamp_min(0.0))
                    self._gather_inverses(op, lam)
                    continue
                eye = math.sqrt(self.damping) * torch.eye(
                    fac.shape[-1], dtype=fac.dtype, device=fac.device)
                failed = []
                for i, one in enumerate(layers):
                    if not mine[i]:
                        op[i].zero_()
                        failed.append(torch.zeros((), dtype=torch.int32,
                                                  device=fac.device))
                        continue
                    # (F + √γ·I)⁻¹ through its Cholesky factor.
                    chol, info = torch.linalg.cholesky_ex(one + eye)
                    failed.append(info.to(torch.int32))
                    op[i].copy_(torch.cholesky_inverse(chol))
                lam.fill_(1.0)
                failed = torch.stack(failed)
                self._gather_inverses(op, None, failed)
                failed = failed.cpu()  # one sync per factor
                if failed.any():
                    layer = int(failed.nonzero()[0, 0])
                    raise FactorNotPositiveDefinite(
                        f"K-FAC factor {key} (layer {layer}) is not positive "
                        f"definite after damping {self.damping}: Cholesky "
                        f"failed at order {int(failed[layer])}")
        return state

    def _gather_inverses(self, op, lam, failed=None) -> None:
        """Each rank's layers of ``op`` (and ``lam``, the Cholesky
        ``failed`` codes) to every rank of the group: a sum in fp32 over
        parts the other ranks filled with zeros."""
        if self.group is None:
            return
        for t in (op, lam, failed):
            if t is None:
                continue
            wide = t.float()
            dist.all_reduce(wide, group=self.group)
            t.copy_(wide.to(t.dtype))

    def update_inverses(self, state: KFACState) -> KFACState:
        """The inverse update between steps (the JAX jitted wrapper of
        :meth:`inverse_factors`; here the same call)."""
        return self.inverse_factors(state)

    # --------------------------------------------------------- precondition

    @record_function("kfac.precondition")
    def precondition(self, state: KFACState, grads: Dict[str, torch.Tensor],
                     lr: float) -> Dict[str, torch.Tensor]:
        """Preconditioned gradients with kl_clip trust scaling.

        ``grads``: the port's parameter names to gradients (torch layout).
        Returns a dict of the same names: the tapped layers' weight and
        bias gradients replaced, every other entry passed through."""
        lr = float(lr)
        vg_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        pre = {}
        for spec in self.specs:
            # W̃ per layer: [kernel; bias], kernel = weight.T (d_in, d_out).
            w = torch.stack([torch.cat([grads[f"{m}.weight"].t(),
                                        grads[f"{m}.bias"][None]], dim=0)
                             for m in spec.modules]).float()
            qa = state.qa[spec.a_key].float()
            qg = state.qg[spec.g_key].float()
            if not spec.stacked:
                qa, qg = qa[None], qg[None]
            if self.inv_method == "cholesky":
                # qa/qg hold the damped factor inverses: P = A⁻¹ W̃ G⁻¹.
                p = torch.matmul(torch.matmul(qa, w), qg)
            else:
                la = state.la[spec.a_key].reshape(-1, spec.a_dim)
                lg = state.lg[spec.g_key].reshape(-1, spec.g_dim)
                v = torch.matmul(torch.matmul(qa.transpose(-1, -2), w), qg)
                v = v / (la[:, :, None] * lg[:, None, :] + self.damping)
                p = torch.matmul(torch.matmul(qa, v), qg.transpose(-1, -2))
            vg_sum = vg_sum + torch.sum(p * w) * lr * lr
            pre[spec] = p
        nu = torch.clamp(torch.sqrt(
            self.kl_clip / torch.clamp(vg_sum, min=1e-30)), max=1.0)
        out = dict(grads)
        for spec in self.specs:
            p = pre[spec] * nu
            for i, m in enumerate(spec.modules):
                out[f"{m}.weight"] = p[i, :-1].t().contiguous()
                out[f"{m}.bias"] = p[i, -1].clone()
        return out
