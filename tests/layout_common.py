"""Shared pieces of the port's model-parallel CPU tests
(tests/test_torch_ring.py, test_torch_pipeline.py, test_torch_mesh_axes.py):
the tiny config, the batches, the JAX single-device references and the
group of worker ranks (tests/_torch_layout_worker.py).

Each test module computes its JAX references once (module fixtures) and
runs its ranks in the background while the references compute.
"""

import json
import os
import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np

from bert_pytorch_tpu import optim as jax_optim
from bert_pytorch_tpu import pretrain as jax_pretrain
from bert_pytorch_tpu.config import BertConfig as JaxConfig
from bert_pytorch_tpu.models import BertForPreTraining as JaxPreTraining
from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.models.convert import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_layout_worker.py")
CONFIG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=128,
              max_position_embeddings=32, type_vocab_size=2,
              next_sentence=True, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
A, B, S, P = 2, 8, 32, 8
SCHEDULE = (4e-3, 0.128, 100)
# The JAX package's own pipeline bars (tests/test_pipeline.py:318-327).
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-5
# A layout that splits no parameter: the composed-strategy bar.
DP_TOL = 1e-6
# The gradients, held as LAMB's first moment after one step: (1 - b1)
# times the clipped gradient the optimizer received, element by element.
# LAMB's first parameter step is lr x trust x sign(g) (about 6e-6 on a
# weight of std 0.02 at this schedule, under PARAM_ATOL), so the
# parameters alone would check only the biases' and LayerNorm's signs.
# The bar is the JAX package's gradient bar (rtol 1e-4, atol 1e-6,
# tests/test_kfac.py:252) with atol scaled by 1 - b1 = 0.1; the moments'
# largest entries are about 2e-4.
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
# K-FAC's state after the step, with an atol that is a fraction of each
# leaf's largest entry (the G factors' entries are about 5e-6, below any
# fixed atol that would suit A's of about 20): the factors at the JAX
# package's rtol between its two capture paths (2e-4,
# tests/test_kfac.py:242-247) and 1e-6 of the largest entry (fp32 sums
# over the rows read 5e-8); the fp32 inverses at rtol 1e-4 and 4e-6 of
# the largest entry, the form of the port's eigen bar
# (tests/test_torch_kfac.py): (F + sqrt(damping) I)^-1 amplifies the
# factors' rounding by up to its condition number (read 1e-6).
FACTOR_RTOL, FACTOR_ATOL_OF_MAX = 2e-4, 1e-6
INVERSE_RTOL, INVERSE_ATOL_OF_MAX = 1e-4, 4e-6
KFAC_FIELDS = ("a", "g", "qa", "qg")
KFAC_DAMPING = 0.003
MASK_RATES = (0.45, 0.3, 0.15, 0.06)


def batch(rng, packed=False):
    """One [B, S] microbatch, its label rate varying by quarter of the
    rows (data replicas hold unequal masked counts)."""
    rate = np.repeat(MASK_RATES, B // len(MASK_RATES))[:, None]
    ids = rng.integers(5, CONFIG["vocab_size"], (B, S)).astype(np.int32)
    out = {"input_ids": ids,
           "segment_ids": rng.integers(0, 2, (B, S)).astype(np.int32),
           "input_mask": np.ones((B, S), np.int32),
           "masked_lm_labels": np.where(rng.random((B, S)) < rate, ids,
                                        -1).astype(np.int32),
           "next_sentence_labels": rng.integers(0, 2, B).astype(np.int32)}
    if not packed:
        out["input_mask"][1, 20:] = 0
        out["masked_lm_labels"][1, 20:] = -1
        return out
    out.update(sequence_ids=np.zeros((B, S), np.int32),
               cls_positions=np.zeros((B, 2), np.int32),
               next_sentence_labels=np.full((B, 2), -1, np.int32))
    for i in range(B):
        n1, n2 = (int(x) for x in rng.integers(S // 4, S // 2, 2))
        out["input_mask"][i] = 0
        out["input_mask"][i, :n1 + n2] = 1
        out["sequence_ids"][i, :n1] = 1
        out["sequence_ids"][i, n1:n1 + n2] = 2
        out["cls_positions"][i] = [0, n1]
        out["next_sentence_labels"][i] = rng.integers(0, 2, 2)
        out["masked_lm_labels"][i, n1 + n2:] = -1
    return out


def stacked(seed, packed=False):
    rng = np.random.default_rng(seed)
    mbs = [batch(rng, packed) for _ in range(A)]
    return {k: np.stack([mb[k] for mb in mbs]) for k in mbs[0]}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, key) if isinstance(v, dict)
                   else {key: np.asarray(v)})
    return out


def jax_params(seed=5):
    model = JaxPreTraining(JaxConfig(**CONFIG), dtype=jnp.float32)
    ids = jnp.zeros((1, S), jnp.int32)
    return jax.tree_util.tree_map(np.asarray, nn.unbox(
        model.init(jax.random.PRNGKey(seed), ids, ids, ids))["params"])


def port_names(jax_tree):
    return {k: v.numpy() for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, jax_tree), BertConfig(**CONFIG),
        "pretraining").items()}


def _tx_schedule():
    schedule = jax_optim.warmup_poly_schedule(*SCHEDULE)
    return jax_optim.lamb(schedule,
                          weight_decay_mask=jax_optim.no_decay_mask), schedule


def jax_step(params, host, kfac=None):
    """The JAX single-device LAMB step from ``params`` on ``host`` [A, B,
    ...]: (metrics, state after it). The state is flat, under the port's
    names: ``param/<name>`` and ``mu/<name>`` (LAMB's first moment: 0.1
    times the clipped, with K-FAC preconditioned, gradient). ``kfac``:
    ``"stats"`` (update_factors on microbatch 0, the inverses, then the
    preconditioned step) or ``"fused"`` (the capture in the step,
    inverses inside it); fp32 inverses; the state then also holds
    ``<field>/<tap path>`` of K-FAC's ``a``, ``g``, ``qa`` and ``qg``."""
    cfg = JaxConfig(**CONFIG)
    model = JaxPreTraining(cfg, dtype=jnp.float32)
    tx, schedule = _tx_schedule()
    params = jax.tree_util.tree_map(jnp.array, params)
    state = jax_pretrain.TrainState(params=params, opt_state=tx.init(params),
                                    rng=jax.random.PRNGKey(2))
    kw = dict(schedule=schedule, next_sentence=True, max_pred_per_seq=P)
    if kfac is None:
        state, metrics = jax_pretrain.make_train_step(
            model, tx, stats_every=1, **kw)(state, host)
    else:
        tapped = JaxPreTraining(cfg, dtype=jnp.float32, kfac_tap=True)
        apply_loss, shapes = jax_pretrain.make_kfac_fns(tapped, True, P)
        jkfac = jax_optim.KFAC(apply_loss, shapes, damping=KFAC_DAMPING,
                               inv_dtype=jnp.float32)
        mb0 = {k: v[0] for k, v in host.items()}
        kstate = jkfac.init(params, mb0)
        if kfac == "stats":
            kstate = jkfac.update_inverses(jkfac.update_factors(
                kstate, params, mb0, jax.random.PRNGKey(13)))
            step = jax_pretrain.make_train_step(model, tx, kfac=jkfac, **kw)
            state, metrics = step(state, host, kstate)
        else:
            step = jax_pretrain.make_train_step(
                model, tx, kfac=jkfac, kfac_capture_model=tapped,
                kfac_factor_interval=1, kfac_inv_interval=1, **kw)
            state, metrics, kstate = step(state, host, kstate)
    out = {k: float(metrics[k]) for k in ("loss", "grad_norm",
                                          "mlm_accuracy", "real_tokens")}
    if "grad_health" in metrics:
        from bert_pytorch_tpu.telemetry import model_stats as jax_stats

        health = jax_stats.health_record(1, metrics["grad_health"])
        out.update(health_grad_norm=health["grad_norm"],
                   health_update_ratio=health["update_ratio"],
                   health_layers=health["per_layer_grad_norm"])
    state = jax.device_get(state)
    want = {f"param/{k}": v for k, v in port_names(state.params).items()}
    want.update({f"mu/{k}": v
                 for k, v in port_names(state.opt_state.mu).items()})
    if kfac is not None:
        want.update({f"{field}/{k}": np.asarray(v, np.float32)
                     for field in KFAC_FIELDS
                     for k, v in getattr(kstate, field).items()})
    return out, want


def case(name, kind, root, mesh_text, batch_name="unpacked", **extra):
    return dict(name=name, kind=kind, config=CONFIG, mesh=mesh_text,
                params=str(root / "params.npz"),
                batch=str(root / f"batch_{batch_name}.npz"), max_pred=P,
                schedule=list(SCHEDULE), damping=KFAC_DAMPING, **extra)


def write_inputs(root):
    """params.npz and the batches; returns (params, batches)."""
    params = jax_params()
    np.savez(root / "params.npz", **flat(params))
    batches = {"unpacked": stacked(1), "packed": stacked(2, packed=True)}
    for name, b in batches.items():
        np.savez(root / f"batch_{name}.npz", **b)
    return params, batches


class Group:
    """The ranks of one world size running a plan of cases in the
    background; :meth:`json`/:meth:`npz` wait for them and read a case's
    output."""

    def __init__(self, root, world, cases, timeout=150):
        self.root, self.world, self.timeout = str(root), world, timeout
        self.out = os.path.join(self.root, "out")
        os.makedirs(self.out, exist_ok=True)
        plan = {"world": world, "init": os.path.join(self.root, "rdzv"),
                "out": self.out, "cases": cases}
        path = os.path.join(self.root, "plan.json")
        with open(path, "w") as f:
            json.dump(plan, f)
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, path, str(r)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        self.logs = None

    def wait(self):
        if self.logs is None:
            try:
                self.logs = [p.communicate(timeout=self.timeout)[0]
                             for p in self.procs]
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
            for r, p in enumerate(self.procs):
                assert p.returncode == 0, f"rank {r}:\n{self.logs[r][-3000:]}"
        return self

    def json(self, name, rank=0):
        self.wait()
        with open(os.path.join(self.out, f"{name}.rank{rank}.json")) as f:
            return json.load(f)

    def npz(self, name, rank=0):
        self.wait()
        return dict(np.load(os.path.join(self.out,
                                         f"{name}.rank{rank}.npz")))


def check_state(got, want, name, atol=PARAM_ATOL):
    """Every entry of :func:`jax_step`'s state against the worker's:
    parameters at ``atol``, gradients (``mu/``) and K-FAC's state at
    their bars."""
    # (rtol, atol, atol as a fraction of the leaf's largest entry)
    bars = {"param": (0.0, atol, 0.0), "mu": (GRAD_RTOL, GRAD_ATOL, 0.0),
            "a": (FACTOR_RTOL, 0.0, FACTOR_ATOL_OF_MAX),
            "g": (FACTOR_RTOL, 0.0, FACTOR_ATOL_OF_MAX),
            "qa": (INVERSE_RTOL, 0.0, INVERSE_ATOL_OF_MAX),
            "qg": (INVERSE_RTOL, 0.0, INVERSE_ATOL_OF_MAX)}
    assert {k.split("/")[0] for k in want} <= set(bars), name
    missing = sorted(set(want) - set(got))
    assert not missing, f"{name}: missing {missing[:4]}"
    assert {k for k in got if k.startswith("param/")} == {
        k for k in want if k.startswith("param/")}, name
    for key, value in want.items():
        rtol, tol, of_max = bars[key.split("/")[0]]
        np.testing.assert_allclose(
            got[key], value, rtol=rtol,
            atol=tol + of_max * float(np.abs(value).max()),
            err_msg=f"{name} {key}")


def check_step(result, state, ref, name, loss_rtol=LOSS_RTOL,
               atol=PARAM_ATOL):
    metrics, want = ref
    np.testing.assert_allclose(result["loss"], metrics["loss"],
                               rtol=loss_rtol, err_msg=f"{name} loss")
    for key in ("grad_norm", "mlm_accuracy", "real_tokens"):
        np.testing.assert_allclose(result[key], metrics[key],
                                   rtol=max(loss_rtol, 1e-5),
                                   err_msg=f"{name} {key}")
    assert result["finite"] == 1.0
    # The grad-health block: the whole model's norms on every layout.
    for key in ("health_grad_norm", "health_update_ratio", "health_layers"):
        np.testing.assert_allclose(result[key], metrics[key],
                                   rtol=max(loss_rtol, 1e-5),
                                   err_msg=f"{name} {key}")
    check_state(state, want, name, atol)
