"""The port's LayerNorm forward kernel (TPU kernel #6) held against the JAX
package on the CPU: the kernel's plain version against the Pallas kernel
``_ln_forward`` (run in interpret mode, as the JAX package's own tests run
it), the autograd Function's gradients against ``jax.grad`` through
``layer_norm_pallas``, and the ``layer_norm_backend`` knob of the models
and runners.

Inputs are numpy arrays from a seed. Tolerances: out, mean, rstd and the
gradients fp32 1e-5 (the same fp32 math, summed in another order); bf16
out one bf16 ulp of the JAX value plus 1e-5 (one rounding step apart at
most, from fp32 values up to 1e-5 apart); a tiny model's loss and
gradients with the plain and the kernel LayerNorm 1e-6 (the Function's
backward formula against autograd through the plain ops).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert_pytorch_tpu.ops.pallas import layernorm as jax_ln
from bert_pytorch_tpu_torch import pretrain, run_pretraining
from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.models import bert
from bert_pytorch_tpu_torch.ops import layernorm as ln_ops
from bert_pytorch_tpu_torch.ops.kernels import layernorm as kln

ATOL = 1e-5
MODEL_ATOL = 1e-6
EPS = 1e-12


def _inputs(rows, hidden, seed, flat_rows=True):
    """x [rows, H] (with ``flat_rows``, row 0 all zero and row 1 constant:
    variance 0), scale, bias as fp32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, hidden)) * 2.0 + 0.5).astype(np.float32)
    if flat_rows:
        x[0] = 0.0
        x[1] = 0.5
    scale = (1.0 + 0.1 * rng.standard_normal(hidden)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(hidden)).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("rows,hidden", [(6, 32), (37, 96), (16, 768)])
def test_plain_version_matches_jax_kernel(rows, hidden):
    """out, mean and rstd of ``layer_norm_fwd_reference`` against the
    Pallas ``_ln_forward``; the zero-variance rows give rstd = rsqrt(eps)
    on both sides, unguarded."""
    x, scale, bias = _inputs(rows, hidden, rows)
    j_out, j_mean, j_rstd = jax_ln._ln_forward(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), EPS)
    out, mean, rstd = kln.layer_norm_fwd_reference(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        EPS)
    assert out.dtype == torch.float32 and mean.shape == (rows, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(mean.numpy(), np.asarray(j_mean), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(j_rstd), rtol=ATOL)
    assert rstd[0].item() == pytest.approx(1e6, rel=1e-6)
    np.testing.assert_array_equal(out[0].numpy(), bias)


def test_plain_version_matches_jax_kernel_in_bf16():
    x, scale, bias = _inputs(24, 128, 7)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    j_out, _, _ = jax_ln._ln_forward(xb, jnp.asarray(scale),
                                     jnp.asarray(bias), EPS)
    want = np.asarray(j_out.astype(jnp.float32))
    out, _, _ = kln.layer_norm_fwd_reference(
        torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(scale), torch.from_numpy(bias), EPS)
    assert out.dtype == torch.bfloat16
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    assert (np.abs(out.float().numpy() - want) <= ulp + ATOL).all()


def test_function_gradients_match_jax_grad():
    """dx, dscale, dbias of the kernel backend's autograd Function (rank 3,
    a non-trivial output gradient) against ``jax.grad`` through
    ``layer_norm_pallas``, whose backward is the plain XLA the Function
    ports. No zero-variance row: there dx scales with rstd = 1e6."""
    x, scale, bias = _inputs(30, 64, 3, flat_rows=False)
    x = x.reshape(5, 6, 64)
    g = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def f(x, s, b):
        return jnp.sum(jax_ln.layer_norm_pallas(x, s, b, EPS) * g)

    j_grads = jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (x, scale, bias)]
    out = kln.layer_norm_kernel(*leaves, EPS)
    assert out.shape == x.shape
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, got, want in zip(("dx", "dscale", "dbias"), grads, j_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=name)


def test_cpu_calls_take_the_plain_version_and_count_nothing():
    x, scale, bias = (torch.from_numpy(t) for t in _inputs(9, 40, 1))
    before = kln.layer_norm_fwd.launches
    got = kln.layer_norm_fwd(x, scale, bias, EPS)
    want = kln.layer_norm_fwd_reference(x, scale, bias, EPS)
    assert kln.layer_norm_fwd.launches == before
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_layer_norm_backends_agree_and_names_resolve():
    x, scale, bias = (torch.from_numpy(t) for t in _inputs(12, 48, 2))
    x3 = x.reshape(3, 4, 48)
    torch.testing.assert_close(
        ln_ops.layer_norm(x3, scale, bias, EPS, backend="kernel"),
        ln_ops.layer_norm(x3, scale, bias, EPS), atol=ATOL, rtol=0)
    assert ln_ops.resolve_backend("xla") == "plain"
    assert ln_ops.resolve_backend("pallas") == "kernel"
    assert ln_ops.resolve_backend("kernel") == "kernel"
    with pytest.raises(ValueError, match="not one of"):
        ln_ops.resolve_backend("apex")
    with pytest.raises(ValueError, match="not one of"):
        ln_ops.layer_norm(x, scale, bias, backend="pallas")
    with pytest.raises(ValueError, match="layer_norm_backend"):
        bert.LayerNorm(48, backend="xla")


CONFIG = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=64,
              max_position_embeddings=64, type_vocab_size=2,
              next_sentence=True, hidden_dropout_prob=0.1,
              attention_probs_dropout_prob=0.1)


def _batch():
    rng = np.random.default_rng(0)
    b, s = 3, 24
    ids = rng.integers(5, CONFIG["vocab_size"], (b, s))
    mask = np.ones((b, s), np.int64)
    mask[1, 15:], mask[2, 9:] = 0, 0
    labels = np.where(rng.random((b, s)) < 0.25, ids, -1)
    labels[mask == 0] = -1
    seg = np.zeros((b, s), np.int64)
    seg[:, s // 2:] = 1
    return {k: torch.from_numpy(np.asarray(v, np.int64)) for k, v in dict(
        input_ids=ids, segment_ids=seg, input_mask=mask,
        masked_lm_labels=labels,
        next_sentence_labels=rng.integers(0, 2, b)).items()}


@pytest.mark.parametrize("remat", ["dots", "none"])
def test_model_loss_and_grads_match_across_backends(remat):
    """A tiny BertForPreTraining, dropout on, with every LayerNorm plain
    and with every LayerNorm through the kernel's autograd Function (under
    ``torch.utils.checkpoint`` with the dots policy, which recomputes it in
    the backward): the same loss and gradients from the same weights and
    dropout seeds."""
    cfg = BertConfig(**CONFIG)
    seeds = bert.draw_dropout_seeds(torch.Generator().manual_seed(3),
                                    cfg.num_hidden_layers)
    results = {}
    for backend in ("plain", "kernel"):
        model = bert.init_weights(
            bert.BertForPreTraining(cfg, torch.float32, "flash", remat,
                                    layer_norm_backend=backend), 0.2,
            torch.Generator().manual_seed(0))
        norms = [m for m in model.modules() if isinstance(m, bert.LayerNorm)]
        assert len(norms) == 1 + 2 * cfg.num_hidden_layers + 1
        assert {m.backend for m in norms} == {backend}
        loss, _ = pretrain.pretraining_loss_and_accuracy(model, _batch(), True,
                                                         6, seeds)
        loss.backward()
        results[backend] = (loss.detach(), {
            n: p.grad for n, p in model.named_parameters()})
    (loss_p, grads_p), (loss_k, grads_k) = results["plain"], results["kernel"]
    torch.testing.assert_close(loss_k, loss_p, atol=MODEL_ATOL, rtol=0)
    for name, grad in grads_p.items():
        torch.testing.assert_close(grads_k[name], grad, atol=MODEL_ATOL,
                                   rtol=0, msg=name)


def test_pretraining_runner_takes_the_layer_norm_backend(tmp_path):
    """``--layer_norm_backend`` on the pretraining runner: the JAX spelling
    ``pallas`` selects the kernel in every LayerNorm; the default keeps the
    plain one."""
    config = tmp_path / "tiny.json"
    config.write_text(json.dumps(CONFIG))
    argv = ["--model_config_file", str(config), "--global_batch_size", "8",
            "--local_batch_size", "4", "--max_steps", "50", "--steps", "2",
            "--device", "cpu", "--skip_final_checkpoint", "--output_dir",
            str(tmp_path / "out")]
    for extra, want in (([], "plain"),
                        (["--layer_norm_backend", "pallas"], "kernel"),
                        (["--layer_norm_backend", "kernel"], "kernel")):
        args = run_pretraining.setup_training(
            run_pretraining.parse_arguments(argv + extra))
        assert args.layer_norm_backend == want
        model, _ = run_pretraining.prepare_model(args)
        assert {m.backend for m in model.modules()
                if isinstance(m, bert.LayerNorm)} == {want}
    with pytest.raises(ValueError, match="not one of"):
        run_pretraining.setup_training(run_pretraining.parse_arguments(
            argv + ["--layer_norm_backend", "apex"]))
