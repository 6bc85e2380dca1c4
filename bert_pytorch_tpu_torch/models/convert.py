"""Weights from the JAX package into the port.

:func:`from_jax_params` turns the JAX package's flax params tree (nested
dicts with numpy leaves, as ``model.init(...)["params"]`` returns after
``nn.unbox`` and a ``np.asarray`` per leaf) into this package's state dict
for one head: a serving head or the pretraining model. The port's modules
mirror the flax names, so the map is name for name, module by module
(:func:`module_state`, which the streaming checkpoint decode of
``utils/checkpoint.py`` also calls), with three layout changes:

* the encoder's ``nn.scan`` stacks every layer leaf on a leading ``L``
  axis: ``bert/encoder/layers/<leaf>`` [L, ...] becomes
  ``bert.encoder.layers.<i>.<leaf>``;
* flax kernels are [in, out] and torch weights [out, in]; the attention
  DenseGeneral kernels (H, heads, head_dim) and (heads, head_dim, H)
  flatten their (heads, head_dim) axes first, and their (heads, head_dim)
  biases flatten too;
* ``embedding`` tables become ``weight``.

A tree that the JAX package's ``quant.quantize_params`` produced maps the
same way onto a head built with ``quant=``: ``kernel_q`` (int8) becomes
``weight_q``, ``kernel_scale`` ``weight_scale``, and bf16 kernels and
biases stay bf16. :func:`quantize_module` holds the same rules (JAX
``quant.convert_module``) for one module of the port's own fp32 state
dict; :func:`quantize_state_dict` applies them to a whole one.
:func:`to_jax_params` is the inverse of :func:`from_jax_params`: what the
port writes into a checkpoint the JAX package reads.

The JAX package's ``models/convert.py`` ``export_torch_state_dict`` shows
the same layout under HF naming. :func:`from_torch_state_dict` reads that
naming (and the reference's) into the port's names, the counterpart of
the JAX ``convert_torch_state_dict``; :func:`load_tf_checkpoint` reads a
Google TF checkpoint into that naming (``models/tf_bundle.py``, without
TensorFlow); and :func:`load_pretrained_encoder` puts the encoder of a
torch archive, a TF checkpoint or a JAX msgpack checkpoint under a
finetuning model, as the JAX ``load_pretrained_encoder`` does.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np
import torch

from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.ops import quant as quant_ops

# Top-level subtrees each head's params must carry (the serving heads
# under the engine's task names).
HEAD_SUBTREES = {
    "fill_mask": ("bert", "predictions"),
    "classify": ("bert", "head"),
    "squad": ("bert", "qa_outputs"),
    "ner": ("bert", "head"),
    "multiple_choice": ("bert", "head"),
    "pretraining": ("bert", "predictions"),
}
# TF checkpoint variables that are optimizer or loss-scale state, not
# weights (JAX convert.py load_tf_checkpoint).
TF_SKIP = ("adam_v", "adam_m", "global_step", "lamb", "bad_steps",
           "loss_scale", "good_steps")
_STACKED = "bert/encoder/layers/"
# The optimizer subtrees of a training checkpoint: the JAX ``OptState``,
# and the fp16 ``LossScaleState`` that wraps one under ``inner``.
OPT_STATE_KEYS = frozenset(("count", "mu", "nu"))
LOSS_SCALE_KEYS = frozenset(("scale", "growth_count", "inner"))
STACKED_PATH = ("bert", "encoder", "layers")


def modules_of(tree, path=()):
    """(path, {leaf name: leaf}) of every dict of ``tree`` that holds
    leaves (the flax modules), depth first."""
    leaves = {k: v for k, v in tree.items() if not isinstance(v, dict)}
    if leaves:
        yield path, leaves
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from modules_of(value, path + (str(key),))


# Kernel leaf names (plain, int8) and the torch names they take.
_KERNELS = {"kernel": "weight", "kernel_q": "weight_q"}


def _leaf(module: str, name: str, value: torch.Tensor):
    """(port state-dict key, torch-layout tensor) of one unstacked leaf of
    the module at path ``module`` ("/"-joined)."""
    if name in _KERNELS:
        if value.dim() == 3:
            # DenseGeneral: (H, heads, hd) in, or (heads, hd, H) out.
            value = (value.reshape(-1, value.shape[-1])
                     if module.endswith("attention/output")
                     else value.reshape(value.shape[0], -1))
        name, value = _KERNELS[name], value.t().contiguous()
    elif name == "kernel_scale":
        name = "weight_scale"
    elif name == "embedding":
        name = "weight"
    elif name == "bias" and value.dim() == 2:
        value = value.reshape(-1)  # (heads, head_dim) bias
    return f"{module}/{name}".replace("/", "."), value


def module_state(path, leaves: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """One flax module of the JAX params (its path and its leaves as torch
    tensors) as entries of the port's state dict: the per-module rule of
    :func:`from_jax_params`, which the streaming checkpoint decode
    (utils/checkpoint.py) also calls as each module's bytes arrive. A
    module under ``bert/encoder/layers`` holds [L, ...] stacked leaves and
    becomes L modules, ``bert.encoder.layers.<i>...``."""
    module = "/".join(path)
    state: Dict[str, torch.Tensor] = {}
    if tuple(path[:3]) == STACKED_PATH:
        rest = module[len(_STACKED):]
        for name, value in leaves.items():
            for i in range(value.shape[0]):
                key, v = _leaf(f"{_STACKED}{i}/{rest}", name, value[i])
                state[key] = v
        return state
    for name, value in leaves.items():
        key, v = _leaf(module, name, value)
        state[key] = v
    return state


def _check_head(params: dict, config: BertConfig, head: str) -> None:
    if head not in HEAD_SUBTREES:
        raise ValueError(f"unknown head {head!r}; known: {sorted(HEAD_SUBTREES)}")
    required = HEAD_SUBTREES[head]
    if head == "pretraining" and config.next_sentence:
        required = required + ("seq_relationship",)
    missing = [k for k in required if k not in params]
    if missing:
        raise KeyError(f"{head} params lack subtrees {missing} "
                       f"(have {sorted(params)})")


def from_jax_params(params: dict, config: BertConfig,
                    head: str) -> Dict[str, torch.Tensor]:
    """The JAX params of one head (``"fill_mask"``: ``BertForMaskedLM``;
    ``"classify"``: ``BertForSequenceClassification``; ``"squad"``:
    ``BertForQuestionAnswering``; ``"ner"``:
    ``BertForTokenClassification``; ``"pretraining"``:
    ``BertForPreTraining``, whose ``predictions`` head keeps its decoder
    tied to the word embeddings and, with ``config.next_sentence``, whose
    ``seq_relationship`` Dense maps like any other) as a state dict for
    the port's model of the same head: fp32 for fp32 params; for a tree
    from JAX ``quantize_params``, int8 and bf16 leaves keep their type (the
    head built with the same ``quant`` loads it)."""
    _check_head(params, config, head)
    state: Dict[str, torch.Tensor] = {}
    for path, leaves in modules_of(params):
        if path[:3] == STACKED_PATH:
            for name, value in leaves.items():
                if np.shape(value)[0] != config.num_hidden_layers:
                    raise ValueError(
                        f"{'/'.join(path)}/{name}: {np.shape(value)[0]} "
                        f"stacked layers, config has "
                        f"{config.num_hidden_layers}")
        state.update(module_state(
            path, {name: _to_torch(v) for name, v in leaves.items()}))
    return state


def _to_torch(value) -> torch.Tensor:
    """int8 stays int8, bf16 (numpy's ``bfloat16`` extension type, as the
    JAX quantizer stores it) becomes torch bf16, the rest fp32."""
    if isinstance(value, torch.Tensor):
        return value
    value = np.asarray(value)
    if value.dtype == np.int8:
        return torch.from_numpy(np.array(value))
    if value.dtype.name == "bfloat16":
        return torch.from_numpy(value.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(value, dtype=np.float32))


_ATTENTION_IN = ("attention.query", "attention.key", "attention.value")
_LAYER = re.compile(r"bert\.encoder\.layers\.(\d+)\.(.+)")


def _jax_leaf(module: str, name: str, value: torch.Tensor, heads: int):
    """(flax leaf name, JAX-layout tensor) of one port leaf: the inverse
    of :func:`_leaf`."""
    if name in ("weight", "weight_q"):
        if module.endswith("_embeddings"):
            return "embedding", value
        kernel = value.t().contiguous()  # [in, out]
        if module.endswith(_ATTENTION_IN):
            kernel = kernel.reshape(kernel.shape[0], heads, -1)
        elif module.endswith("attention.output"):
            kernel = kernel.reshape(heads, -1, kernel.shape[-1])
        return ("kernel" if name == "weight" else "kernel_q"), kernel
    if name == "weight_scale":
        return "kernel_scale", value
    if name == "bias" and module.endswith(_ATTENTION_IN):
        return name, value.reshape(heads, -1)
    return name, value


def _put(tree: dict, path, value) -> None:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = value


def to_jax_params(state: Dict[str, torch.Tensor], config: BertConfig,
                  head: str, keep_device: bool = False) -> dict:
    """The inverse of :func:`from_jax_params`: the port's state dict of
    ``head`` as the JAX package's nested params, CPU tensors in the JAX
    layout (kernels [in, out], the attention kernels and biases split by
    head, ``weight_q``/``weight_scale`` as ``kernel_q``/``kernel_scale``),
    the encoder layers stacked on a leading ``L`` axis. What
    :func:`~bert_pytorch_tpu_torch.utils.checkpoint.save_checkpoint` writes
    for the JAX package to read. ``keep_device`` leaves each leaf where
    its tensor lives (the transposes and stacks then run there)."""
    heads = config.num_attention_heads
    tree: dict = {}
    layers: Dict[tuple, Dict[int, torch.Tensor]] = {}
    for key, value in state.items():
        module, _, name = key.rpartition(".")
        value = value.detach() if keep_device else value.detach().to("cpu")
        name, value = _jax_leaf(module, name, value, heads)
        match = _LAYER.fullmatch(module)
        if match:
            rest = tuple(match.group(2).split(".")) + (name,)
            layers.setdefault(rest, {})[int(match.group(1))] = value
        else:
            _put(tree, module.split(".") + [name], value.contiguous())
    for rest, by_layer in layers.items():
        if sorted(by_layer) != list(range(config.num_hidden_layers)):
            raise ValueError(
                f"bert.encoder.layers.*.{'.'.join(rest)}: layers "
                f"{sorted(by_layer)}, config has {config.num_hidden_layers}")
        _put(tree, STACKED_PATH + rest, torch.stack(
            [by_layer[i] for i in range(config.num_hidden_layers)]))
    _check_head(tree, config, head)
    return tree


def optimizer_to_jax(model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer, config: BertConfig,
                     head: str, keep_device: bool = False) -> dict:
    """The port's Adam-family optimizer state as the JAX package's
    ``OptState`` subtree, the dict flax writes for that NamedTuple:
    ``{"count": int32 scalar array, "mu": params-shaped first moments,
    "nu": second moments}``, the moments of each parameter under its
    params name and layout (:func:`to_jax_params`). A ``DynamicLossScale``
    (fp16) writes the JAX ``LossScaleState`` around it: ``{"scale": f32,
    "growth_count": i32, "inner": OptState}``."""
    from bert_pytorch_tpu_torch.optim import transforms

    mu, nu = transforms.moments(optimizer, dict(model.named_parameters()))
    tree = {"count": np.asarray(transforms.opt_step_count(optimizer),
                                np.int32),
            "mu": to_jax_params(mu, config, head, keep_device),
            "nu": to_jax_params(nu, config, head, keep_device)}
    if isinstance(optimizer, transforms.DynamicLossScale):
        return {"scale": np.asarray(optimizer.scale, np.float32),
                "growth_count": np.asarray(optimizer.growth_count, np.int32),
                "inner": tree}
    return tree


def check_optimizer_tree(names, where: str, loss_scaled: bool = False,
                         inner_names=()) -> None:
    """Refuse an optimizer subtree the optimizer cannot continue from: a
    plain Adam-family optimizer takes an ``OptState`` ``{count, mu, nu}``;
    a ``DynamicLossScale`` (``loss_scaled``) the fp16 ``LossScaleState``
    ``{scale, growth_count, inner}`` whose ``inner`` (its keys
    ``inner_names``) is an OptState. A loss-scaled tree for a run without
    the scaler, or the reverse, raises ``ValueError`` naming
    ``--dtype float16``; any other tree ``KeyError``."""
    names = set(names)
    if names == LOSS_SCALE_KEYS and set(inner_names) == OPT_STATE_KEYS:
        if not loss_scaled:
            raise ValueError(
                f"{where} holds a loss-scaled (fp16) optimizer state; "
                "resume it with --dtype float16")
        return
    if names == OPT_STATE_KEYS:
        if loss_scaled:
            raise ValueError(
                f"{where} holds an optimizer state without a loss scale; "
                "a --dtype float16 run resumes only a loss-scaled one")
        return
    raise KeyError(f"{where}: optimizer subtree {sorted(names)} is not an "
                   "OptState {count, mu, nu} or a LossScaleState {scale, "
                   "growth_count, inner: OptState}")


def optimizer_from_jax(tree: dict, model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer, config: BertConfig,
                       head: str) -> None:
    """Load a JAX ``OptState`` subtree (:func:`optimizer_to_jax`'s layout)
    into ``optimizer``: the count into every param group, mu and nu into
    each parameter's ``exp_avg`` and ``exp_avg_sq``; for a
    ``DynamicLossScale``, a ``LossScaleState`` whose scale and growth count
    it takes too."""
    from bert_pytorch_tpu_torch.optim import transforms

    loss_scaled = isinstance(optimizer, transforms.DynamicLossScale)
    inner = tree.get("inner")
    check_optimizer_tree(tree, "optimizer state", loss_scaled,
                         inner if isinstance(inner, dict) else ())
    state = inner if loss_scaled else tree
    transforms.load_moments(
        optimizer, dict(model.named_parameters()), int(np.asarray(
            state["count"])), from_jax_params(state["mu"], config, head),
        from_jax_params(state["nu"], config, head))
    if loss_scaled:
        optimizer.load_scale_state(float(np.asarray(tree["scale"])),
                                   int(np.asarray(tree["growth_count"])))


def quantize_module(module: str, leaves: Dict[str, torch.Tensor],
                    mode: str) -> Dict[str, torch.Tensor]:
    """The quantization rule for ONE module of a serving head (its port
    path and its fp32 leaves by name; JAX ``quant.convert_module``), the
    one place the rule lives: :func:`quantize_state_dict` and the
    streaming checkpoint decode both call it.

    Only Dense modules convert (a 2-D ``weight`` with a sibling ``bias``);
    embeddings, LayerNorm and the MLM vocab bias pass through fp32. int8:
    ``weight_q`` (int8) and ``weight_scale`` (0-dim fp32) from the
    host-side :func:`~bert_pytorch_tpu_torch.ops.quant.quantize_array`,
    bias bf16. bf16, and the output layers of ``EXCLUDE_MODULES`` under
    int8: weight and bias bf16. The JAX encoder quantizes its stacked
    kernels with one scale per layer; each of the port's layers is its own
    module with its own per-tensor scale, the same number."""
    weight = leaves.get("weight")
    if weight is None or weight.dim() != 2 or "bias" not in leaves:
        return dict(leaves)
    out = dict(leaves)
    excluded = any(part in quant_ops.EXCLUDE_MODULES
                   for part in module.split("."))
    if mode == "int8" and not excluded:
        q, scale = quant_ops.quantize_array(
            weight.detach().float().cpu().numpy())
        del out["weight"]
        out["weight_q"] = torch.from_numpy(q)
        out["weight_scale"] = torch.from_numpy(scale)
    else:
        out["weight"] = weight.detach().to(torch.bfloat16)
    out["bias"] = leaves["bias"].detach().to(torch.bfloat16)
    return out


def quantize_state_dict(state: Dict[str, torch.Tensor],
                        mode: str) -> Dict[str, torch.Tensor]:
    """A serving head's fp32 state dict in the layout of the same head
    built with ``quant=mode``: :func:`quantize_module` on each module."""
    quant_ops.check_mode(mode)
    modules: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, value in state.items():
        module, _, name = key.rpartition(".")
        modules.setdefault(module, {})[name] = value
    out: Dict[str, torch.Tensor] = {}
    for module, leaves in modules.items():
        for name, value in quantize_module(module, leaves, mode).items():
            out[f"{module}.{name}"] = value
    return out


# -- torch archives (reference / HF naming) ---------------------------------

def _first(sd: Dict, *names: str) -> Optional[torch.Tensor]:
    """The first of ``names`` in ``sd`` (naming variants: ``dense_act`` vs
    ``dense``, ``LayerNorm.weight`` vs ``LayerNorm.gamma``), or None."""
    for name in names:
        if name in sd:
            return sd[name]
    return None


def _pad_vocab(t: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Zero-pad the leading (vocab) axis up to ``vocab_size``."""
    if t.shape[0] > vocab_size:
        raise ValueError(f"checkpoint vocab {t.shape[0]} larger than config "
                         f"vocab {vocab_size}")
    if t.shape[0] == vocab_size:
        return t
    pad = t.new_zeros((vocab_size - t.shape[0],) + tuple(t.shape[1:]))
    return torch.cat([t, pad])


def _torch_names(config: BertConfig, head: str) -> Dict[str, tuple]:
    """Port state-dict name -> the torch names it may take (reference
    naming first, then HF), for the encoder and ``head``'s own modules."""
    names: Dict[str, tuple] = {}

    def dense(port: str, *torch_prefixes: str):
        for leaf in ("weight", "bias"):
            names[f"{port}.{leaf}"] = tuple(f"{p}.{leaf}"
                                            for p in torch_prefixes)

    def norm(port: str, torch_prefix: str):
        names[f"{port}.scale"] = (f"{torch_prefix}.weight",
                                  f"{torch_prefix}.gamma")
        names[f"{port}.bias"] = (f"{torch_prefix}.bias",
                                 f"{torch_prefix}.beta")

    emb = "bert.embeddings"
    for table in ("word_embeddings", "position_embeddings",
                  "token_type_embeddings"):
        names[f"{emb}.{table}.weight"] = (f"{emb}.{table}.weight",)
    norm(f"{emb}.layer_norm", f"{emb}.LayerNorm")
    for i in range(config.num_hidden_layers):
        port, ref = f"bert.encoder.layers.{i}", f"bert.encoder.layer.{i}"
        for proj in ("query", "key", "value"):
            dense(f"{port}.attention.{proj}", f"{ref}.attention.self.{proj}")
        dense(f"{port}.attention.output", f"{ref}.attention.output.dense")
        norm(f"{port}.attention.output_layer_norm",
             f"{ref}.attention.output.LayerNorm")
        dense(f"{port}.intermediate.dense", f"{ref}.intermediate.dense_act",
              f"{ref}.intermediate.dense")
        dense(f"{port}.output", f"{ref}.output.dense")
        norm(f"{port}.output_layer_norm", f"{ref}.output.LayerNorm")
    dense("bert.pooler.dense_act.dense", "bert.pooler.dense_act",
          "bert.pooler.dense")
    if head in ("pretraining", "fill_mask"):
        names["predictions.bias"] = ("cls.predictions.bias",)
        dense("predictions.transform.dense_act.dense",
              "cls.predictions.transform.dense_act",
              "cls.predictions.transform.dense")
        norm("predictions.transform.layer_norm",
             "cls.predictions.transform.LayerNorm")
    if head == "pretraining":
        dense("seq_relationship", "cls.seq_relationship")
    if head == "squad":
        dense("qa_outputs", "qa_outputs")
    if head == "classify":
        dense("head.classifier", "classifier")
    return names


def from_torch_state_dict(state_dict: Dict, config: BertConfig,
                          head: str) -> Dict[str, torch.Tensor]:
    """A reference or HF torch BERT state dict (``module.`` prefixes
    dropped; ``dense_act`` or ``dense``, gamma/beta or weight/bias
    LayerNorms) as the port's state dict for ``head``: fp32 tensors under
    the port's names, the word embeddings and MLM bias zero-padded to
    ``config.vocab_size``. Torch Linear weights are [out, in] in both, so
    nothing is transposed. Modules the archive lacks (a bare encoder loaded
    for a head) are absent from the result, as in the JAX
    ``convert_torch_state_dict``."""
    if head not in HEAD_SUBTREES:
        raise ValueError(f"unknown head {head!r}; known: {sorted(HEAD_SUBTREES)}")
    sd = {(k[7:] if k.startswith("module.") else k): v
          for k, v in state_dict.items()}
    state: Dict[str, torch.Tensor] = {}
    for port, candidates in _torch_names(config, head).items():
        value = _first(sd, *candidates)
        if value is None or (port.endswith("token_type_embeddings.weight")
                             and not config.next_sentence):
            continue
        value = (value.detach().cpu() if isinstance(value, torch.Tensor)
                 else torch.from_numpy(np.asarray(value))).float()
        if port in ("bert.embeddings.word_embeddings.weight",
                    "predictions.bias"):
            value = _pad_vocab(value, config.vocab_size)
        state[port] = value.contiguous()
    if "bert.embeddings.word_embeddings.weight" not in state:
        raise KeyError("no bert.embeddings.word_embeddings.weight in the "
                       "state dict: not a BERT checkpoint")
    return state


def load_tf_checkpoint(prefix: str) -> Dict[str, np.ndarray]:
    """A Google BERT TF checkpoint (``prefix.index`` +
    ``prefix.data-*``) as a torch-style state dict of numpy arrays, for
    :func:`from_torch_state_dict`: the name map of the JAX
    ``load_tf_checkpoint`` (reference load_tf_weights_in_bert,
    modeling.py:58-116): ``layer_N`` -> ``layer.N``, ``kernel`` ->
    ``weight`` transposed to the torch layout, ``gamma``/``beta`` ->
    ``weight``/``bias``, ``output_bias``/``output_weights`` ->
    ``bias``/``weight``, ``squad`` -> ``classifier``; optimizer slots and
    counters skipped. The bundle is read by ``models/tf_bundle.py`` with
    numpy alone."""
    from bert_pytorch_tpu_torch.models.tf_bundle import TFCheckpointReader

    reader = TFCheckpointReader(prefix)
    sd: Dict[str, np.ndarray] = {}
    renames = {"gamma": "weight", "beta": "bias", "output_bias": "bias",
               "output_weights": "weight", "squad": "classifier"}
    for tf_name in reader.shapes():
        if any(s in tf_name.lower() for s in TF_SKIP):
            continue
        arr = reader.get_tensor(tf_name)
        parts = []
        for piece in tf_name.split("/"):
            if piece.startswith("layer_"):
                parts.append("layer." + piece[len("layer_"):])
            elif piece == "kernel":
                arr = np.asarray(arr).T
                parts.append("weight")
            else:
                parts.append(renames.get(piece, piece))
        sd[".".join(parts)] = np.asarray(arr)
    return sd


def tf_checkpoint_prefix(path: str) -> Optional[str]:
    """The TF checkpoint prefix ``path`` names: a directory holding
    ``bert_model.ckpt.index``, or a prefix with its ``.index``; None for
    anything else."""
    if os.path.isdir(path):
        prefix = os.path.join(path, "bert_model.ckpt")
        return prefix if os.path.exists(prefix + ".index") else None
    return path if os.path.exists(path + ".index") else None


def check_pretrained_path(path: str) -> None:
    """Refuse, by name, a pretrained checkpoint :func:`load_pretrained_encoder`
    cannot read, before any weights load: a path that does not exist
    (nor its ``.index``), a directory without ``pytorch_model.bin`` or
    ``bert_model.ckpt.index``, a TF ``.index`` that is not a checkpoint
    index (its table is parsed)."""
    from bert_pytorch_tpu_torch.models.tf_bundle import TFCheckpointReader

    tf_prefix = tf_checkpoint_prefix(path)
    if tf_prefix is not None:
        TFCheckpointReader(tf_prefix)
    elif os.path.isdir(path):
        if not os.path.exists(os.path.join(path, "pytorch_model.bin")):
            raise FileNotFoundError(
                f"{path} holds no pytorch_model.bin and no "
                "bert_model.ckpt.index")
    elif not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint {path} does not exist (nor "
                                f"{path}.index)")


def load_pretrained_encoder(path: str, config: BertConfig,
                            model: torch.nn.Module) -> torch.nn.Module:
    """Put the ``bert`` encoder of a checkpoint under ``model`` (its head
    keeps its fresh init: the strict=False load of reference
    run_squad.py:957-961). ``path`` is a directory holding
    ``pytorch_model.bin`` or ``bert_model.ckpt.*`` (its ``config.json``
    is not read: ``config`` is), a ``.bin``/``.pt``/``.pth`` torch file,
    whose state dict may sit under a ``"model"`` key, a TF checkpoint
    prefix (``<prefix>.index`` beside it; :func:`load_tf_checkpoint`),
    or one of the JAX package's msgpack checkpoints, whose ``model/bert``
    subtree is read params-only (``utils/checkpoint.py``
    ``load_params_only``; the msgpack branch of the JAX
    ``load_pretrained_encoder``). Every encoder tensor of ``model`` must
    be in the checkpoint, but for a pooler built on a config without NSP
    (a classification head's own fresh layer there)."""
    check_pretrained_path(path)
    state = model.state_dict()
    wanted = [k for k in state if k.startswith("bert.") and (
        config.next_sentence or not k.startswith("bert.pooler."))]
    tf_prefix = tf_checkpoint_prefix(path)
    if tf_prefix is not None:
        sd = load_tf_checkpoint(tf_prefix)
    elif os.path.isdir(path) or path.endswith((".bin", ".pt", ".pth")):
        weights = (os.path.join(path, "pytorch_model.bin")
                   if os.path.isdir(path) else path)
        sd = torch.load(weights, map_location="cpu", weights_only=True)
        if isinstance(sd.get("model"), dict):
            sd = sd["model"]  # the reference's checkpoint dict (run_squad.py:958)
    else:
        sd = None
    if sd is None:
        from bert_pytorch_tpu_torch.utils import checkpoint as ckpt_util

        loaded = ckpt_util.load_params_only(
            path, {k: state[k] for k in wanted})
    else:
        loaded = {k: v for k, v in from_torch_state_dict(
            sd, config, "pretraining").items() if k in wanted}
    missing = sorted(k for k in wanted if k not in loaded)
    if missing:
        raise KeyError(f"{path} lacks encoder tensors {missing[:4]} "
                       f"({len(missing)} in all)")
    state.update({k: v.to(state[k].device) for k, v in loaded.items()
                  if k in state})
    model.load_state_dict(state)
    return model
