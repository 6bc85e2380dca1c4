"""Analytic model-FLOP accounting for MFU reporting: the JAX package's
``utils/flops.py`` counts, with the peaks of NVIDIA cards.

Model FLOPs Utilisation (MFU) divides the *model* FLOPs actually required
per step (forward + backward, NOT counting rematerialisation recompute)
by the card's peak matmul throughput — the convention from the PaLM
appendix.

Matmul FLOP accounting per sequence of length S, hidden H, layers L,
intermediate F, masked positions M, vocab V (a matmul of (m,k)x(k,n)
costs 2mkn FLOPs):

  per layer, forward:
    QKV + output projections:  4 * 2*S*H*H
    attention scores QK^T:     2 * S*S*H
    attention context AV:      2 * S*S*H
    FFN (two mats):            2 * 2*S*H*F
  encoder forward  = L * (8*S*H^2 + 4*S^2*H + 4*S*H*F)
  heads forward:
    pooler:                    2*H*H
    NSP classifier:            2*H*2
    MLM transform:             M * 2*H*H
    MLM decoder (tied vocab):  M * 2*H*V
  training multiplier: 3x forward (one backward pass costs ~2x forward
  in matmul FLOPs — dL/dW and dL/dx per matmul).

Embedding lookups, layernorms, biases, softmax and activations are
omitted (sub-1% and not tensor-core work).
"""

from __future__ import annotations

# Dense bf16 tensor-core peak TFLOP/s by ``torch.cuda.get_device_name()``
# (lowercased): NVIDIA's H100 data sheet, without sparsity, at the card's
# full power limit. Order matters: a PCIe H100 names "H100" too.
_PEAK_TFLOPS_BY_NAME = (
    ("h100 pcie", 756.0),
    ("h100", 989.0),
)


def peak_tflops(device_kind: str) -> float:
    """Dense bf16 TFLOP/s of a card by its name, or 0.0 when unknown
    (``"cpu"`` included: MFU then reads 0.0, never a made-up number)."""
    kind = device_kind.lower()
    for sub, tf in _PEAK_TFLOPS_BY_NAME:
        if sub in kind:
            return tf
    return 0.0


def bert_encoder_flops_per_seq(config, seq_len: int) -> float:
    """Forward matmul FLOPs of the encoder stack for ONE sequence."""
    h = config.hidden_size
    f = config.intermediate_size
    ll = config.num_hidden_layers
    s = seq_len
    # Pure host math: every operand is a Python int off the config / CLI
    # (never a device tensor), so this float() is not a device fetch.
    # torchlint: disable=HS101
    return float(ll * (8 * s * h * h + 4 * s * s * h + 4 * s * h * f))


def bert_train_flops_per_seq(config, seq_len: int, max_pred_per_seq: int,
                             next_sentence: bool = True) -> float:
    """Model FLOPs (fwd+bwd) for ONE sequence of the pretraining objective."""
    h = config.hidden_size
    v = config.vocab_size
    m = max_pred_per_seq
    heads = m * (2 * h * h + 2 * h * v)
    if next_sentence:
        heads += 2 * h * h + 2 * h * 2  # pooler + NSP classifier
    return 3.0 * (bert_encoder_flops_per_seq(config, seq_len) + heads)


def bert_finetune_flops_per_seq(config, seq_len: int, head_outputs: int = 2,
                                per_token_head: bool = True,
                                pooled: bool = False) -> float:
    """Model FLOPs (fwd+bwd) for ONE sequence of a finetuning objective.

    The task head is one linear: H -> ``head_outputs`` applied per token
    (``per_token_head``, e.g. QA span / NER logits) or once on the pooled
    [CLS] vector (``pooled`` adds the H x H pooler matmul first, e.g.
    GLUE / SWAG classification)."""
    h = config.hidden_size
    head = 2.0 * h * head_outputs
    if per_token_head:
        head *= seq_len
    if pooled:
        head += 2.0 * h * h  # pooler
    return 3.0 * (bert_encoder_flops_per_seq(config, seq_len) + head)


def mfu(seq_per_sec_per_chip: float, flops_per_seq: float,
        device_kind: str) -> float:
    """Fraction of the card's peak used by model FLOPs; 0.0 if its peak is
    unknown."""
    peak = peak_tflops(device_kind)
    if peak <= 0:
        return 0.0
    return seq_per_sec_per_chip * flops_per_seq / (peak * 1e12)
