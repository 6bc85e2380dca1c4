"""Activation functions.

Parity with reference src/modeling.py:118-139 (``gelu``/``bias_gelu``/
``bias_tanh``/``swish`` + ``ACT2FN``), written as plain tensor expressions
that compute in the input's dtype, like the JAX package's counterparts.
"""

import math

import torch


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU — the reference's formulation (modeling.py:118-124)."""
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def bias_gelu(bias: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Fused bias + GELU (reference modeling.py:126-130)."""
    return gelu(y + bias)


def bias_tanh(bias: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Fused bias + tanh (reference modeling.py:132-134)."""
    return torch.tanh(y + bias)


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) (reference modeling.py:136-137)."""
    return x * torch.sigmoid(x)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


ACT2FN = {
    "gelu": gelu,
    "bias_gelu": bias_gelu,
    "bias_tanh": bias_tanh,
    "relu": relu,
    "swish": swish,
    "tanh": torch.tanh,
}
