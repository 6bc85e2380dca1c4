"""Optimizers, learning-rate schedules and the K-FAC preconditioner of the
port (the JAX package's ``optim`` less ``kfac_state_shardings`` and fp16
loss scaling)."""

from bert_pytorch_tpu_torch.optim.kfac import KFAC, KFACState

__all__ = ["KFAC", "KFACState"]
