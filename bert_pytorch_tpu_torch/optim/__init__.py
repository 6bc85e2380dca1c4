"""Optimizers and learning-rate schedules of the port (the JAX package's
``optim`` less K-FAC, ``bert_adam`` and fp16 loss scaling)."""
