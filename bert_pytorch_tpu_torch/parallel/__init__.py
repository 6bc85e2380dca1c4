"""Parallelism of the port: the launcher (:mod:`.launcher`, one process
per GPU under torchrun), the ``--mesh`` grammar and the torch
``DeviceMesh`` (:mod:`.mesh`), FSDP2 sharding (:mod:`.sharding`) and the
data-parallel gradient reduction (:mod:`.overlap`), the counterparts of
the JAX package's ``parallel/``. The port realises ``dp``, ``fsdp`` and
their product; ``pipe``, ``seq``, ``model`` and ``dcn`` are refused by
name (ROADMAP.md, "Multi-GPU layouts")."""
