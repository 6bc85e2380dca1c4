"""Parallelism of the port: the launcher (:mod:`.launcher`, one process
per GPU under torchrun), the ``--mesh`` grammar, the rank layout and the
torch ``DeviceMesh`` (:mod:`.mesh`), FSDP2 sharding (:mod:`.sharding`),
the data-parallel gradient reduction (:mod:`.overlap`), tensor
parallelism over ``model`` (:mod:`.tensor_parallel`), the GPipe pipeline
over ``pipe`` (:mod:`.pipeline`), point-to-point transfers
(:mod:`.p2p`) and whole tensors from a rank's parts (:mod:`.state`): the
counterparts of the JAX package's ``parallel/``. Ring attention over
``seq`` lives in ``ops/ring.py``, as in the JAX package."""
