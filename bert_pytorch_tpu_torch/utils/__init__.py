"""Checkpoint reading and writing of the port (the counterparts of the JAX
package's ``utils/checkpoint.py`` and ``utils/integrity.py``), on a
pure-Python msgpack codec (:mod:`.flax_msgpack`)."""
