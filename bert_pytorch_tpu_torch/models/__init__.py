"""BERT model family in PyTorch (the port of the JAX package's
``models``)."""
