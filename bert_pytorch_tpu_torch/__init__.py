"""PyTorch / CUDA port of ``bert_pytorch_tpu`` for NVIDIA Hopper (H100).

A package of its own beside the JAX package: it imports ``torch`` and
numpy, never JAX and nothing of ``bert_pytorch_tpu``, and keeps the JAX
package's module names so each counterpart is easy to find. This slice
carries the serving path: ``python -m bert_pytorch_tpu_torch.run_server``
serves the ``fill_mask`` and ``classify`` heads over HTTP, with the
encoder's attention in a hand-written CUDA kernel
(``ops/kernels/attention.py``, ``csrc/flash_attention_infer.cu``).
"""
