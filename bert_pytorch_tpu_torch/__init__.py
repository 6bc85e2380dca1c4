"""PyTorch / CUDA port of ``bert_pytorch_tpu`` for NVIDIA Hopper (H100).

A package of its own beside the JAX package: it imports ``torch`` and
numpy, never JAX and nothing of ``bert_pytorch_tpu``, and keeps the JAX
package's module names so each counterpart is easy to find. Three paths
are ported:

* serving: ``python -m bert_pytorch_tpu_torch.run_server`` serves the
  ``fill_mask``, ``classify``, ``squad`` and ``ner`` heads over HTTP from
  the JAX package's checkpoints (``utils/checkpoint.py``, params-only)
  with hot-swap, the encoder's attention in a hand-written CUDA kernel
  (``csrc/flash_attention_infer.cu``);
* pretraining: ``python -m bert_pytorch_tpu_torch.run_pretraining`` trains
  BERT MLM+NSP on one GPU (``pretrain.py``, ``optim/``, ``data/``), the
  attention forward and backward in hand-written CUDA kernels
  (``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``)
  behind one autograd Function (``ops/kernels/attention.py``), saving
  and resuming the JAX package's training checkpoints
  (``utils/checkpoint.py``) across the two-phase recipe;
* finetuning: ``run_squad``, ``run_glue``, ``run_ner`` and ``run_swag``
  from a pretraining checkpoint, each saving what the server loads.
"""
