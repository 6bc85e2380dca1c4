"""Hand-written CUDA kernels (sources in ``bert_pytorch_tpu_torch/csrc``),
each beside its plain PyTorch version and a launch counter."""
