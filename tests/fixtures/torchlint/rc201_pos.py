"""RC201 positive: fresh collections at cache-key positions — a list
keying an lru_cache'd kernel builder, and a dict passed to a
torch.compile'd callable (it guards on the container)."""
import functools

import torch


@functools.lru_cache(maxsize=None)
def build_kernel(name, flags):
    return (name, flags)


def forward(x, cfg):
    return x


compiled = torch.compile(forward)


def call(x):
    lib = build_kernel("layer_norm_fwd", ["-O3"])
    out = compiled(x, {"hidden": 4})
    return lib, out
