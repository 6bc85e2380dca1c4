"""RC203 negative: numeric literals to a function that keys no cache and
to a compiled callable marked dynamic (its ints are symbolic), bool keys
(mode flags of tiny cardinality), and a key from a variable."""
import functools

import torch


@functools.lru_cache(maxsize=None)
def build_kernel(name, fused):
    return (name, fused)


def scaled(x, factor):
    return x * factor


dynamic = torch.compile(scaled, dynamic=True)


def call(x, block_q):
    a = scaled(x, 0.5)
    b = dynamic(x, 2)
    c = build_kernel("layer_norm_fwd", True)
    d = build_kernel("layer_norm_fwd", block_q)
    return a, b, c, d
