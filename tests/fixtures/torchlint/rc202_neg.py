"""RC202 negative: ALL_CAPS module constants are declared immutable by
convention; locals shadowing the global name are fine; functions that are
not compiled may read module state freely."""
import torch

SCALE_TABLE = {"s": 2.0}
_mutable_cache = {}


@torch.compile
def apply_scale(x):
    return x * SCALE_TABLE["s"]


@torch.compile
def shadowed(x):
    _mutable_cache = {"local": True}
    return x, _mutable_cache


def host_side(x):
    _mutable_cache["x"] = x
    return _mutable_cache
