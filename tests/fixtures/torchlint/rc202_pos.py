"""RC202 positive: compiled functions (decorated, wrapped, lambda) closing
over lowercase module-level mutable state."""
import torch

_scale_table = {}
_history = []


@torch.compile
def apply_scale(x):
    return x * _scale_table["s"]


def step(x):
    return x + len(_history)


step_compiled = torch.compile(step)

identity = torch.compile(lambda xs: (xs, _scale_table))
