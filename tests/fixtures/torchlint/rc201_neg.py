"""RC201 negative: hashable keys (tuple literal, module constant, plain
name) and a collection passed to a function that keys no cache."""
import functools

FLAGS = ("-O3", "-lineinfo")


@functools.lru_cache(maxsize=None)
def build_kernel(name, flags):
    return (name, flags)


def plain(x, dims):
    return x


def call(x, flags):
    a = build_kernel("layer_norm_fwd", ("-O3",))
    b = build_kernel("layer_norm_fwd", FLAGS)
    c = build_kernel("layer_norm_fwd", flags)
    d = plain(x, [1, 2, 3])
    return a, b, c, d
