"""RC203 positive: a numeric Python literal at a key position of a
cache-keyed builder — each distinct value is a new build."""
import functools


@functools.lru_cache(maxsize=None)
def build_kernel(name, block_q):
    return (name, block_q)


def call():
    return build_kernel("flash_attention_infer", 128)
