"""``sparse_conv``'s share of its roofline (kernels/sparse_conv.py): both
variants, ``mma`` and ``simt``."""
from bench.metrics._roofline import roofline

PATTERN = r"sparse_conv_(mma|simt)"


def read(ctx):
    return roofline(ctx, "sparse_conv", PATTERN)
