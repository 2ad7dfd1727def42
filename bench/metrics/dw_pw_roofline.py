"""``dw_pw``'s share of its roofline (kernels/dw_pw_fused.py): both
variants, ``mma`` and ``simt``."""
from bench.metrics._roofline import roofline

PATTERN = r"dw_pw_(mma|simt)"


def read(ctx):
    return roofline(ctx, "dw_pw", PATTERN)
