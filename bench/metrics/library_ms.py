"""Device ms a unit (a request, or a pipeline tick) in every kernel that is
not one of the program's five hand-written ones: the library's dense
convs, pools, copies and casts that the CNN interpreter (models/cnn.py)
calls. Copies between host and device are not kernels and not counted."""
import re

HAND_WRITTEN = re.compile(
    r"sparse_conv_|sparse_matmul_|dw_pw_|depthwise_kernel|flash_attention_")


def read(ctx):
    kernels = [e for e in ctx.span.device_events() if e.kernel]
    if not kernels or not ctx.span.units:
        return None
    lib = sum(e.end - e.start for e in kernels
              if not HAND_WRITTEN.search(e.name))
    return lib * 1e3 / ctx.span.units
