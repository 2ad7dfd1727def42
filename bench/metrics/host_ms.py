"""Host ms a request (launch/serve.py's request path): the untraced
window's mean own wall time a request less the device's busy time a
request in the traced span."""


def read(ctx):
    unit_s, busy = ctx.window.get("unit_s"), ctx.busy_per_unit_s
    if not unit_s or busy is None:
        return None
    return (unit_s - busy) * 1e3
