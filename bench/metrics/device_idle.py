"""The device's idle share of a unit, in %: 1 - the traced span's busy
time a unit (the union of its activity intervals) / the untraced window's
mean time a unit (a request's own wall time; a tick's share of the
window)."""


def read(ctx):
    unit_s, busy = ctx.window.get("unit_s"), ctx.busy_per_unit_s
    if not unit_s or busy is None:
        return None
    return 100.0 * (1.0 - busy / unit_s)
