"""The whole step's share of the card's bf16 dense peak over the untraced
window: the model's operations (work/model.py) x the images served / the
time their units took (a request's own wall time; the window's length for
a stream) / 989 TFLOP/s, in %."""
from bench import peaks


def read(ctx):
    w = ctx.window
    if not w.get("images") or not w.get("units") or not w.get("unit_s"):
        return None
    return (100.0 * ctx.model_ops * w["images"] / (w["units"] * w["unit_s"])
            / peaks.MFU_PEAK)
