"""The operations of one image's forward, for the ``mfu`` metrics: every
conv, depthwise conv and the classifier, a pruned layer counted at its
stored blocks only; pools, adds and activations are not counted."""
from bench.reference.common import Layer


def ops_per_image(layers: list[Layer], raw: dict) -> int:
    total = 0
    for ly in layers:
        keep = raw[ly.name]["keep"]
        d_in = ly.fan_in
        if keep is not None:
            bm, _ = raw[ly.name]["block"]
            d_in = keep.shape[1] * bm          # kept rows of every column
        pixels = ly.out_hw ** 2 if ly.kind != "fc" else 1
        width = ly.cin if ly.kind == "dw" else ly.cout
        total += 2 * pixels * d_in * width
    return total
