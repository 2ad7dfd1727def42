"""The pipeline's bubble over the whole window (launch/serve.py
CNNPipelineServer): 1 - microbatches injected / slot ticks, from the
server's own counters, in %."""


def read(ctx):
    ticks = ctx.window.get("slot_ticks", 0)
    if not ticks:
        return None
    return 100.0 * (1.0 - ctx.window["injected"] / ticks)
