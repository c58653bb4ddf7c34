"""The MC walk's share of its roofline on a dense scene: the least time the
H100 could take for an epoch's walk (rtbench/readings.mc_least_ms) over
the walk's device time an epoch (mc_kernel_ms), in %.  A blocked scene
reads nothing: its needed work is not counted apart from the
implementation's yet."""

from rtbench import readings


def read(ctx):
    if ctx["entry"] != "progressive" or ctx["blocked"] or not ctx["casts"]:
        return None
    ms = readings.per_unit(ctx, readings.MC_KERNELS)
    return None if ms is None else 100.0 * readings.mc_least_ms(ctx) / ms
