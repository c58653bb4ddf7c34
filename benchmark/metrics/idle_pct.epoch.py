"""Share of the traced window of epochs in which the card ran nothing, in %;
on several cards the card of the rank that paces the epoch
(readings.pacing), whose NCCL kernels hold the least wait."""

from rtbench import readings


def read(ctx):
    if ctx["entry"] != "progressive":
        return None
    s = readings.pacing(ctx)
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
