"""Device ms an epoch of the NCCL kernels (parallel/mesh._reduce's
all_reduce of the photons and of the counters) on the rank that waits
least, over a run on several cards.  A rank's NCCL kernels run from its
entry to the collective's end, so they hold its wait for the slowest peer;
the least over the ranks is the collective's own time."""

from rtbench import readings


def read(ctx):
    traces = readings.rank_traces(ctx)
    if ctx["entry"] != "progressive" or not traces:
        return None
    ms = min(readings.device_ms(s, readings.NCCL_KERNELS) for s in traces)
    return ms / ctx["units"] if ms else None
