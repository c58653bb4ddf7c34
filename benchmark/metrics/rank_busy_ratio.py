"""The busiest rank's own device time over the least busy rank's, across
the traced window of a run on several cards: each rank's device operations
but the NCCL kernels, whose time holds the rank's wait for its peers.  1 is
an even deal of the work."""

from rtbench import readings


def read(ctx):
    own = [readings.own_ms(s) for s in readings.rank_traces(ctx)]
    if len(own) < 2 or min(own) <= 0:
        return None
    return max(own) / min(own)
