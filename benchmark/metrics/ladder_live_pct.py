"""Useful lanes over lanes launched in the ladder's pooled levels, in %: the
port's counter `ladder.live` (lanes alive or owing pending radiance as
they enter levels 1 .. depth-1) over `ladder.lanes` (those pools' widths),
summed over the traced frames (ops/trace.trace_whitted)."""

from rtbench import program_spans


def read(ctx):
    if ctx["entry"] != "whitted":
        return None
    live = program_spans.counter(ctx, "ladder.live")
    lanes = program_spans.counter(ctx, "ladder.lanes")
    return 100.0 * live / lanes if live is not None and lanes else None
