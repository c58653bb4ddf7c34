"""Host ms a Whitted frame in the ladder's group compaction: the port's
spans `rt.ladder.compact` (ops/trace._compact), summed over the frame."""

from rtbench import program_spans


def read(ctx):
    if ctx["entry"] != "whitted":
        return None
    return program_spans.per_unit_ms(ctx, "rt.ladder.compact", "rt.whitted.frame")
