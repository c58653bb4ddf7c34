"""Host ms a Whitted frame of the host's own dispatch: the port's span
`rt.whitted.frame` (render.render_whitted, the whole call) less its
`rt.whitted.read` (the host waiting on the card for the frame's counters)."""

from rtbench import program_spans


def read(ctx):
    if ctx["entry"] != "whitted":
        return None
    frame = program_spans.per_unit_ms(ctx, "rt.whitted.frame", "rt.whitted.frame")
    wait = program_spans.per_unit_ms(ctx, "rt.whitted.read", "rt.whitted.frame")
    return None if frame is None or wait is None else frame - wait
