"""Host ms an MC epoch in its draws: the port's span `rt.epoch.draws`
(render._epoch: a generator a tile and its randn, rand and scale)."""

from rtbench import program_spans


def read(ctx):
    if ctx["entry"] != "progressive":
        return None
    return program_spans.per_unit_ms(ctx, "rt.epoch.draws", "rt.step.epoch")
