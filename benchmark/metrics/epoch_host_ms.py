"""Host ms an MC epoch of the host's own dispatch: the port's span
`rt.step.epoch` (each epoch of parallel/mesh.train_steps_sharded: draws,
camera, walk, filter, assemble, accumulate and renormalise) less its
`rt.step.wait` spans (the renormalise's two points where the host waits on
the card: ops/tonemap's luma weights copied from the host, which drains
the card's queue, and the percentile's index read on the host)."""

from rtbench import program_spans


def read(ctx):
    if ctx["entry"] != "progressive":
        return None
    epoch = program_spans.per_unit_ms(ctx, "rt.step.epoch", "rt.step.epoch")
    wait = program_spans.per_unit_ms(ctx, "rt.step.wait", "rt.step.epoch")
    return None if epoch is None or wait is None else epoch - wait
