"""Tiles of the Whitted ladder run as a replay of a captured CUDA graph, in %
of the tiles traced: the port's counter `ladder.replays` over
`ladder.tiles` (raytracer_tpu_torch/ops/ladder_graph.trace), summed over the
traced frames.  None where the port counts no tiles."""

from rtbench import program_spans


def read(ctx):
    if ctx["entry"] != "whitted":
        return None
    tiles = program_spans.counter(ctx, "ladder.tiles")
    if not tiles:
        return None
    return 100.0 * (program_spans.counter(ctx, "ladder.replays") or 0) / tiles
