"""Seconds to build the cell's scene on the card from its data (the port's
SceneBuilder: tables, BVH and blocked layout), a span of the benchmark's
around the call, ending in a sync."""


def read(ctx):
    return ctx["spans"]["scene_build_s"]
