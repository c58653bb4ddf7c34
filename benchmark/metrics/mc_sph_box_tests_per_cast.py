"""Sphere gate box tests a cast of the MC walk: the port's counter
`mc.sph_box_tests` (each lane's box tests in its gated sphere sweeps,
counted by the walk's own kernel, csrc/common.cuh SphCount, and summed on
the card once an epoch) over the rays the same recorded epochs cast (the
window's counters: primary, advance, march and shadow rays).  A gated sweep
tests every supergroup's box, and each chunk's box of the supergroups its
ray enters, up to a shadow ray's first occluder.  None where the walk does
not gate its sphere sweeps (a scene without the sphere chunk table) or the
port does not count them."""

from rtbench import program_spans


def read(ctx):
    if ctx["entry"] != "progressive" or not ctx["casts"]:
        return None
    tests = program_spans.counter(ctx, "mc.sph_box_tests")
    return None if tests is None else tests / ctx["casts"]
