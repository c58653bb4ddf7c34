"""Cone tests a cast of the MC walk: the port's counter `mc.cone_tests`
(each lane's cone tests, counted by the walk's own kernel, csrc/common.cuh
ConeCount, and summed on the card once an epoch) over the rays the same
recorded epochs cast (the window's counters: primary, advance, march and
shadow rays).  A linear sweep tests every cone for a nearest or interior
cast and, for a shadow ray that no triangle or sphere occludes, every cone
up to its first occluder, the shading point's own left out.  None where the
port does not count them."""

from rtbench import program_spans


def read(ctx):
    if ctx["entry"] != "progressive" or not ctx["casts"]:
        return None
    tests = program_spans.counter(ctx, "mc.cone_tests")
    return None if tests is None else tests / ctx["casts"]
