"""The MC walk's share of the roofline of the tests it made on a dense
scene: the least time the H100 could take for them over the walk's device
time an epoch (mc_kernel_ms), in %.

The least time is the larger of the bytes over PEAK_BYTES, counted as
rtbench/readings.mc_least_ms counts them (the draws read once, the photons
written once, the scene's primitives read once), and the operations over
PEAK_FP32: the sphere tests the walk counted (`mc.sph_tests`) x OPS_SPHERE,
its sphere gate's box tests (`mc.sph_box_tests`) x OPS_BOX, its cone tests
(`mc.cone_tests`) x OPS_CONE, and every cast's triangle tests begun (casts
x triangles x OPS_TRI_BEGUN: a dense sweep begins a test of every
triangle).  It counts the work the walk did, so a gate that skips tests
lowers the operations with the time and cannot push the share past 100 %.
None on a blocked scene, without the walk's time, or where the port does
not count the tests of a primitive the scene has."""

from rtbench import program_spans, readings

# A slab (box) test, csrc/common.cuh slab_from, an FMA as 2 and a compare or
# min/max as 1: the six plane distances (b - o) * (1/d), 6 subtractions and
# 6 multiplies; their 6 NaN tests; the entry and exit t, 10 min/max; the
# exit against the ray's limit, 1 min; 2 compares (31, the port's
# utils/roofline OPS["box"])
OPS_BOX = 6 + 6 + 6 + 10 + 1 + 2


def read(ctx):
    if ctx["entry"] != "progressive" or ctx["blocked"] or not ctx["casts"]:
        return None
    ms = readings.per_unit(ctx, readings.MC_KERNELS)
    raw = ctx["raw"]
    sph = program_spans.counter(ctx, "mc.sph_tests")
    cone = program_spans.counter(ctx, "mc.cone_tests") if raw.n_cone else 0
    if ms is None or sph is None or cone is None:
        return None
    box = program_spans.counter(ctx, "mc.sph_box_tests") or 0
    ops = (sph * readings.OPS_SPHERE + box * OPS_BOX + cone * readings.OPS_CONE
           + ctx["casts"] * raw.n_tri * readings.OPS_TRI_BEGUN) / ctx["units"]
    least_ms = max(readings.mc_least_ms(dict(ctx, casts=0)), ops / readings.PEAK_FP32 * 1e3)
    return 100.0 * least_ms / ms
