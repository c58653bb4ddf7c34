"""The H100 roofline: the least time the card could take for a kernel call.

A call's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over the card's memory rate,
and the FP32 operations its lanes' tests need over the card's FP32 peak
outside the tensor cores.  Both rates are the H100 SXM data sheet's, at
its 700 W power limit; a card set below it runs slower, so a share of
this bound is stated with the card's power limit beside it.

Counterpart of raytracer_tpu/utils/roofline.py, which models another chip;
none of its constants apply here.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12  # B/s, HBM3
PEAK_FP32 = 67e12  # FLOP/s, FP32 (non-tensor)

# FP32 operations charged to each kind of test that the kernels' counting
# instantiations count per lane (kernels.WORK_ROWS, csrc/common.cuh
# `Work`), an FMA as 2 and a division, square root, compare or min/max as
# 1: a triangle test begun is a dot product and a compare (6); going on to
# the plane's t adds a dot product, a subtraction, a division and three
# compares (10); an edge test is two dot products, two adds, a multiply and a
# compare (14); a sphere test a difference, a cross product, two dot
# products, a square root and compares (30); a slab test 6 subtractions, 6
# multiplies, 6 NaN tests, 11 min/max and 2 compares (31).  Shading,
# sampling and the march's refractions are not counted, so the operation
# bound is low.  The other rows of a `work` output are charged nothing:
# the chunks a lane's rays entered, the chunks its warp staged, two clock
# readings and the cycle counts.
OPS = {"tri": 6, "plane": 10, "edge": 14, "sph": 30, "box": 31}


def bound(in_out_bytes, work):
    """(bound_ms, bound_by, FP32 operations) of a call from the bytes it
    must move and the tests its lanes ran (work: [len(WORK_ROWS), n]
    counts, or anything whose rows sum likewise)."""
    from raytracer_tpu_torch.utils.kernels import WORK_ROWS

    ops = sum(int(work[i].sum()) * OPS[k] for i, k in enumerate(WORK_ROWS) if k in OPS)
    t_bytes = in_out_bytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), ops
