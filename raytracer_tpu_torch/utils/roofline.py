"""The H100 roofline: the least time the card could take for a kernel call.

A call's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over the card's memory rate,
and the FP32 operations its lanes' tests need over the card's FP32 peak
outside the tensor cores.  Both rates are the H100 SXM data sheet's, at
its 700 W power limit; a card set below it runs slower, so a share of
this bound is stated with the card's power limit beside it.

Counterpart of raytracer_tpu/utils/roofline.py, which models another chip;
none of its constants apply here.

The same module also carries the JAX package's cost model of a cast
(`Chip`, `dense_cast_ops`, `dense_attainable_casts`, the blocked chunk
costs), with the H100's rates in place of the TPU's: `H100.vpu_ops` is the
FP32 instruction rate with an FMA counted as ONE operation, as that model
counts it, so it is PEAK_FP32 / 2 (the data sheet's FLOP/s count an FMA
as two); `H100.hbm_bytes` is PEAK_BYTES.  Its per-lane operation counts
are the JAX model's, audited against the TPU sweeps, not against
csrc/common.cuh; `bound` below charges the kernels' own counted tests.
"""

from __future__ import annotations

from dataclasses import dataclass

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


# The JAX package's cost model of one cast (raytracer_tpu/utils/roofline.py:
# 51-100): model operations per (triangle row, ray lane) and (sphere row,
# ray lane) of a full sweep, an FMA as one, and per primitive for the
# winner's attributes.
OPS_PER_TRI_LANE = 62.0
OPS_PER_SPH_LANE = 30.0
OPS_WINNER_PER_PRIM_LANE = 4.0


@dataclass(frozen=True)
class Chip:
    name: str
    vpu_ops: float  # f32 elementwise operations/s (FMA = 1)
    hbm_bytes: float  # B/s


H100 = Chip(name="NVIDIA H100 SXM", vpu_ops=PEAK_FP32 / 2, hbm_bytes=PEAK_BYTES)


def dense_cast_ops(n_tri: int, n_sph: int) -> float:
    """Model operations per cast for the dense full-sweep table."""
    return (n_tri * (OPS_PER_TRI_LANE + OPS_WINNER_PER_PRIM_LANE)
            + n_sph * (OPS_PER_SPH_LANE + OPS_WINNER_PER_PRIM_LANE))


def dense_attainable_casts(n_tri: int, n_sph: int, chip: Chip = H100) -> float:
    """Attainable casts/s if the chip did nothing but sweep arithmetic."""
    return chip.vpu_ops / dense_cast_ops(n_tri, n_sph)


def blocked_chunk_body_seconds(lanes: int, chunk_rows: int = 128, chip: Chip = H100) -> float:
    """Model cost of ONE entered chunk body over `lanes` ray lanes."""
    return chunk_rows * lanes * OPS_PER_TRI_LANE / chip.vpu_ops


def blocked_stream_seconds(chip: Chip = H100, chunk_rows: int = 128,
                           cols_pad: int = 128) -> float:
    """Memory cost of streaming one chunk of chunk_rows x cols_pad f32
    (latency excluded)."""
    return chunk_rows * cols_pad * 4 / chip.hbm_bytes
