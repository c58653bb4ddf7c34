"""What the per-layer readers in benchmark/metrics/ share: device time of
named operations per unit, and the H100's roofline yardstick."""

from __future__ import annotations

# H100 SXM data sheet, at its 700 W power limit (a card set below it runs
# slower: a share of these is stated beside the card's power limit)
PEAK_BYTES = 3.35e12  # B/s, HBM3
PEAK_FP32 = 67e12  # FLOP/s, FP32 outside the tensor cores
# FP32 operations a test needs, an FMA as 2 and a division, square root,
# compare or min/max as 1 (the port's utils/roofline.OPS, frozen here): a
# triangle test begun is a dot product and a compare; a sphere test a
# difference, a cross product, two dot products, a square root and compares
OPS_TRI_BEGUN = 6
OPS_SPHERE = 30
# a cone test (benchmark/reference/world.py `_cone`, its axis, slope and
# slope squared kept per cone): the difference w (3), w.a and d.a (10), the
# radial parts (12), their three dot products (15), the quadratic's three
# coefficients (10), its discriminant, compare, square root and two roots
# (9), and a root's height, radius, face (d.n's sign) and four compares
# against t > 0, 0 <= h <= L and the best (14 each, 28); the nearer root (1)
OPS_CONE = 88
CONE_FLOATS = 8  # base, base radius, apex, apex radius
F32 = 4
MC_KERNELS = ("mc_kernel",)  # csrc/mc_kernel.cu: mc_kernel_staged (dense), mc_kernel<CoopGeom> (blocked)
NCCL_KERNELS = ("ncclDevKernel", "ncclKernel")  # NCCL's kernels, by its versions' names


def device_ms(summary: dict, names) -> float:
    """Device ms of the operations whose name holds one of `names`."""
    return sum(us for op, us in summary["op_us"].items() if any(n in op for n in names)) / 1e3


def per_unit(ctx, names, summary=None):
    """Device ms a unit of those operations in `summary` (default: the
    run's trace; None when it holds none of them)."""
    ms = device_ms(ctx["trace"] if summary is None else summary, names)
    return ms / ctx["units"] if ms else None


def own_ms(summary: dict) -> float:
    """Device ms of every operation but the NCCL kernels, whose time holds
    a rank's wait for its peers."""
    return sum(summary["op_us"].values()) / 1e3 - device_ms(summary, NCCL_KERNELS)


def rank_traces(ctx) -> list:
    """Each rank's trace summary of a traced run on several cards ([] on
    one card, or untraced)."""
    return [r["trace"] for r in ctx.get("ranks") or [] if r["trace"] is not None]


def pacing(ctx) -> dict:
    """The trace summary that the device readers of a progressive cell
    read: on several cards the rank with the most own device time, which
    the others wait for in the all-reduce and which so paces the epoch;
    on one card the run's."""
    traces = rank_traces(ctx)
    return max(traces, key=own_ms) if traces else ctx["trace"]


def mc_least_ms(ctx) -> float:
    """The least time the H100 could take for one epoch's MC walk of a
    dense scene, the work counted as the reference algorithm does it
    (main.rs:180-326 casts every ray against every object): the larger of
    bytes / PEAK_BYTES (the draws read once, the photons written once,
    the scene's primitives read once) and operations / PEAK_FP32 (the
    epoch's casts x each triangle's test begun, each sphere's test and
    each cone's test)."""
    cfg, raw = ctx["cfg"], ctx["raw"]
    n = cfg.width * cfg.height
    tile = min(cfg.tile_rays, n)
    lanes = -(-n // tile) * tile
    draws = lanes * (2 + 3 * cfg.depth) * F32
    photons = n * 3 * F32
    scene = (raw.n_tri * (9 + 9 + 6 + 1) * F32 + raw.n_sph * 5 * F32
             + raw.n_cone * CONE_FLOATS * F32)
    casts = ctx["casts"] / ctx["units"]
    ops = casts * (raw.n_tri * OPS_TRI_BEGUN + raw.n_sph * OPS_SPHERE + raw.n_cone * OPS_CONE)
    return max((draws + photons + scene) / PEAK_BYTES, ops / PEAK_FP32) * 1e3
