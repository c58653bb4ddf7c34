"""Blocked triangle layout for large meshes (numpy only).

A copy of raytracer_tpu/scene/blocked.py (`build_blocked` :44,
`validate_blocked` :84): the BVH's depth-first leaf order (scene/bvh.py)
cut into chunks of BLK_CHUNK triangles, each with an AABB, and chunks
grouped SUP_CHUNKS at a time into supergroups.  The kernels
(csrc/common.cuh) and their plain versions (ops/kernel_common.py) test a
supergroup's box, then each of its chunks' boxes, and the chunk's
triangles only where the lane's ray enters the box before its current
best hit.

On the GPU the permuted table stays in global memory at every size, so
the TPU's HBM streaming above STREAM_BLK_TRIS has no counterpart here.

The port's own: the same two gate tiers over a scene's spheres
(`build_sph_chunks`), for the MC walk's dense routes on scenes of many
spheres (the SPD sphereflake's 7,381), which the JAX package sweeps
linearly.
"""

from __future__ import annotations

import numpy as np

# Triangles per gated chunk (raytracer_tpu/scene/blocked.py:34).
BLK_CHUNK = 128
# Chunks per supergroup: one outer box gates 8 chunks (1024 triangles).
SUP_CHUNKS = 8

# Spheres per gated chunk, and chunks per supergroup (csrc/common.cuh
# SPH_CHUNK, SPH_SUP).  A dense scene of more than SPH_CHUNK spheres carries
# the sphere chunk table.
SPH_CHUNK = 16
SPH_SUP = 8
# The gate's slack (csrc/common.cuh SPH_PAD): a box is widened by SPH_PAD
# times the largest coordinate magnitude the sphere test meets, here the
# scene's spheres' (every box, at build time) and in the kernels the ray
# origin's (every ray, as it sweeps), so that no ray the f32 sphere test
# accepts, grazing ones included, misses the f32 box test of its chunk.
# Both tests round in units of 2^-24 of those magnitudes, some tens of
# units a test; 2^-15 is 512 units.
SPH_PAD = 2.0 ** -15


def build_blocked(tri_v: np.ndarray, prim_order: np.ndarray):
    """Blocked tables from triangle vertices + BVH DFS leaf order.

    Returns (perm [T_pad] i32, boxes [NCH, 8] f32):
      perm[i]  = original triangle id of blocked row i (-1 = padding)
      boxes[c] = chunk AABB: min xyz (0:3), max xyz (3:6), pad (6:8)
    T_pad = NCH * BLK_CHUNK, NCH a multiple of SUP_CHUNKS; chunks past the
    last triangle carry inverted boxes (min +3e38, max -3e38).
    """
    prim_order = np.asarray(prim_order, np.int32)
    t = prim_order.shape[0]
    nch = -(-max(1, -(-t // BLK_CHUNK)) // SUP_CHUNKS) * SUP_CHUNKS
    t_pad = nch * BLK_CHUNK
    perm = np.full(t_pad, -1, np.int32)
    perm[:t] = prim_order

    lo_all = np.asarray(tri_v, np.float64).min(axis=1)  # [T, 3]
    hi_all = np.asarray(tri_v, np.float64).max(axis=1)
    boxes = np.zeros((nch, 8), np.float32)
    big = np.float32(3.0e38)
    for c in range(nch):
        ids = prim_order[c * BLK_CHUNK : (c + 1) * BLK_CHUNK]
        if ids.size == 0:
            boxes[c, 0:3] = big
            boxes[c, 3:6] = -big
            continue
        # Round outward when narrowing f64 bounds to f32, so the f32 slab
        # test never skips a chunk that holds a razor-edge hit.
        lo32 = lo_all[ids].min(axis=0).astype(np.float32)
        hi32 = hi_all[ids].max(axis=0).astype(np.float32)
        boxes[c, 0:3] = np.nextafter(lo32, np.float32(-np.inf), dtype=np.float32)
        boxes[c, 3:6] = np.nextafter(hi32, np.float32(np.inf), dtype=np.float32)
    return perm, boxes


def validate_blocked(perm: np.ndarray, boxes: np.ndarray,
                     tri_v: np.ndarray) -> None:
    """Invariants (used by tests): permutation coverage + exact f32
    containment of every triangle in its chunk's box."""
    t = tri_v.shape[0]
    live = perm[perm >= 0]
    assert np.array_equal(np.sort(live), np.arange(t)), "perm covers all tris"
    assert perm.shape[0] % BLK_CHUNK == 0
    assert boxes.shape == (perm.shape[0] // BLK_CHUNK, 8)
    assert boxes.shape[0] % SUP_CHUNKS == 0
    lo = tri_v.astype(np.float32).min(axis=1)
    hi = tri_v.astype(np.float32).max(axis=1)
    for c in range(boxes.shape[0]):
        ids = perm[c * BLK_CHUNK : (c + 1) * BLK_CHUNK]
        ids = ids[ids >= 0]
        if ids.size:
            assert (lo[ids] >= boxes[c, 0:3]).all()
            assert (hi[ids] <= boxes[c, 3:6]).all()


def build_sph_chunks(sph_c: np.ndarray, sph_r: np.ndarray):
    """The sphere chunk table from sphere centres [S, 3] and radii [S].

    Returns (perm [S_pad] i32, boxes [NCH, 8] f32):
      perm[i]  = original sphere index of chunk row i (-1 = padding), in the
                 depth-first leaf order of a median-split BVH over the
                 spheres (`_sph_order`)
      boxes[c] = chunk AABB: min xyz (0:3), max xyz (3:6), pad (6:8), each
                 sphere's c +- r widened by SPH_PAD times the largest
                 |coordinate| + radius of any sphere, then rounded outward
                 to f32 and moved one more f32 step out, as build_blocked
    NCH = ceil(S / SPH_CHUNK), S_pad = NCH * SPH_CHUNK: every chunk holds a
    sphere; pad rows trail the last one.  Supergroups of SPH_SUP chunks
    take the union of their boxes (ops/kernel_common.pack_sph_chunks)."""
    c = np.asarray(sph_c, np.float32).astype(np.float64)
    r = np.asarray(sph_r, np.float32).astype(np.float64)[:, None]
    s = c.shape[0]
    reach = float((np.abs(c) + r).max(initial=0.0))
    lo, hi = c - r, c + r
    order = _sph_order(c, np.arange(s))
    nch = -(-s // SPH_CHUNK)
    perm = np.full(nch * SPH_CHUNK, -1, np.int32)
    perm[:s] = order
    pad = SPH_PAD * reach
    boxes = np.zeros((nch, 8), np.float32)
    for k in range(nch):
        ids = order[k * SPH_CHUNK:(k + 1) * SPH_CHUNK]
        lo32 = (lo[ids].min(axis=0) - pad).astype(np.float32)
        hi32 = (hi[ids].max(axis=0) + pad).astype(np.float32)
        boxes[k, 0:3] = np.nextafter(lo32, np.float32(-np.inf), dtype=np.float32)
        boxes[k, 3:6] = np.nextafter(hi32, np.float32(np.inf), dtype=np.float32)
    return perm, boxes


def _sph_order(centers: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """build_bvh's depth-first leaf order over spheres `ids` (a median split
    of their centres on the widest axis), but with every split on a multiple
    of SPH_CHUNK * SPH_SUP spheres, below that of SPH_CHUNK: so each chunk
    is one leaf and each supergroup one subtree.  (build_bvh's order cut
    into chunks joins neighbouring leaves of distant subtrees: on the
    sphereflake, chunk boxes up to 1.07 across, their median 0.18, and
    twice the sphere tests a cast.)"""
    n = ids.shape[0]
    if n <= SPH_CHUNK:
        return ids
    unit = SPH_CHUNK * SPH_SUP if n > SPH_CHUNK * SPH_SUP else SPH_CHUNK
    c = centers[ids]
    axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
    order = ids[np.argsort(c[:, axis], kind="stable")]
    half = -(-(-(-n // unit)) // 2) * unit  # the units' first half, rounded up
    return np.concatenate([_sph_order(centers, order[:half]),
                           _sph_order(centers, order[half:])])


def validate_sph_chunks(perm: np.ndarray, boxes: np.ndarray, sph_c: np.ndarray,
                        sph_r: np.ndarray) -> None:
    """Invariants (used by tests): every sphere in exactly one chunk row,
    pad rows trailing, and every sphere's f32 c +- r inside its chunk's f32
    box."""
    s = sph_c.shape[0]
    live = perm[perm >= 0]
    assert np.array_equal(np.sort(live), np.arange(s)), "perm covers all spheres"
    assert perm.shape == (boxes.shape[0] * SPH_CHUNK,) and (perm[s:] == -1).all()
    c = np.asarray(sph_c, np.float32)
    r = np.asarray(sph_r, np.float32)[:, None]
    for k in range(boxes.shape[0]):
        ids = perm[k * SPH_CHUNK:(k + 1) * SPH_CHUNK]
        ids = ids[ids >= 0]
        assert ids.size
        assert (c[ids] - r[ids] >= boxes[k, 0:3]).all()
        assert (c[ids] + r[ids] <= boxes[k, 3:6]).all()
