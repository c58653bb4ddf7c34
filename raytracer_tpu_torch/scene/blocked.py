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
"""

from __future__ import annotations

import numpy as np

# Triangles per gated chunk (raytracer_tpu/scene/blocked.py:34).
BLK_CHUNK = 128
# Chunks per supergroup: one outer box gates 8 chunks (1024 triangles).
SUP_CHUNKS = 8


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
