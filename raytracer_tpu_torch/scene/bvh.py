"""Host-built BVH over triangles, flattened into arrays (numpy only).

A copy of raytracer_tpu/scene/bvh.py (`build_bvh` :41, `validate_bvh`
:92), kept here so the port imports nothing of the JAX package: a median
split on the widest centroid axis, leaves of at most `leaf_size`
triangles.  The port uses its depth-first leaf order `prim_order` for the
blocked layout (scene/blocked.py); the node arrays ride the Scene so a
scene carries what the JAX package's does.

Layout (M nodes, depth-first preorder, root = 0):
  node_min/max [M, 3]  AABB
  node_right   [M]     index of the right child (the left child is
                       node+1); for leaves, the first index into
                       prim_order
  node_count   [M]     0 for inner nodes, the leaf's triangle count
                       otherwise
  prim_order   [T]     triangle ids grouped by leaf
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class FlatBVH:
    node_min: np.ndarray  # [M, 3] f32
    node_max: np.ndarray  # [M, 3] f32
    node_right: np.ndarray  # [M] i32
    node_count: np.ndarray  # [M] i32
    prim_order: np.ndarray  # [T] i32
    depth: int  # max tree depth (traversal stack bound)

    @property
    def n_nodes(self) -> int:
        return self.node_min.shape[0]


def build_bvh(tri_v: np.ndarray, leaf_size: int = 8) -> FlatBVH:
    """Median-split BVH over triangles ([T, 3, 3] vertex positions)."""
    tri_v = np.asarray(tri_v, np.float64)
    T = tri_v.shape[0]
    lo = tri_v.min(axis=1)  # [T, 3]
    hi = tri_v.max(axis=1)
    centroid = (lo + hi) * 0.5

    node_min, node_max, node_right, node_count = [], [], [], []
    prim_order: list = []

    def emit(ids: np.ndarray, depth: int) -> Tuple[int, int]:
        idx = len(node_min)
        node_min.append(lo[ids].min(axis=0))
        node_max.append(hi[ids].max(axis=0))
        node_right.append(0)
        node_count.append(0)
        if len(ids) <= leaf_size:
            node_right[idx] = len(prim_order)
            node_count[idx] = len(ids)
            prim_order.extend(int(i) for i in ids)
            return idx, depth
        c = centroid[ids]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = ids[np.argsort(c[:, axis], kind="stable")]
        half = len(order) // 2
        _, dl = emit(order[:half], depth + 1)
        right_idx, dr = emit(order[half:], depth + 1)
        node_right[idx] = right_idx
        return idx, max(dl, dr)

    if T == 0:
        return FlatBVH(
            node_min=np.zeros((1, 3), np.float32),
            node_max=np.zeros((1, 3), np.float32),
            node_right=np.zeros(1, np.int32),
            node_count=np.zeros(1, np.int32),
            prim_order=np.zeros(0, np.int32),
            depth=1,
        )
    _, depth = emit(np.arange(T), 1)
    return FlatBVH(
        node_min=np.asarray(node_min, np.float32),
        node_max=np.asarray(node_max, np.float32),
        node_right=np.asarray(node_right, np.int32),
        node_count=np.asarray(node_count, np.int32),
        prim_order=np.asarray(prim_order, np.int32),
        depth=depth,
    )


def validate_bvh(bvh: FlatBVH, tri_v: np.ndarray) -> None:
    """Structural invariants (used by tests): coverage and containment."""
    T = tri_v.shape[0]
    seen = np.sort(bvh.prim_order)
    assert np.array_equal(seen, np.arange(T)), "every triangle in exactly one leaf"
    lo = tri_v.min(axis=1)
    hi = tri_v.max(axis=1)

    def check(node):
        if bvh.node_count[node] > 0:
            ids = bvh.prim_order[
                bvh.node_right[node] : bvh.node_right[node] + bvh.node_count[node]
            ]
            assert (lo[ids] >= bvh.node_min[node] - 1e-4).all()
            assert (hi[ids] <= bvh.node_max[node] + 1e-4).all()
            return
        left, right = node + 1, int(bvh.node_right[node])
        for ch in (left, right):
            assert (bvh.node_min[ch] >= bvh.node_min[node] - 1e-4).all()
            assert (bvh.node_max[ch] <= bvh.node_max[node] + 1e-4).all()
            check(ch)

    check(0)
