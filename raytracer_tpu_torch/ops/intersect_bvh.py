"""BVH traversal for large triangle meshes, in tensor operations.

Counterpart of raytracer_tpu/ops/intersect_bvh.py:61-149: scenes that carry
a BVH (scene/bvh.py) and take the unfused path find their nearest triangle
by a masked per-ray stack loop — every ray pops its own node, inner nodes
push their children, leaves run the reference triangle test on gathered
rows.  The JAX package has no Pallas kernel here, so this is plain PyTorch
on the scene's device (one host synchronisation per loop iteration, where
JAX runs a lax.while_loop).  Each iteration works on the lanes whose stack
is not empty yet, gathered by index: per lane the traversal is the JAX
one's, step for step.

Ties as World::cast: the reference scans triangles in index order updating
on t <= best, so equal t goes to the HIGHER index (src/main.rs:229-233);
the BVH visits in another order, so the update compares (t, index)
lexicographically.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.ops.kernel_common import BIG, _excl_crit
from raytracer_tpu_torch.scene.types import FACE_BACK, FACE_FRONT, Rays, Scene


def _leaf_test(rows, o, d, face, excl_prim, excl_face, tri_ids, live):
    """Reference triangle test on gathered rows.  rows: [M, L, 34] packed
    triangle rows (kernel_common.pack_tri) of tri_ids [M, L]; live: [M, L].
    Returns (t [M, L], BIG where no valid hit; backface [M, L])."""
    o, d = o[:, None, :], d[:, None, :]
    face = face[:, None]
    fn = rows[..., 0:3]
    no_d = torch.sum(fn * d, dim=-1)
    backface = no_d > 0.0
    cull = (backface & (face == FACE_FRONT)) | (~backface & (face == FACE_BACK))
    t = (rows[..., 3] - torch.sum(fn * o, dim=-1)) / no_d
    ok = t > 0.0
    for e in range(3):
        g = rows[..., 4 + 3 * e:7 + 3 * e]
        a = torch.sum(g * o, dim=-1) + rows[..., 13 + e] + t * torch.sum(g * d, dim=-1)
        ok = ok & (a >= 0.0)
    excl = (excl_prim[:, None] == tri_ids) & _excl_crit(excl_face[:, None], backface)
    valid = live & ~cull & ~excl & torch.isfinite(t) & ok
    return torch.where(valid, t, BIG), backface


def nearest_tri(scene: Scene, rays: Rays, active, leaf_size: int = 8):
    """Nearest triangle via BVH traversal -> (t [N], BIG on a miss; idx [N]
    int32 triangle index, -1; backface [N] bool)."""
    n, dev = rays.o.shape[0], rays.o.device
    stack_size = int(scene.bvh_depth) + 2
    tri = scene.tables.tri
    order = scene.bvh_prim_order.long()
    stack = torch.zeros((n, stack_size), dtype=torch.int64, device=dev)
    sp = active.to(torch.int64)  # the root (node 0) waits on every active stack
    best_t = torch.full((n,), BIG, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_bf = torch.zeros((n,), dtype=torch.bool, device=dev)
    slot = torch.arange(leaf_size, device=dev)[None, :]

    while True:
        lanes = torch.nonzero(sp > 0).squeeze(1)
        if lanes.numel() == 0:
            break
        top = sp[lanes] - 1
        node = stack[lanes, top]
        o, d = rays.o[lanes], rays.d[lanes]
        inv_d = 1.0 / d  # +-inf on zero components: the slab test still holds
        cur_t, cur_i = best_t[lanes], best_i[lanes]
        right = scene.bvh_node_right[node].long()
        count = scene.bvh_node_count[node].long()

        # slab test bounded by the current best hit
        t0 = (scene.bvh_node_min[node] - o) * inv_d
        t1 = (scene.bvh_node_max[node] - o) * inv_d
        t_near = torch.minimum(t0, t1).amax(dim=-1)
        t_far = torch.maximum(t0, t1).amin(dim=-1)
        hit_box = (t_near <= torch.minimum(t_far, cur_t)) & (t_far >= 0.0)
        is_leaf = count > 0

        # leaf: test up to leaf_size triangles
        tri_ids = order[(right[:, None] + slot).clamp(0, order.shape[0] - 1)]
        leaf_live = (hit_box & is_leaf)[:, None] & (slot < count[:, None])
        t_l, bf_l = _leaf_test(tri[tri_ids], o, d, rays.face[lanes], rays.excl_prim[lanes],
                               rays.excl_face[lanes], tri_ids, leaf_live)
        t_min = t_l.amin(dim=1)
        # lexicographic (t, index) update: the highest index among equal t
        cand_i = torch.where((t_l == t_min[:, None]) & leaf_live, tri_ids, -1).amax(dim=1)
        cand_bf = ((tri_ids == cand_i[:, None]) & leaf_live & bf_l).any(dim=1)
        better = ((t_min < cur_t) | ((t_min == cur_t) & (cand_i > cur_i))) & (t_min < BIG)
        best_t[lanes] = torch.where(better, t_min, cur_t)
        best_i[lanes] = torch.where(better, cand_i.to(torch.int32), cur_i)
        best_bf[lanes] = torch.where(better, cand_bf, best_bf[lanes])

        # inner: push the right child, then the left (it pops first)
        push = hit_box & ~is_leaf
        above = (top + 1).clamp(max=stack_size - 1)
        stack[lanes, top] = torch.where(push, right, node)
        stack[lanes, above] = torch.where(push, node + 1, stack[lanes, above])
        sp[lanes] = top + 2 * push.to(torch.int64)
    return best_t, best_i, best_bf


def tri_nearest_bvh(scene: Scene, rays: Rays, active, leaf_size: int = 8):
    """Nearest triangle via BVH traversal; needs the scene's bvh_* tensors.
    Returns (t [N], idx [N] triangle index, backface [N]); t is +inf on a
    miss."""
    t, idx, bf = nearest_tri(scene, rays, active, leaf_size)
    return torch.where(t < BIG, t, torch.inf), idx, bf
