"""The standalone interior-march kernel of the unfused path, and its plain
version.

Counterpart of raytracer_tpu/ops/march_pallas.py `march` (:291, kernel
`_march_kernel` :164): the whole total-internal-reflection march of
World::get_refract (src/main.rs:343-405) per ray, over a dense scene —
entry refraction, up to max_retries interior reflections under the
distance budget, exit refraction.  The CUDA kernel is csrc/march_kernel.cu
(`rt_march`); `march_plain` is ops/kernel_common.march_rows, the plain
block the fused kernels' plain versions march with.  The wrapper runs the
plain version on CPU tensors and launches the kernel on CUDA tensors, or
raises: there is no fallback.

A lane that never marched (not wanted, or trapped at entry) gives zeros in
every output, as a dead TPU tile does (march_pallas.py:186-190); a lane
that marched and did not escape holds its last interior state, which no
caller reads.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.ops import kernel_common as kc
from raytracer_tpu_torch.scene.types import Scene
from raytracer_tpu_torch.utils import kernels

COUNTS = kernels.LaunchCounts()


def march_plain(tb: kc.Tables, pos, normal, ray_d, k, want, max_distance: float,
                max_retries: int):
    """-> (escaped [N] bool, travel [N], esc_o [N, 3], esc_d [N, 3],
    esc_prim [N] int32, iters [N] int32: each lane's casts)."""
    cols = lambda x: (x[:, 0], x[:, 1], x[:, 2])
    mm = kc.march_rows(*cols(pos), *cols(normal), *cols(ray_d), k, want,
                       kc.DenseGeom(tb), max_distance, max_retries)
    marched = mm["iters"] > 0
    esc_o = torch.stack([mm["ex"], mm["ey"], mm["ez"]], dim=-1)
    esc_d = torch.stack([mm["odx"], mm["ody"], mm["odz"]], dim=-1)
    return (mm["escaped"], torch.where(marched, mm["travel"], 0.0),
            torch.where(marched[:, None], esc_o, 0.0),
            torch.where(marched[:, None], esc_d, 0.0),
            torch.where(marched, mm["prim"], 0), mm["iters"])


def march(scene: Scene, pos, normal, ray_d, prim, k, want, max_distance: float,
          max_retries: int, work=None):
    """Interior march over a ray batch of a dense scene -> (escaped [N]
    bool, travel [N], esc_o [N, 3], esc_d [N, 3], esc_prim [N] int32, casts
    0-d tensor).

    pos / normal / ray_d: the entry hit, its shading normal and the
    incoming direction, [N, 3]; k [N]: the refraction index; want [N] bool.
    `prim` (the entry primitive) is accepted for interface parity and
    unused: interior rays are Back-face rays, for which excluding the entry
    primitive's front is a no-op (march_pallas.py:297-300).  `work`: an
    optional int32 [len(kernels.WORK_ROWS), N] tensor that the kernel's
    counting instantiation fills with each lane's tests by kind."""
    del prim
    n, dev = pos.shape[0], pos.device
    if dev.type == "cpu":
        COUNTS.plain += 1
        *out, iters = march_plain(scene.tables, pos, normal, ray_d, k, want,
                                  max_distance, max_retries)
        return (*out, iters.sum())
    if dev.type != "cuda":
        raise ValueError(f"march_kernel.march: unsupported device {dev}")
    if scene.bvh_node_min is not None:
        raise ValueError("march_kernel.march takes dense scenes only")
    tb = scene.tables
    kc.check_tables(tb, dev)
    pos, normal, ray_d = pos.contiguous(), normal.contiguous(), ray_d.contiguous()
    k, want = k.contiguous(), want.contiguous()
    for name, x in (("pos", pos), ("normal", normal), ("ray_d", ray_d)):
        kernels.check(name, x, torch.float32, (n, 3), dev)
    kernels.check("k", k, torch.float32, (n,), dev)
    kernels.check("want", want, torch.bool, (n,), dev)
    kernels.check_work(work, n, dev)
    esc_o = torch.empty((n, 3), dtype=torch.float32, device=dev)
    esc_d = torch.empty((n, 3), dtype=torch.float32, device=dev)
    esc_prim = torch.empty((n,), dtype=torch.int32, device=dev)
    escaped = torch.empty((n,), dtype=torch.bool, device=dev)
    travel = torch.empty((n,), dtype=torch.float32, device=dev)
    iters = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        kernels.launch("rt_march", pos, normal, ray_d, k, want, tb.tri, tb.n_tri,
                       tb.sph, tb.n_sph, esc_o, esc_d, esc_prim, escaped, travel, iters,
                       work, n, float(max_distance), int(max_retries))
        COUNTS.launches += 1
    return escaped, travel, esc_o, esc_d, esc_prim, iters.sum()
