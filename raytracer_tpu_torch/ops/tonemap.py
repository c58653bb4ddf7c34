"""Percentile tone normalization (counterpart of raytracer_tpu/ops/tonemap.py).

post_process (src/main.rs:748-762): per-pixel luma, drop values failing
f32::is_normal(), sort ascending, take the value at index
floor(0.99 * count), and divide the whole buffer by it when it exceeds f32
EPSILON.  The reference runs this on the ACCUMULATED buffer after every
epoch (parallel/progressive.py does the same).
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.utils import color, tracing, vec


def luma_percentile_scale(img_flat, percentile: float = 0.99):
    """[N, 3] linear RGB -> (divisor, valid_count) as 0-d tensors.

    The host waits on the card twice here: color.luma copies its weights
    from the host, a blocking copy that drains the card's queue (the
    epoch's walk), and indexing reads the index on the host.  Inside a
    recorded epoch each wait is a `rt.step.wait` span."""
    with tracing.span("rt.step.wait"):
        lum = color.luma(img_flat)
    valid = vec.is_normal_f32(lum)
    count = valid.to(torch.int32).sum()
    sorted_l = torch.sort(torch.where(valid, lum, torch.inf)).values
    idx = (count.to(torch.float32) * percentile).to(torch.int64)  # trunc
    idx = idx.clamp(0, lum.shape[0] - 1)
    with tracing.span("rt.step.wait"):
        i = int(idx)
    return sorted_l[i], count


def post_process(img, percentile: float = 0.99):
    """Normalize a [..., 3] linear image exactly like the reference."""
    p98, count = luma_percentile_scale(img.reshape(-1, 3), percentile)
    do = (p98 > vec.F32_EPS) & (count > 0)
    return img * torch.where(do, 1.0 / p98, 1.0)
