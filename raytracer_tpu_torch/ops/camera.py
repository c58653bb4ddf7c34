"""Batched pinhole / thin-lens camera.

Counterpart of raytracer_tpu/ops/camera.py (Camera::shoot / shoot_focus,
src/main.rs:84-127).  Clip convention (src/main.rs:1094-1095): clip_y =
(H/2 - y)/H, clip_x = (x - W/2)/H.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.scene.types import Camera
from raytracer_tpu_torch.utils import vec


def _basis(camera: Camera):
    toward = vec.normalize(camera.toward[None, :])[0]
    right = vec.normalize(torch.linalg.cross(toward, camera.up)[None, :])[0]
    up = vec.normalize(torch.linalg.cross(right, toward)[None, :])[0]
    return toward, right * camera.scale, up * camera.scale  # toward, x, y (main.rs:85-90)


def shoot(camera: Camera, clip):
    """clip [N, 2] -> (origin [N, 3], direction [N, 3]); origin = center +
    toward * near (src/main.rs:92)."""
    toward, x, y = _basis(camera)
    d = clip[:, 0:1] * x[None, :] + clip[:, 1:2] * y[None, :] + toward[None, :]
    d = vec.normalize(d)
    origin = camera.center + toward * camera.near
    return origin[None, :].expand(d.shape), d


def shoot_focus(camera: Camera, clip, lens_offsets, focus: float):
    """Thin-lens depth-of-field rays (src/main.rs:101-127).

    lens_offsets [N, 2]: Gaussian samples already scaled by `blur`.  Keeps
    the focal point at distance `focus` while displacing the origin by
    -(x*dx + y*dy)."""
    toward, x, y = _basis(camera)
    d = clip[:, 0:1] * x[None, :] + clip[:, 1:2] * y[None, :] + toward[None, :]
    d = vec.normalize(d)
    xoff = lens_offsets[:, 0:1]
    yoff = lens_offsets[:, 1:2]
    d_focus = vec.normalize(d * focus + x[None, :] * xoff + y[None, :] * yoff)
    origin = camera.center + toward * camera.near
    o = origin[None, :] - (x[None, :] * xoff + y[None, :] * yoff)
    return o, d_focus
