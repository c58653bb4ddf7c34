"""Minimal Wavefront OBJ loader (counterpart of raytracer_tpu/utils/obj.py).

Like the reference's tobj usage (src/main.rs:778-807): only `v` and `f`
records are read, faces are fan-triangulated, and normals are rebuilt flat
from the winding with uv=(0,0).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from raytracer_tpu_torch.scene.builder import Vertex, triangle


def load_obj_triangles(
    path: str,
    transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> List[List[Vertex]]:
    """Parse an OBJ file into a list of flat-normal triangles."""
    positions: List[np.ndarray] = []
    faces: List[List[int]] = []
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "v":
                positions.append(np.asarray([float(x) for x in parts[1:4]], np.float32))
            elif parts[0] == "f":
                idx = []
                for token in parts[1:]:
                    # v, v/vt, v/vt/vn, v//vn all start with the position
                    # index; OBJ indices are 1-based, negatives relative
                    i = int(token.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(positions) + i)
                faces.append(idx)

    tris: List[List[Vertex]] = []
    for face in faces:
        for k in range(1, len(face) - 1):
            pts = []
            for i in (face[0], face[k], face[k + 1]):
                p = positions[i]
                if transform is not None:
                    p = np.asarray(transform(p), np.float32)
                pts.append((p, (0.0, 0.0)))
            tris.append(triangle(pts))
    return tris
