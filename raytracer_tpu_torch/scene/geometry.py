"""Procedural solids: the demo's dodecahedron.

Counterpart of raytracer_tpu/scene/geometry.py (same vertices, same face
rings, same fan triangulation).  Vertices {(±1,±1,±1), (0,±φ,±1/φ),
(±1/φ,0,±φ), (±φ,±1/φ,0)} / √3; every pentagon is planar and the renderer
uses flat winding normals (src/main.rs:730-739).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from raytracer_tpu_torch.scene.builder import Vertex, triangle

PHI = (1.0 + np.sqrt(5.0)) / 2.0


def dodecahedron_vertices() -> np.ndarray:
    """[20, 3] vertices of a regular dodecahedron with circumradius 1."""
    verts = [(sx, sy, sz) for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    # edge-vertex family in the chirality of the reference asset
    for s1 in (-1, 1):
        for s2 in (-1, 1):
            verts.append((0.0, s1 * PHI, s2 / PHI))
            verts.append((s1 / PHI, 0.0, s2 * PHI))
            verts.append((s1 * PHI, s2 / PHI, 0.0))
    v = np.asarray(verts, dtype=np.float64)
    return (v / np.sqrt(3.0)).astype(np.float32)


def dodecahedron_faces() -> List[List[int]]:
    """12 pentagons as vertex-index rings, wound outward."""
    v = dodecahedron_vertices().astype(np.float64)
    dirs = []
    for s1 in (-1, 1):
        for s2 in (-1, 1):
            dirs.append((0.0, s1, s2 * PHI))
            dirs.append((s1, s2 * PHI, 0.0))
            dirs.append((s1 * PHI, 0.0, s2))
    faces = []
    for u in np.asarray(dirs, dtype=np.float64):
        u = u / np.linalg.norm(u)
        idx = np.argsort(-(v @ u))[:5]
        center = v[idx].mean(axis=0)
        e1 = v[idx[0]] - center
        e1 -= u * (e1 @ u)
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(u, e1)
        ang = np.arctan2((v[idx] - center) @ e2, (v[idx] - center) @ e1)
        faces.append([int(i) for i in idx[np.argsort(ang)]])
    return faces


def dodecahedron_triangles(
    transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> List[List[Vertex]]:
    """Fan-triangulated dodecahedron with flat winding normals, uv=(0,0)."""
    v = dodecahedron_vertices()
    tris: List[List[Vertex]] = []
    for ring in dodecahedron_faces():
        for k in range(1, 4):
            pts = []
            for i in (ring[0], ring[k], ring[k + 1]):
                p = v[i] if transform is None else np.asarray(transform(v[i]), np.float32)
                pts.append((p, (0.0, 0.0)))
            tris.append(triangle(pts))
    return tris


def write_dodecahedron_obj(path: str) -> None:
    """Write the generated solid as an OBJ file (for the loader path): its
    vertices, then each pentagon's fan as triangles."""
    v = dodecahedron_vertices()
    lines = ["# generated regular dodecahedron (circumradius 1)", "g dodecahedron"]
    for p in v:
        lines.append(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}")
    for ring in dodecahedron_faces():
        for k in range(1, 4):
            lines.append(f"f {ring[0] + 1} {ring[k] + 1} {ring[k + 1] + 1}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
