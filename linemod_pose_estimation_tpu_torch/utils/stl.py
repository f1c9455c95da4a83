"""STL mesh loading (ASCII and binary), host-side numpy — a copy of the
reference's `linemod_pose_estimation_tpu/utils/stl.py` (that package imports
jax at import time, so its numpy-only helpers are copied, not imported).

The reference consumes STL CAD models through ORK's Renderer3d (via assimp);
both shipped formats must parse: memoryChip2.stl is ASCII, boxNew.stl is
binary (SURVEY.md section 1 L4).  Output is a flat triangle soup suitable for
the rasterizer in models/renderer.py.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np


@dataclass
class Mesh:
    """Triangle soup: vertices (T, 3, 3) float32 (triangle, corner, xyz)."""

    triangles: np.ndarray  # (T, 3, 3)
    normals: np.ndarray  # (T, 3) facet normals (unit, recomputed)

    @property
    def num_triangles(self) -> int:
        return int(self.triangles.shape[0])

    def bounds(self) -> tuple[np.ndarray, np.ndarray]:
        pts = self.triangles.reshape(-1, 3)
        return pts.min(axis=0), pts.max(axis=0)

    def centroid(self) -> np.ndarray:
        return self.triangles.reshape(-1, 3).mean(axis=0)


def _recompute_normals(tris: np.ndarray) -> np.ndarray:
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    l = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(l, 1e-20)


def _load_ascii(text: str) -> np.ndarray:
    verts = re.findall(
        r"vertex\s+([-+0-9.eE]+)\s+([-+0-9.eE]+)\s+([-+0-9.eE]+)", text
    )
    arr = np.array(verts, dtype=np.float32)
    if arr.size == 0 or arr.shape[0] % 3 != 0:
        raise ValueError("malformed ASCII STL: vertex count not a multiple of 3")
    return arr.reshape(-1, 3, 3)


def _load_binary(data: bytes) -> np.ndarray:
    if len(data) < 84:
        raise ValueError("binary STL too short")
    n_tri = int(np.frombuffer(data[80:84], dtype="<u4")[0])
    expected = 84 + n_tri * 50
    if len(data) < expected:
        raise ValueError(f"binary STL truncated: need {expected} bytes, have {len(data)}")
    rec = np.frombuffer(data[84:expected], dtype=np.uint8).reshape(n_tri, 50)
    floats = rec[:, :48].copy().view("<f4").reshape(n_tri, 4, 3)
    return floats[:, 1:4, :].astype(np.float32)  # drop the facet normal


def load_stl(path: str) -> Mesh:
    """Load an STL file, auto-detecting ASCII vs binary."""
    with open(path, "rb") as f:
        data = f.read()
    # ASCII files start with "solid" AND actually contain facet/vertex text.
    is_ascii = False
    if data[:5].lower() == b"solid":
        head = data[:4096].decode("latin-1", errors="replace")
        if "facet" in head or "vertex" in head:
            is_ascii = True
    if is_ascii:
        tris = _load_ascii(data.decode("latin-1", errors="replace"))
    else:
        tris = _load_binary(data)
    return Mesh(triangles=tris, normals=_recompute_normals(tris))


def save_binary_stl(path: str, triangles: np.ndarray) -> None:
    """Write a triangle soup (T, 3, 3) as a binary STL (recomputed facet
    normals, a zero header, no attributes): what load_stl reads back."""
    tris = np.asarray(triangles, np.float32)
    rec = np.zeros((tris.shape[0], 50), np.uint8)
    floats = np.concatenate([_recompute_normals(tris)[:, None], tris], axis=1)
    rec[:, :48] = floats.astype("<f4").reshape(-1, 12).view(np.uint8)
    with open(path, "wb") as f:
        f.write(bytes(80) + np.uint32(tris.shape[0]).astype("<u4").tobytes() + rec.tobytes())
