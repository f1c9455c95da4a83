"""Frozen copy of ``linemod_pose_estimation_tpu_torch/models/renderer.py`` for the
benchmark's plain reference: plain PyTorch only, no hand-written kernel,
imported by nothing of the program, and never edited to follow it.

The original's docstring:

Triangle rasterizer for STL meshes — the port of
``linemod_pose_estimation_tpu/models/renderer.py``: depth (mm), binary
mask, flat-shaded RGB and the tight mask bbox of a mesh at a camera pose.

Conventions (the bank's): R is the object->camera rotation, T the bank's
T (X_cam = R (X + T)), OpenCV pixels with pixel centres at +0.5.
``render`` takes a batch of poses (the reference vmaps its single-pose
render): the per-triangle coefficients are computed once per pose in
PyTorch (``ops/raster.py::triangle_coefficients``), the z-buffer runs in
kernel K4 on a CUDA tensor and in the plain chunk scan on a CPU tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import raster


class RenderOutput(NamedTuple):
    depth_mm: torch.Tensor  # (..., H, W) float32 depth in millimetres, 0 = background
    mask: torch.Tensor  # (..., H, W) uint8 {0, 255}
    rgb: torch.Tensor  # (..., H, W, 3) uint8 flat-shaded
    rect: torch.Tensor  # (..., 4) int32 (x, y, w, h) tight mask bbox; zeros if empty


def _pad_triangles(tris: np.ndarray, chunk: int) -> np.ndarray:
    """Pad the triangle count to a multiple of `chunk` with degenerate
    far-away triangles (all three corners equal: zero area, never drawn)."""
    pad = (-tris.shape[0]) % chunk
    if pad:
        filler = np.full((pad, 3, 3), 1e5, dtype=np.float32)
        tris = np.concatenate([tris, filler], axis=0)
    return tris


def render(triangles: torch.Tensor, R: torch.Tensor, T_bank: torch.Tensor,
           K: torch.Tensor, width: int, height: int,
           coverage_grow: float = 0.5) -> RenderOutput:
    """Rasterize `triangles` (Tn, 3, 3) under poses R (P, 3, 3), T_bank
    (P, 3) and intrinsics K (P, 3, 3) — or one pose, without the leading
    P.  `coverage_grow` widens coverage by that many pixels of signed edge
    distance (the reference GL renderer's masks are ~1 px fatter per side
    than exact centre sampling)."""
    single = R.dim() == 2
    if single:
        R, T_bank, K = R[None], T_bank[None], K[None]
    coefs = raster.triangle_coefficients(triangles, R, T_bank, K, coverage_grow)
    zbuf, sbuf = raster.raster_zbuffer(coefs, width, height)
    out = _postprocess(zbuf, sbuf)
    return RenderOutput(*(a[0] for a in out)) if single else out


def _postprocess(zbuf: torch.Tensor, sbuf: torch.Tensor) -> RenderOutput:
    """z/shade buffers (..., H, W) -> depth_mm, mask, flat-shaded rgb,
    tight bbox."""
    H, W = zbuf.shape[-2:]
    dev = zbuf.device
    hit = torch.isfinite(zbuf)
    depth_mm = torch.where(hit, zbuf * 1000.0, 0.0)
    mask = hit.to(torch.uint8) * 255
    gray = (60.0 + 180.0 * sbuf).clamp(0, 255).to(torch.uint8)
    rgb = torch.where(hit, gray, 0)[..., None].expand(*hit.shape, 3).contiguous()
    cols = hit.any(dim=-2)
    rows = hit.any(dim=-1)
    ci = torch.arange(W, dtype=torch.int32, device=dev)
    ri = torch.arange(H, dtype=torch.int32, device=dev)
    x0 = torch.where(cols, ci, W).amin(dim=-1)
    x1 = torch.where(cols, ci, -1).amax(dim=-1)
    y0 = torch.where(rows, ri, H).amin(dim=-1)
    y1 = torch.where(rows, ri, -1).amax(dim=-1)
    rect = torch.stack([x0, y0, x1 - x0 + 1, y1 - y0 + 1], dim=-1)
    rect = torch.where(hit.flatten(-2).any(dim=-1)[..., None], rect, 0).to(torch.int32)
    return RenderOutput(depth_mm, mask, rgb, rect)
