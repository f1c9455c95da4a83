"""Kernel K4: the triangle z-buffer (``csrc/raster_zbuffer.cu``) with its
plain PyTorch version beside it.

K4 replaces ``linemod_pose_estimation_tpu/ops/pallas_raster.py::
raster_zbuffer_pallas``.  What both compute is the reference's XLA scan
(``models/renderer.py::render``): per pixel centre, the nearest covered
triangle's perspective-correct depth (inf = miss) and its flat shade.
The TPU kernel's (triangle, 128-lane tile) entry table, 16-row stripes
and VMEM-resident buffers are Mosaic layout devices and are not carried
over.

Split of the work:

- ``triangle_coefficients`` (plain PyTorch, shared by the kernel and the
  plain version): projected vertices, 1/z per vertex, the guarded area,
  the grown-edge thresholds, the grown bbox, the z range, the shade and
  the live flag per triangle — the reference's per-triangle f32
  expressions, computed once.
- the per-pixel part (edge functions, coverage, barycentric 1/z, the
  clamp and the z test) runs in the kernel, or in ``raster_zbuffer_plain``
  as the reference's 64-triangle chunk scan.

Both keep the FIRST triangle in index order that reaches a pixel's
minimum depth (the kernel: the smallest (depth, index) pair, since a
tile's list comes in no fixed order; the scan: argmin within a chunk,
strict ``<`` across chunks), so depth and shade are
bitwise equal between them, on every pixel and on exact depth ties.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import torch

from ..utils import tracing
from . import _build

# Column layout of the per-triangle coefficient table (csrc/raster_zbuffer.cu
# reads the same order).
COEFS = ("ux0", "uy0", "ux1", "uy1", "ux2", "uy2", "iz0", "iz1", "iz2", "area",
         "gl0", "gl1", "gl2", "xmin", "xmax", "ymin", "ymax", "ztmin", "ztmax",
         "shade", "live")
NCOEF = len(COEFS)
CHUNK = 64  # the reference scan's triangle chunk
TILE = 16  # K4's pixel tile (csrc/raster_zbuffer.cu)
BIN_CAP = 256  # triangle indices K4's list of one tile holds (its CAP)


def _hypot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.hypot's formula: max * sqrt(1 + (min / max)^2)."""
    a, b = a.abs(), b.abs()
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    safe = torch.where(hi == 0, torch.ones_like(hi), hi)
    r = lo / safe
    x = torch.where(hi == 0, hi, hi * torch.sqrt(1 + r * r))
    return torch.where(torch.isposinf(a) | torch.isposinf(b), torch.inf, x)


def triangle_coefficients(triangles: torch.Tensor, R: torch.Tensor,
                          T: torch.Tensor, K: torch.Tensor,
                          coverage_grow: float = 0.5) -> torch.Tensor:
    """Per-pose, per-triangle raster coefficients (P, Tn, NCOEF) f32.

    triangles (Tn, 3, 3) object-space; R (P, 3, 3) object->camera; T
    (P, 3) (the bank's T: X_cam = R (X + T)); K (P, 3, 3).  The same f32
    expressions as the reference's scan (``models/renderer.py:96-108,
    128-147``)."""
    tri = triangles.to(torch.float32)
    v_cam = (tri[None] + T[:, None, None, :]) @ R.transpose(-1, -2)[:, None]
    z = v_cam[..., 2]  # (P, Tn, 3)
    k = lambda i, j: K[:, i, j][:, None, None]
    zs = z.clamp(min=1e-9)
    u = k(0, 0) * v_cam[..., 0] / zs + k(0, 2)
    v = k(1, 1) * v_cam[..., 1] / zs + k(1, 2)
    behind = (z <= 1e-6).any(dim=-1)
    e1 = v_cam[:, :, 1] - v_cam[:, :, 0]
    e2 = v_cam[:, :, 2] - v_cam[:, :, 0]
    n = torch.linalg.cross(e1, e2)
    nrm = torch.sqrt((n * n).sum(dim=-1, keepdim=True))
    shade = (n / nrm.clamp(min=1e-12))[..., 2].abs()

    x0, y0, x1, y1, x2, y2 = (u[..., 0], v[..., 0], u[..., 1], v[..., 1],
                              u[..., 2], v[..., 2])
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    big = area.abs() > 1e-12
    a = torch.where(big, area, 1.0)
    iz = torch.ones_like(z) / zs  # 1 / max(z, 1e-9), an IEEE division
    g = coverage_grow
    gl0 = g * _hypot(x2 - x1, y2 - y1)
    gl1 = g * _hypot(x0 - x2, y0 - y2)
    gl2 = g * _hypot(x1 - x0, y1 - y0)
    xmin = torch.minimum(torch.minimum(x0, x1), x2) - g
    xmax = torch.maximum(torch.maximum(x0, x1), x2) + g
    ymin = torch.minimum(torch.minimum(y0, y1), y2) - g
    ymax = torch.maximum(torch.maximum(y0, y1), y2) + g
    live = (big & ~behind).to(torch.float32)
    cols = (x0, y0, x1, y1, x2, y2, iz[..., 0], iz[..., 1], iz[..., 2], a,
            gl0, gl1, gl2, xmin, xmax, ymin, ymax, z.amin(dim=-1),
            z.amax(dim=-1), shade, live)
    return torch.stack(cols, dim=-1).contiguous()


def _pixel_depth(c: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Per-pixel depth of every triangle of a chunk: c (n, NCOEF) ->
    (n, H, W), inf where the triangle does not cover the pixel centre —
    the reference scan's per-pixel expressions, in its operation order."""
    col = lambda name: c[:, COEFS.index(name), None, None]
    ux0, uy0, ux1, uy1, ux2, uy2 = (col(s) for s in COEFS[:6])
    w0 = (ux2 - ux1) * (py - uy1) - (uy2 - uy1) * (px - ux1)
    w1 = (ux0 - ux2) * (py - uy2) - (uy0 - uy2) * (px - ux2)
    w2 = (ux1 - ux0) * (py - uy0) - (uy1 - uy0) * (px - ux0)
    gl0, gl1, gl2 = col("gl0"), col("gl1"), col("gl2")
    pos = (w0 >= -gl0) & (w1 >= -gl1) & (w2 >= -gl2)
    neg = (w0 <= gl0) & (w1 <= gl1) & (w2 <= gl2)
    inb = ((px >= col("xmin")) & (px <= col("xmax"))
           & (py >= col("ymin")) & (py <= col("ymax")))
    a = col("area")
    inv_z = (w0 / a) * col("iz0") + (w1 / a) * col("iz1") + (w2 / a) * col("iz2")
    zpix = torch.ones_like(inv_z) / inv_z.clamp(min=1e-9)
    zpix = torch.minimum(torch.maximum(zpix, col("ztmin")), col("ztmax"))
    hit = (pos | neg) & inb & (col("live") > 0.5) & (inv_z > 1e-9)
    return torch.where(hit, zpix, torch.inf)


def raster_zbuffer_plain(coefs: torch.Tensor, width: int, height: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's scan: 64-triangle chunks, argmin within a chunk
    (first index on ties), strict < across chunks.  coefs (P, Tn, NCOEF)
    -> (zbuf, sbuf) (P, H, W) f32, zbuf inf where nothing covers."""
    P, Tn, _ = coefs.shape
    dev = coefs.device
    px = torch.arange(width, dtype=torch.float32, device=dev)[None, :] + 0.5
    py = torch.arange(height, dtype=torch.float32, device=dev)[:, None] + 0.5
    zbufs, sbufs = [], []
    for p in range(P):  # one pose at a time bounds the (chunk, H, W) memory
        zbuf = torch.full((height, width), torch.inf, device=dev)
        sbuf = torch.zeros((height, width), device=dev)
        for s in range(0, Tn, CHUNK):
            c = coefs[p, s:s + CHUNK]
            zpix = _pixel_depth(c, px, py)
            best = zpix.argmin(dim=0)
            zmin = torch.gather(zpix, 0, best[None])[0]
            smin = c[:, COEFS.index("shade")][best]
            closer = zmin < zbuf
            zbuf = torch.where(closer, zmin, zbuf)
            sbuf = torch.where(closer, smin, sbuf)
        zbufs.append(zbuf)
        sbufs.append(sbuf)
    return torch.stack(zbufs), torch.stack(sbufs)


def raster_zbuffer(coefs: torch.Tensor, width: int, height: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4: the triangles are binned to 16 x 16 pixel tiles; then one block
    per tile of one pose takes its tile's list (or, past BIN_CAP
    triangles, every triangle culled in parallel), a warp per triangle
    over the triangle's pixels, and keeps each pixel's smallest (depth,
    index).  coefs (P, Tn, NCOEF) f32 -> (zbuf, sbuf) (P, H, W) f32,
    bitwise equal to raster_zbuffer_plain."""
    if coefs.device.type == "cpu":
        return raster_zbuffer_plain(coefs, width, height)
    if coefs.dim() != 3 or coefs.shape[-1] != NCOEF:
        raise ValueError(f"coefs: expected (P, Tn, {NCOEF}), got {tuple(coefs.shape)}")
    _build.require(coefs, "coefs", torch.float32)
    P, Tn, _ = coefs.shape
    dev = coefs.device
    zbuf = torch.empty((P, height, width), dtype=torch.float32, device=dev)
    sbuf = torch.empty_like(zbuf)
    if zbuf.numel() == 0:
        return zbuf, sbuf
    tiles = P * -(-height // TILE) * -(-width // TILE)
    # per tile: a counter and a list of BIN_CAP triangle indices
    scratch = torch.empty(tiles * (BIN_CAP + 1), dtype=torch.int32, device=dev)
    lib = _build.library()
    err = lib.lpe_raster_zbuffer(coefs.data_ptr(), zbuf.data_ptr(), sbuf.data_ptr(),
                                 scratch.data_ptr(), P, Tn, height, width,
                                 *_build.device_and_stream(coefs))
    _build.check(err, "raster_zbuffer")
    tracing.count("launch.raster_zbuffer")
    return zbuf, sbuf
