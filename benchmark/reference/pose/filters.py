"""Frozen copy of ``linemod_pose_estimation_tpu_torch/ops/filters.py`` for the
benchmark's plain reference: plain PyTorch only, no hand-written kernel,
imported by nothing of the program, and never edited to follow it.

The original's docstring:

Aux image filters — the port of
``linemod_pose_estimation_tpu/ops/filters.py`` (SURVEY.md C24; dormant in
the original system, shipped by it):

- hsv_color_filter: the single-pixel HSV gate colorFilter2 (keep a
  hypothesis only if the scene pixel at its bbox centre lies in an HSV
  range);
- absolute_rectangle: the tight bbox of the thresholded foreground inside
  a ROI (calAbsoluteRectangle without contours);
- nms_distance: the inactive distance NMS over vote cells (C6), greedy in
  score order.
"""

from __future__ import annotations

import numpy as np
import torch

from .pointcloud import true_div


def rgb_to_hsv_u8(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 RGB -> OpenCV-style f32 HSV (H in [0, 180), S and V in
    [0, 255]).  The scaling by 1/255 is an IEEE division, and the hue's
    `% 6` a floor modulo (the sign of the divisor), as in the reference."""
    f = true_div(rgb.to(torch.float32), 255.0)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    safe = torch.where(d > 0, d, 1.0)
    h = torch.where(mx == r, torch.remainder((g - b) / safe, 6.0),
                    torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
    h = torch.where(d > 0, h * 30.0, 0.0)
    s = torch.where(mx > 0, d / torch.where(mx > 0, mx, 1.0), 0.0) * 255.0
    return torch.stack([h, s, mx * 255.0], dim=-1)


def hsv_color_filter(rgb: torch.Tensor, rect_xywh, h_range=(0.0, 180.0),
                     s_range=(0.0, 255.0), v_range=(0.0, 255.0)) -> torch.Tensor:
    """True (a 0-dim bool tensor) iff the pixel at the hypothesis bbox's
    centre (x + w // 2, y + h // 2, clipped into the frame) lies in the
    HSV gate, every range inclusive."""
    H, W = rgb.shape[:2]
    x, y, w, h = torch.as_tensor(rect_xywh, device=rgb.device).to(torch.int64)
    cx = (x + torch.div(w, 2, rounding_mode="floor")).clamp(0, W - 1)
    cy = (y + torch.div(h, 2, rounding_mode="floor")).clamp(0, H - 1)
    hsv = rgb_to_hsv_u8(rgb[cy, cx])
    lo = torch.tensor([h_range[0], s_range[0], v_range[0]], dtype=torch.float32,
                      device=rgb.device)
    hi = torch.tensor([h_range[1], s_range[1], v_range[1]], dtype=torch.float32,
                      device=rgb.device)
    return ((hsv >= lo) & (hsv <= hi)).all()


def absolute_rectangle(gray: torch.Tensor, roi_xywh, threshold: float = 10.0
                       ) -> torch.Tensor:
    """Tight bbox (x, y, w, h) int32 of the pixels > `threshold` inside the
    ROI (x, y, w, h); zeros when there are none."""
    H, W = gray.shape
    dev = gray.device
    x0, y0, w, h = torch.as_tensor(roi_xywh, device=dev).to(torch.int64)
    iy, ix = torch.arange(H, device=dev), torch.arange(W, device=dev)
    inside = ((ix[None, :] >= x0) & (ix[None, :] < x0 + w)
              & (iy[:, None] >= y0) & (iy[:, None] < y0 + h))
    thr = torch.tensor(threshold, dtype=torch.float32, device=dev)
    fg = inside & (gray > thr)
    cols, rows = fg.any(dim=0), fg.any(dim=1)
    bx0, bx1 = torch.where(cols, ix, W).amin(), torch.where(cols, ix, -1).amax()
    by0, by1 = torch.where(rows, iy, H).amin(), torch.where(rows, iy, -1).amax()
    rect = torch.stack([bx0, by0, bx1 - bx0 + 1, by1 - by0 + 1])
    return torch.where(fg.any(), rect, 0).to(torch.int32)


def greedy_suppress(near: torch.Tensor, key: torch.Tensor, valid: torch.Tensor
                    ) -> torch.Tensor:
    """Greedy suppression: walk the entries by descending `key` (a stable
    order: ties keep the lower index first; invalid entries last), each one
    still kept suppressing the lower-ranked entries it is `near` (C, C).
    An entry already suppressed, or never valid, suppresses nothing.  The
    order is taken where the tensors live, the short walk on the host.
    Returns the keep mask."""
    order = torch.argsort(-torch.where(valid, key, -torch.inf), stable=True)
    near, order = near.cpu().numpy(), order.cpu().numpy()
    keep = valid.cpu().numpy().copy()
    rank_of = np.empty_like(order)
    rank_of[order] = np.arange(order.shape[0])
    for i, idx in enumerate(order):
        if keep[idx]:
            keep &= ~(near[idx] & (rank_of > i))
    return torch.from_numpy(keep).to(valid.device)


def nms_distance(cell_indices: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                 neighbor_size: int) -> torch.Tensor:
    """C6: greedy suppression of the cells within `neighbor_size` (the
    largest of |dy|, |dx| over the cells' (hy, hx) indices; cell_indices
    (C, 3) int32 (hy, hx, hd)) by better-scored cells.  Returns the keep
    mask (C,)."""
    yx = cell_indices[:, :2].to(torch.int64)
    d = (yx[:, None, :] - yx[None, :, :]).abs().amax(dim=-1)
    return greedy_suppress(d <= neighbor_size, scores, valid)
