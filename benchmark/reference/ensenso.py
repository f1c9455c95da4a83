"""The plain reference of the Ensenso deployment: the pose service's frame
conditioning, then cv::linemod's matcher on colour alone.

The service (upstream `linemod_ensenso_detect_3_mult_detect_service.cpp`)
replicates the mono stereo-left frame into three channels, blurs it with the
3x3 Gaussian and crops Rect(bias_x, 0, 640, 480).  The blur here is the one
the port's contract states: the separable [1, 2, 1] / 4 kernel, wrapping at
every edge of the whole frame, its float sums truncated to u8.  Those sums
are exact multiples of 1/16, so the reference computes them in integers:
(a + 2b + c) down, then across, then // 16.  The matching is
`matcher.ReferenceMatcher` on the conditioned frames with no depth.
"""

from __future__ import annotations

import numpy as np
import torch

from . import matcher as RM
from .bank import Bank


def condition(frames: np.ndarray, bias_x: int, crop_w: int, crop_h: int,
              blur: bool = True) -> np.ndarray:
    """(n, H, W) mono or (n, H, W, 3) u8 -> (n, crop_h, crop_w, 3) u8."""
    a = np.asarray(frames)
    if a.ndim == 3:
        a = np.repeat(a[..., None], 3, axis=-1)
    if blur:
        a = a.astype(np.int32)
        a = np.roll(a, 1, axis=1) + 2 * a + np.roll(a, -1, axis=1)
        a = np.roll(a, 1, axis=2) + 2 * a + np.roll(a, -1, axis=2)
        a = (a // 16).astype(np.uint8)
    return np.ascontiguousarray(a[:, :crop_h, bias_x:bias_x + crop_w])


class EnsensoReference:
    """Exact matches of raw camera frames against `bank` (tiled `reps`
    times) at `threshold`: `conditioning` (bias_x, crop_w, crop_h, blur)
    first, then ReferenceMatcher in the batched engine's position order.
    `dtype` is the float chains' precision, as in ReferenceMatcher."""

    def __init__(self, bank: Bank, threshold: float, top_k: int, conditioning: dict,
                 reps: int = 1, device="cuda", dtype=torch.float32):
        if "DepthNormal" in bank.modalities:
            raise ValueError("the Ensenso's frames carry no depth: a colour-only bank")
        self.conditioning = dict(conditioning)
        self.matcher = RM.ReferenceMatcher(bank, float(threshold), top_k, reps=reps,
                                           order="position", device=device, dtype=dtype)

    def match(self, frames: np.ndarray) -> list[dict]:
        """Raw frames -> per frame the walked candidates in slot order
        (dicts of numpy arrays; mask by valid)."""
        return self.matcher.match(condition(frames, **self.conditioning), None)
