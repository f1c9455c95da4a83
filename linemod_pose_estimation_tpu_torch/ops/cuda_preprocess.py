"""Kernel K1: the fused ColorGradient quantizer (``csrc/quantize_cg.cu``).

Replaces ``linemod_pose_estimation_tpu/ops/pallas_preprocess.py::
quantize_color_gradient_pallas``.  A CPU tensor takes the plain PyTorch
version (``ops.features.quantize_color_gradient``); a CUDA tensor
launches the kernel or raises.  The matcher takes the bitmask alone; the
trainer takes the kernel's compile-time variant that also writes each
pixel's squared gradient magnitude, the score by which template
extraction selects its features.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from . import features as F

# Output rows per block of the row-streaming kernel (its strip height):
# each strip re-reads 10 halo rows and drains a 2-step pipeline, and the
# grid must still fill the card (of 32, 40 and 48 on an H100, 40 was the
# fastest at level 0 of the B=32 batch and within 3% at level 1).
ROWS = 40


def quantize_color_gradient_plain(rgb: torch.Tensor, weak_threshold: float = 10.0
                                  ) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H, W) u8 bitmask, plain PyTorch on any device."""
    return F.quantize_color_gradient(rgb, weak_threshold)[0]


def _launch(rgb: torch.Tensor, weak_threshold: float, with_mag2: bool):
    if rgb.dim() != 4 or rgb.shape[-1] != 3:
        raise ValueError(f"rgb: expected (B, H, W, 3), got {tuple(rgb.shape)}")
    if rgb.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"rgb: expected uint8 or float32, got {rgb.dtype}")
    _build.require(rgb, "rgb", rgb.dtype)
    B, H, W, _ = rgb.shape
    out = torch.empty((B, H, W), dtype=torch.uint8, device=rgb.device)
    mag2 = torch.empty((B, H, W), dtype=torch.float32, device=rgb.device) if with_mag2 else None
    weak2 = float(np.float32(weak_threshold) * np.float32(weak_threshold))
    lib = _build.library()
    err = lib.lpe_quantize_cg(
        rgb.data_ptr(), int(rgb.dtype == torch.float32), out.data_ptr(),
        None if mag2 is None else mag2.data_ptr(),
        B, H, W, ROWS, weak2, *_build.device_and_stream(rgb),
    )
    _build.check(err, "quantize_cg")
    _build.launch_counts["quantize_cg"] += 1
    return out, mag2


def quantize_color_gradient(rgb: torch.Tensor, weak_threshold: float = 10.0
                            ) -> torch.Tensor:
    """(B, H, W, 3) uint8 or integer-valued float32 (values in [0, 255])
    -> (B, H, W) uint8 one-hot orientation bitmask, bit-identical to the
    plain version."""
    if rgb.device.type == "cpu":
        return quantize_color_gradient_plain(rgb, weak_threshold)
    return _launch(rgb, weak_threshold, with_mag2=False)[0]


def quantize_color_gradient_mag2(rgb: torch.Tensor, weak_threshold: float = 10.0
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's variant for the trainer: the bitmask and the strongest
    channel's squared gradient magnitude (B, H, W) f32, both bit-identical
    to the plain ``features.quantize_color_gradient`` (the magnitudes are
    exact integers below 2^24)."""
    if rgb.device.type == "cpu":
        return F.quantize_color_gradient(rgb, weak_threshold)
    return _launch(rgb, weak_threshold, with_mag2=True)
