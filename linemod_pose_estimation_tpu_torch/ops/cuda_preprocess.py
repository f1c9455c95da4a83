"""The preprocess's quantizers on the card: kernel K1, the fused
ColorGradient quantizer (``csrc/quantize_cg.cu``), and kernel DN, the
DepthNormal quantizer with its 5x5 median (``csrc/depth_normal.cu``).

K1 replaces ``linemod_pose_estimation_tpu/ops/pallas_preprocess.py::
quantize_color_gradient_pallas``.  The matcher takes its bitmask alone;
the trainer takes the kernel's compile-time variant that also writes each
pixel's squared gradient magnitude, the score by which template
extraction selects its features.  DN replaces no Pallas kernel (the
reference's DepthNormal is XLA): it fuses the plain version's chain of
elementwise launches into one.  A CPU tensor takes the plain PyTorch
version (``ops.features``); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import tracing
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
    tracing.count("launch.quantize_cg")
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


def quantize_depth_normal_plain(depth_mm: torch.Tensor, distance_threshold: float = 2000.0,
                                difference_threshold: float = 50.0) -> torch.Tensor:
    """(..., H, W) depth in mm -> (..., H, W) u8 bitmask, plain PyTorch on
    any device."""
    return F.quantize_depth_normal(depth_mm, distance_threshold, difference_threshold)


def quantize_depth_normal(depth_mm: torch.Tensor, distance_threshold: float = 2000.0,
                          difference_threshold: float = 50.0) -> torch.Tensor:
    """(..., H, W) depth in mm (0 = invalid) -> (..., H, W) u8 quantized
    surface-normal bitmask after its 5x5 median, bit-identical to the
    plain version: one launch of DN for every frame of the batch.  A
    depth of another dtype than float32 is truncated to int32 first, as
    the plain version does."""
    if depth_mm.device.type == "cpu":
        return quantize_depth_normal_plain(depth_mm, distance_threshold, difference_threshold)
    if depth_mm.dim() < 2:
        raise ValueError(f"depth_mm: expected (..., H, W), got {tuple(depth_mm.shape)}")
    if depth_mm.dtype != torch.float32:
        depth_mm = depth_mm.to(torch.int32).to(torch.float32)
    *lead, H, W = depth_mm.shape
    depth = depth_mm.contiguous().view(-1, H, W)
    _build.require(depth, "depth_mm", torch.float32)
    out = torch.empty(depth.shape, dtype=torch.uint8, device=depth.device)
    lib = _build.library()
    err = lib.lpe_depth_normal(
        depth.data_ptr(), F.normal_lut(depth.device).data_ptr(), out.data_ptr(),
        *depth.shape, float(np.float32(distance_threshold)),
        float(np.float32(difference_threshold)), *_build.device_and_stream(depth),
    )
    _build.check(err, "depth_normal")
    tracing.count("launch.depth_normal")
    return out.view(*lead, H, W)
