"""Kernel K1: the fused ColorGradient quantizer (``csrc/quantize_cg.cu``).

Replaces ``linemod_pose_estimation_tpu/ops/pallas_preprocess.py::
quantize_color_gradient_pallas``.  A CPU tensor takes the plain PyTorch
version (``ops.features.quantize_color_gradient``); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from . import features as F


def quantize_color_gradient_plain(rgb: torch.Tensor, weak_threshold: float = 10.0
                                  ) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H, W) u8 bitmask, plain PyTorch on any device."""
    return F.quantize_color_gradient(rgb, weak_threshold)[0]


def quantize_color_gradient(rgb: torch.Tensor, weak_threshold: float = 10.0
                            ) -> torch.Tensor:
    """(B, H, W, 3) uint8 or integer-valued float32 -> (B, H, W) uint8
    one-hot orientation bitmask, bit-identical to the plain version."""
    if rgb.device.type == "cpu":
        return quantize_color_gradient_plain(rgb, weak_threshold)
    if rgb.dim() != 4 or rgb.shape[-1] != 3:
        raise ValueError(f"rgb: expected (B, H, W, 3), got {tuple(rgb.shape)}")
    if rgb.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"rgb: expected uint8 or float32, got {rgb.dtype}")
    _build.require(rgb, "rgb", rgb.dtype)
    B, H, W, _ = rgb.shape
    out = torch.empty((B, H, W), dtype=torch.uint8, device=rgb.device)
    weak2 = float(np.float32(weak_threshold) * np.float32(weak_threshold))
    lib = _build.library()
    err = lib.lpe_quantize_cg(
        rgb.data_ptr(), int(rgb.dtype == torch.float32), out.data_ptr(),
        B, H, W, weak2, *_build.device_and_stream(rgb),
    )
    _build.check(err, "quantize_cg")
    _build.launch_counts["quantize_cg"] += 1
    return out
