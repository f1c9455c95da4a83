"""Launch records for roofline shares: spies on the program's kernel
wrappers that note each launch's least time (the frozen roofline copy)
from its shapes, in launch order, under the kernel's trace name."""

from __future__ import annotations

from . import roofline as RL

# Each kernel's name fragment in the device trace.
K1, K2, K4 = "quantize_cg_kernel", "spread_response_kernel", "raster_zbuffer"


def record_k1(p, launches: dict) -> None:
    """K1 (ColorGradient quantizer, both variants): ops.cuda_preprocess._launch."""
    from linemod_pose_estimation_tpu_torch.ops import cuda_preprocess as CP

    def note(a, k, out):
        rgb, with_mag2 = a[0], a[2] if len(a) > 2 else k["with_mag2"]
        B, H, W = rgb.shape[:3]
        launches.setdefault(K1, []).append(
            RL.quantize_cg(B, H, W, rgb.element_size(), mag2=bool(with_mag2)).ms)

    p.spy(CP, "_launch", note)


def record_k2(p, launches: dict) -> None:
    """K2 (spread + response maps): ops.cuda_kernels.spread_response."""
    from linemod_pose_estimation_tpu_torch.ops import cuda_kernels as CK

    def note(a, k, out):
        quant, T = a[0], a[1] if len(a) > 1 else k["T"]
        if quant.is_cuda:
            launches.setdefault(K2, []).append(RL.spread_response(*quant.shape, T).ms)

    p.spy(CK, "spread_response", note)


def record_k4(p, launches: dict) -> None:
    """K4 (z-buffer): ops.raster.raster_zbuffer; its bound needs the pairs
    that the launch's coefficient table covers, counted after the window
    (`k4_bounds`), so the table is kept."""
    from linemod_pose_estimation_tpu_torch.ops import raster

    def note(a, k, out):
        coefs, width, height = a[0], a[1], a[2]
        launches.setdefault("k4_tables", []).append((coefs, int(width), int(height)))

    p.spy(raster, "raster_zbuffer", note)


def k4_bounds(launches: dict) -> None:
    tables = launches.pop("k4_tables", [])
    launches[K4] = [RL.raster_zbuffer(*c.shape[:2], h, w, c.shape[2],
                                      RL.raster_pairs(c, w, h)).ms for c, w, h in tables]
