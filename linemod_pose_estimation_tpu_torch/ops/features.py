"""Quantized LINEMOD modalities in plain PyTorch: the front half of the
cv::linemod engine.

These are the plain versions of the preprocess: they run on any device,
they are the CPU path, and on the card they are what the CUDA kernels K1
(ColorGradient quantizer, ``csrc/quantize_cg.cu``) and K2 (spread +
response, ``csrc/spread_response.cu``) are held against bit for bit.

Every function takes leading batch dimensions and is bit-exact with its
counterpart in ``linemod_pose_estimation_tpu/ops/features.py``: the
integer filters are exact in f32, and the float chains (fastAtan2, the
depth-normal fit) use the same f32 operations in the same order, one
rounding per operation.  The reference's banded-matmul convolutions and
arithmetic NORMAL_LUT are TPU workarounds; here the filters are shifted
slice sums and the LUT is a direct lookup in the probed table (identical
over all 11 x 21 x 21 cells).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

# cv::fastAtan2 polynomial constants: the double coefficient is truncated to
# float FIRST, then multiplied by (float)(180/pi) in float.
_RAD2DEG_F = np.float32(180.0 / np.pi)
_ATAN_P1 = float(np.float32(np.float32(0.9997878412794807) * _RAD2DEG_F))
_ATAN_P3 = float(np.float32(np.float32(-0.3258083974640975) * _RAD2DEG_F))
_ATAN_P5 = float(np.float32(np.float32(0.1555786518463281) * _RAD2DEG_F))
_ATAN_P7 = float(np.float32(np.float32(-0.04432655554792128) * _RAD2DEG_F))
_DBL_EPS_F = float(np.float32(2.220446049250313e-16))
_BIN_SCALE = float(np.float32(16.0 / 360.0))

# Integer Q6 taps of OpenCV's fixed 7-tap small-sigma Gaussian.
_GAUSS7_Q6 = (2.0, 7.0, 14.0, 18.0, 14.0, 7.0, 2.0)
# pyrDown taps [1, 4, 6, 4, 1] / 16 (exact binary fractions).
_PYR5 = (0.0625, 0.25, 0.375, 0.25, 0.0625)

# Response by circular bin distance d in [0, 4]: score = 4 - d.
RESPONSE_BY_DISTANCE = (4, 3, 2, 1, 0)

_NORMAL_LUT_PATH = os.path.join(
    os.path.dirname(__file__), "..", "..", "linemod_pose_estimation_tpu",
    "ops", "normal_lut_calib.npz",
)
_NORMAL_G = 10


def _pad_index(n: int, p: int, mode: str, device) -> torch.Tensor:
    i = torch.arange(-p, n + p, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    # reflect-101 (OpenCV BORDER_REFLECT_101, numpy/torch "reflect")
    i = torch.where(i < 0, -i, i)
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def _pad_hw(x: torch.Tensor, p: int, mode: str) -> torch.Tensor:
    """Pad the last two dims by p on every side: "replicate", "reflect"
    (reflect-101) or "constant" (zeros).  Index gathers, so every dtype
    pads the same way on every device."""
    H, W = x.shape[-2:]
    if mode == "constant":
        lead = x.shape[:-2]
        out = F.pad(x.reshape(-1, H, W), (p, p, p, p))
        return out.reshape(*lead, H + 2 * p, W + 2 * p)
    iy = _pad_index(H, p, mode, x.device)
    ix = _pad_index(W, p, mode, x.device)
    return x.index_select(-2, iy).index_select(-1, ix)


def _taps_valid(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    """VALID correlation of x with `taps` along `dim` (-1 or -2)."""
    k = len(taps)
    n = x.shape[dim] - k + 1
    acc = None
    for i, t in enumerate(taps):
        s = x.narrow(dim, i, n)
        term = s * t if t != 1.0 else s
        acc = term if acc is None else acc + term
    return acc


def gaussian_blur7_u8(img: torch.Tensor) -> torch.Tensor:
    """Bit-exact cv::GaussianBlur(8U, 7x7, sigma 0, BORDER_REPLICATE) on
    integer-valued (..., H, W) input: Q6 integer taps, one Q12
    accumulator, rounded half-up once (exact integers in f32)."""
    x = _pad_hw(img.to(torch.float32), 3, "replicate")
    acc = _taps_valid(_taps_valid(x, _GAUSS7_Q6, -1), _GAUSS7_Q6, -2)
    return torch.floor((acc + 2048.0) * (1.0 / 4096.0))


def sobel3_replicate(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel dx, dy (CV_16S semantics, BORDER_REPLICATE) on integer-
    valued f32 (..., H, W); exact integer results."""
    x = _pad_hw(img.to(torch.float32), 1, "replicate")
    dx = _taps_valid(_taps_valid(x, (-1.0, 0.0, 1.0), -1), (1.0, 2.0, 1.0), -2)
    dy = _taps_valid(_taps_valid(x, (1.0, 2.0, 1.0), -1), (-1.0, 0.0, 1.0), -2)
    return dx, dy


def fast_atan2_deg(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """cv::fastAtan2 elementwise in f32: degrees in [0, 360).  Same
    polynomial, constants and operation order as OpenCV."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    ax, ay = x.abs(), y.abs()
    big = ax >= ay
    num = torch.where(big, ay, ax)
    den = torch.where(big, ax, ay) + _DBL_EPS_F
    c = num / den
    c2 = c * c
    a = (((c2 * _ATAN_P7 + _ATAN_P5) * c2 + _ATAN_P3) * c2 + _ATAN_P1) * c
    a = torch.where(big, a, 90.0 - a)
    a = torch.where(x < 0, 180.0 - a, a)
    a = torch.where(y < 0, 360.0 - a, a)
    return a


def quantize_color_gradient(
    rgb: torch.Tensor, weak_threshold: float = 10.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., H, W, C) uint8 / integer-valued f32 image -> (quantized
    bitmask (..., H, W) u8, magnitude^2 f32).

    Bit-exact replica of OpenCV ColorGradient::quantizedOrientations +
    hysteresisGradient: u8-rounded 7x7 Gaussian and 3x3 Sobel with
    BORDER_REPLICATE, strongest channel per pixel (first channel wins
    ties), fastAtan2 angles, half-even 16-bin rounding folded to 8, 1-px
    border zeroing, then the 3x3 vote (>= 5 of 9 agree, first-max bin
    wins, center magnitude^2 > weak_threshold^2)."""
    img = rgb.to(torch.float32)
    if img.dim() == 2:
        img = img[..., None]
    C = img.shape[-1]
    dxs, dys, mags = [], [], []
    for c in range(C):
        ch = gaussian_blur7_u8(img[..., c])
        dx, dy = sobel3_replicate(ch)
        dxs.append(dx)
        dys.append(dy)
        mags.append(dx * dx + dy * dy)
    mag2 = mags[0]
    for m in mags[1:]:
        mag2 = torch.maximum(mag2, m)
    dx, dy = dxs[-1], dys[-1]
    for c in range(C - 2, -1, -1):
        hit = mags[c] == mag2
        dx = torch.where(hit, dxs[c], dx)
        dy = torch.where(hit, dys[c], dy)

    angle = fast_atan2_deg(dy, dx)
    # convertTo(CV_8U, 16/360): f32 scale, round half to even (torch.round
    # is half-even), then the &15 wrap and the 16->8 fold.
    bin8 = (torch.round(angle * _BIN_SCALE).to(torch.int32) & 15) & 7

    weak2 = float(np.float32(weak_threshold) * np.float32(weak_threshold))
    strong_px = mag2 > weak2

    H, W = bin8.shape[-2:]
    interior = torch.zeros((H, W), dtype=torch.bool, device=rgb.device)
    interior[1:-1, 1:-1] = True
    bin8 = torch.where(interior, bin8, 0)

    onehot = (bin8.unsqueeze(-3) == torch.arange(
        8, dtype=torch.int32, device=rgb.device).view(8, 1, 1)).to(torch.int32)
    oh_p = _pad_hw(onehot, 1, "constant")
    votes = None
    for r in range(3):
        for c in range(3):
            s = oh_p[..., r:r + H, c:c + W]
            votes = s if votes is None else votes + s  # (..., 8, H, W)
    max_votes = votes.amax(dim=-3)
    win = votes.argmax(dim=-3)  # first maximum, like jnp.argmax
    ok = strong_px & (max_votes >= 5) & interior
    quant = torch.where(ok, (1 << win).to(torch.uint8),
                        torch.zeros((), dtype=torch.uint8, device=rgb.device))
    return quant, mag2


_NORMAL_LUT_CACHE: dict[torch.device, torch.Tensor] = {}


def normal_lut(device) -> torch.Tensor:
    """The engine's (11, 21, 21) NORMAL_LUT (probed table, u8) flattened,
    read from the reference package's data file by path."""
    device = torch.device(device)
    if device not in _NORMAL_LUT_CACHE:
        with np.load(_NORMAL_LUT_PATH) as z:
            lut = z["lut"].astype(np.uint8).reshape(-1)
        _NORMAL_LUT_CACHE[device] = torch.from_numpy(lut).to(device)
    return _NORMAL_LUT_CACHE[device]


def _median5_bitmask(q: torch.Tensor) -> torch.Tensor:
    """cv::medianBlur(q, 5) on a (..., H, W) u8 image, replicate border:
    the true 13th-smallest of the 25-window, by an MSB-first bitwise
    majority radix (8 passes)."""
    H, W = q.shape[-2:]
    p = _pad_hw(q.to(torch.int32), 2, "replicate")
    wins = [p[..., r:r + H, c:c + W] for r in range(5) for c in range(5)]
    med = torch.zeros_like(wins[0])
    for bit in range(7, -1, -1):
        probe = med | (1 << bit)
        cnt = torch.zeros_like(med)
        for w in wins:
            cnt = cnt + (w >= probe).to(torch.int32)
        med = torch.where(cnt >= 13, probe, med)
    return med.to(torch.uint8)


def quantize_depth_normal(
    depth_mm: torch.Tensor,
    distance_threshold: float = 2000.0,
    difference_threshold: float = 50.0,
    radius: int = 5,
) -> torch.Tensor:
    """Depth (..., H, W) in mm (0 = invalid) -> quantized surface-normal
    bitmask u8, bit-exact with cv::linemod's DepthNormal quantizedNormals:
    the integer bilateral-masked LS plane fit over the 8 radius-5
    neighbours, the unnormalized f32 normal (1150*ddx, 1150*ddy, -det*d),
    normalize, truncate onto the GRANULARITY=10 grid, NORMAL_LUT lookup,
    zero outside rows/cols [5, dim-6], then the 5x5 median."""
    d32 = depth_mm.to(torch.int32)  # CV_16U truncation semantics
    d = d32.to(torch.float32)
    H, W = d.shape[-2:]
    r = radius
    pd = _pad_hw(d, r, "constant")

    offsets = [(-r, -r), (-r, 0), (-r, r), (0, -r), (0, r), (r, -r), (r, 0), (r, r)]
    A00 = torch.zeros_like(d)
    A01 = torch.zeros_like(d)
    A11 = torch.zeros_like(d)
    b0 = torch.zeros_like(d)
    b1 = torch.zeros_like(d)
    for oy, ox in offsets:
        nb = pd[..., oy + r:oy + r + H, ox + r:ox + r + W]
        delta = nb - d
        w = (delta.abs() < difference_threshold).to(torch.float32)
        u, v = float(ox), float(oy)
        A00 = A00 + w * (u * u)
        A01 = A01 + w * (u * v)
        A11 = A11 + w * (v * v)
        b0 = b0 + (w * u) * delta
        b1 = b1 + (w * v) * delta
    det = A00 * A11 - A01 * A01
    ddx = A11 * b0 - A01 * b1
    ddy = -A01 * b0 + A00 * b1
    nx = ddx * 1150.0
    ny = ddy * 1150.0
    nz = -det * d
    sq = nx * nx + ny * ny + nz * nz
    sqr = torch.sqrt(sq)
    # ones / x, not 1.0 / x: torch evaluates scalar / tensor as a
    # reciprocal times the scalar, not as one IEEE division.
    inv = torch.where(sqr > 0, torch.ones_like(sqr) / torch.clamp(sqr, min=1e-30),
                      torch.zeros((), dtype=torch.float32, device=d.device))
    G = float(_NORMAL_G)
    v1 = (nx * inv * G + G).to(torch.int32)  # trunc, as static_cast<int>
    v2 = (ny * inv * G + G).to(torch.int32)
    v3 = (nz * inv * G + G).to(torch.int32)
    flat = (v3.clamp(0, 10) * 21 + v2.clamp(0, 20)) * 21 + v1.clamp(0, 20)
    val = normal_lut(d.device)[flat.long()]
    ok = (d < distance_threshold) & (sqr > 0)
    zero = torch.zeros((), dtype=torch.uint8, device=d.device)
    q = torch.where(ok, val, zero)
    border = torch.zeros((H, W), dtype=torch.bool, device=d.device)
    border[r:H - r - 1, r:W - r - 1] = True
    q = torch.where(border, q, zero)
    return _median5_bitmask(q)


def orientation_spread(quant: torch.Tensor, T: int) -> torch.Tensor:
    """OR-dilate the (..., H, W) u8 bitmask over offsets [0, T) (OpenCV
    `spread`), zero past the bottom/right edge."""
    H, W = quant.shape[-2:]
    lead = quant.shape[:-2]
    p = F.pad(quant.reshape(-1, H, W), (0, T - 1, 0, T - 1)).reshape(
        *lead, H + T - 1, W + T - 1)
    out = torch.zeros_like(quant)
    for r in range(T):
        for c in range(T):
            out = out | p[..., r:r + H, c:c + W]
    return out


def distance_masks(o: int) -> list[int]:
    """Bitmasks of the orientation bins at circular distance 0..4 from o."""
    return [(1 << ((o - d) % 8)) | (1 << ((o + d) % 8)) for d in range(5)]


def response_maps(spread_quant: torch.Tensor) -> torch.Tensor:
    """Spread bitmask (..., H, W) -> response maps (..., 8, H, W) u8:
    response[o] = max over set bits b of (4 - circ_dist(o, b))."""
    s = spread_quant.to(torch.int32)
    maps = []
    for o in range(8):
        masks = distance_masks(o)
        r = torch.zeros_like(s)
        for d in range(3, -1, -1):
            r = torch.where((s & masks[d]) != 0, RESPONSE_BY_DISTANCE[d], r)
        maps.append(r.to(torch.uint8))
    return torch.stack(maps, dim=-3)


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """cv::pyrDown on integer-valued (..., H, W) f32: 5x5 [1,4,6,4,1]/16
    Gaussian with reflect-101 borders, 2x decimation, half-up rounding to
    the integer grid (every partial sum is exact in f32)."""
    x = _pad_hw(img.to(torch.float32), 2, "reflect")
    out = _taps_valid(_taps_valid(x, _PYR5, -1), _PYR5, -2)
    return torch.floor(out[..., ::2, ::2] + 0.5)
