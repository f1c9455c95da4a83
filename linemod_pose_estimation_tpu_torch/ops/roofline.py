"""The least time an NVIDIA H100 SXM could take for each kernel's work.

One function per hand-written kernel.  Each takes the shapes (and, where
the work depends on the data, the counts) of one launch and returns a
`Bound`: the bytes the function must move (each input read once, each
output written once), the operations it does, and the larger of the two
times at the card's published peaks, with which of the two sets it.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the full 700 W): 3.35 TB/s
of HBM3 and 67 TFLOP/s of f32 outside the tensor cores.  Every operation
counted here is an elementwise f32 or int32 operation (add, multiply,
compare, select, shift, logic, one division as one), and all of them are
held to the f32 rate, as the card issues int32 at no more than that.

The per-element operation counts are those of the straightforward
algorithm each kernel implements, written out below, not of any one
implementation's instruction stream.  chip_smoke.py divides each bound
by the kernel's measured time; PERF.md's kernel table is written from it.
"""

from __future__ import annotations

from typing import NamedTuple

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


class Bound(NamedTuple):
    bytes: int
    ops: int
    ms: float  # max(bytes / HBM rate, ops / f32 rate), in milliseconds
    by: str  # "bytes" or "operations"


def bound(nbytes: int, ops: int) -> Bound:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return Bound(int(nbytes), int(ops), t_bytes, "bytes")
    return Bound(int(nbytes), int(ops), t_ops, "operations")


# K1, per output pixel: the 7x7 Gaussian as two 7-tap passes over 3
# channels with one rounding (3 x (13 + 13 + 2) = 84), Sobel dx and dy
# (3 x 13 = 39), squared magnitudes (3 x 3 = 9), the strongest channel and
# its tie rule (6), fastAtan2 (21, with one division), binning (4), the
# strength test (1), the 3x3 vote (9 shifted adds, 9 shifts, 7 compares =
# 25) and the gate (3).
QUANTIZE_CG_OPS_PER_PX = 84 + 39 + 9 + 6 + 21 + 4 + 1 + 25 + 3


def quantize_cg(B: int, H: int, W: int, in_itemsize: int, mag2: bool = False) -> Bound:
    """K1 on (B, H, W, 3) input of `in_itemsize` bytes (1 for u8, 4 for
    f32) -> (B, H, W) u8, and with `mag2` (the trainer's variant) also the
    (B, H, W) f32 squared magnitudes: 4 more bytes a pixel written, no
    more operations (the magnitudes are formed either way)."""
    px = B * H * W
    return bound(px * 3 * in_itemsize + px + (4 * px if mag2 else 0),
                 px * QUANTIZE_CG_OPS_PER_PX)


def spread_response_ops_per_px(T: int) -> int:
    """K2, per pixel: the separable T x T OR (2 (T - 1)), three circular
    dilations (5 each) and 8 response planes (4 bit extractions, 3 adds)."""
    return 2 * (T - 1) + 3 * 5 + 8 * 7


def spread_response(B: int, H: int, W: int, T: int) -> Bound:
    """K2 (and K2b at B=1): (B, H, W) u8 -> 8 planes of (B, H, W) u8."""
    px = B * H * W
    return bound(px + 8 * px, px * spread_response_ops_per_px(T))


def walk_scores(B: int, K: int, F: int, walked: int, live_pairs: int,
                r0_bytes: int) -> Bound:
    """K3 over `walked` of its B * K slots (k < n_valid[b]) with
    `live_pairs` (walked slot, live feature) pairs.  A slot past n_valid
    scores 0 whatever its operands hold, so the least work reads operands
    of the walked slots only: (B,) n_valid int32, each walked slot's gy0
    and gx0 int32 and its F live flags, and oris/dys/dxs int32 of its live
    features; then the distinct response bytes the walk touches
    (`r0_bytes`), and every slot's (16, 16) int32 scores, since the zeros
    must be written too.  One add per live pair and placement."""
    operands = B * 4 + walked * (2 * 4 + F) + live_pairs * 3 * 4
    return bound(operands + r0_bytes + B * K * 256 * 4, live_pairs * 256)


# K4, per (pixel, triangle) pair tested: three edge functions (7 each), the
# inside tests with the grown margins and the bbox (20), the perspective-
# correct depth (8, three divisions), its reciprocal and clamps (4) and
# the depth test and select (2).
RASTER_OPS_PER_PAIR = 21 + 20 + 8 + 4 + 2


def raster_zbuffer(P: int, Tn: int, H: int, W: int, ncoef: int, pairs: int) -> Bound:
    """K4: (P, Tn, ncoef) f32 coefficients -> (P, H, W) f32 depth and
    shade; `pairs` is the number of (pixel, live triangle) pairs whose
    pixel centre lies in the triangle's grown bounding box: the tests this
    run's data needs."""
    return bound(P * Tn * ncoef * 4 + 2 * P * H * W * 4, pairs * RASTER_OPS_PER_PAIR)


def refine_scores(K: int, F: int, window: int, live_features: int, r_bytes: int) -> Bound:
    """K5 over `live_features` (candidate, slot f < nf[k]) pairs.  A slot
    past nf adds nothing whatever it holds, so the least work reads
    oris/dys/dxs int32 of the live slots only, and (K,) nf/anchors/frame
    int32; then the distinct response bytes the windows touch (`r_bytes`),
    and the (K, window, window) int32 scores; one add per live feature
    slot and window cell."""
    operands = live_features * 3 * 4 + K * 4 * 4
    return bound(operands + r_bytes + K * window * window * 4,
                 live_features * window * window)
