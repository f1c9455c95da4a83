"""Kernels K2 (spread + response maps, ``csrc/spread_response.cu``), K3
(cv::linemod's 16 x 16 local walk, ``csrc/walk_scores.cu``) and K5 (dense
window scores around coarse candidates, ``csrc/refine_scores.cu``), each
with its plain PyTorch version beside it.

K2 replaces ``linemod_pose_estimation_tpu/ops/pallas_kernels.py::
spread_response_batched``; K3 replaces ``walk_scores_pallas``; K5
replaces ``refine_scores_pallas``.  A CPU tensor takes the plain version;
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from . import features as F

WIN = 16  # OpenCV's fixed 16 x 16 local similarity map


def spread_response_plain(quant: torch.Tensor, T: int) -> torch.Tensor:
    """(B, H, W) u8 bitmasks -> (B, 8, H, W) u8 response maps."""
    return F.response_maps(F.orientation_spread(quant, T))


def spread_response(quant: torch.Tensor, T: int) -> torch.Tensor:
    """T x T OR-spread over offsets [0, T) (zero past the frame edge),
    then the graded 4/3/2/1/0 response LUT: (B, H, W) u8 -> (B, 8, H, W)
    u8, bit-identical to the plain version."""
    if quant.device.type == "cpu":
        return spread_response_plain(quant, T)
    if quant.dim() != 3:
        raise ValueError(f"quant: expected (B, H, W), got {tuple(quant.shape)}")
    _build.require(quant, "quant", torch.uint8)
    B, H, W = quant.shape
    out = torch.empty((B, 8, H, W), dtype=torch.uint8, device=quant.device)
    lib = _build.library()
    err = lib.lpe_spread_response(quant.data_ptr(), out.data_ptr(), B, H, W, T,
                                  *_build.device_and_stream(quant))
    _build.check(err, "spread_response")
    _build.launch_counts["spread_response"] += 1
    return out


def walk_scores_plain(R0, oris, dys, dxs, live, gy0, gx0, n_valid, T: int
                      ) -> torch.Tensor:
    """Raw walk scores (B, K, 16, 16) int32: placement (r, c) sums, over
    live features f, R0[b, ori, (gy0+r)*T + dy, (gx0+c)*T + dx] (0 outside
    the frame); slots k >= n_valid[b] score exactly 0."""
    B, C, H, W = R0.shape
    K, Fmax = oris.shape[1:]
    dev = R0.device
    BK = B * K
    fi = torch.arange(B, device=dev).repeat_interleave(K)[:, None, None]
    q = torch.arange(WIN, device=dev)
    rows0 = (gy0.reshape(BK, 1).long() + q) * T  # (BK, 16)
    cols0 = (gx0.reshape(BK, 1).long() + q) * T
    o_all = oris.reshape(BK, Fmax).long().clamp(0, C - 1)
    dy_all = dys.reshape(BK, Fmax).long()
    dx_all = dxs.reshape(BK, Fmax).long()
    lv_all = live.reshape(BK, Fmax)
    acc = torch.zeros((BK, WIN, WIN), dtype=torch.int32, device=dev)
    for f in range(Fmax):
        yy = rows0 + dy_all[:, f, None]
        xx = cols0 + dx_all[:, f, None]
        inb = (((yy >= 0) & (yy < H))[:, :, None]
               & ((xx >= 0) & (xx < W))[:, None, :]
               & lv_all[:, f, None, None])
        v = R0[fi, o_all[:, f, None, None],
               yy.clamp(0, H - 1)[:, :, None], xx.clamp(0, W - 1)[:, None, :]]
        acc += torch.where(inb, v.to(torch.int32), 0)
    slot_live = (torch.arange(K, device=dev)[None, :] < n_valid[:, None]).reshape(BK)
    acc = torch.where(slot_live[:, None, None], acc, 0)
    return acc.reshape(B, K, WIN, WIN)


def walk_scores(R0, oris, dys, dxs, live, gy0, gx0, n_valid, T: int
                ) -> torch.Tensor:
    """K3: raw cv::linemod walk scores (B, K, 16, 16) int32 — one block per
    candidate slot, one thread per placement.  Operands: R0 (B, C, H, W)
    u8; oris/dys/dxs (B, K, F) int32 (offsets already clipped to
    [0, E0]); live (B, K, F) bool; gy0/gx0 (B, K) int32; n_valid (B,)
    int32."""
    if R0.device.type == "cpu":
        return walk_scores_plain(R0, oris, dys, dxs, live, gy0, gx0, n_valid, T)
    if R0.dim() != 4:
        raise ValueError(f"R0: expected (B, C, H, W), got {tuple(R0.shape)}")
    B, C, H, W = R0.shape
    K, Fmax = oris.shape[1:]
    _build.require(R0, "R0", torch.uint8)
    oris, dys, dxs = (a.contiguous() for a in (oris, dys, dxs))
    live, gy0, gx0, n_valid = (a.contiguous() for a in (live, gy0, gx0, n_valid))
    dev = R0.device
    for name, t in (("oris", oris), ("dys", dys), ("dxs", dxs)):
        _build.require(t, name, torch.int32, (B, K, Fmax), dev)
    _build.require(live, "live", torch.bool, (B, K, Fmax), dev)
    _build.require(gy0, "gy0", torch.int32, (B, K), dev)
    _build.require(gx0, "gx0", torch.int32, (B, K), dev)
    _build.require(n_valid, "n_valid", torch.int32, (B,), dev)
    out = torch.empty((B, K, WIN, WIN), dtype=torch.int32, device=R0.device)
    lib = _build.library()
    err = lib.lpe_walk_scores(
        R0.data_ptr(), oris.data_ptr(), dys.data_ptr(), dxs.data_ptr(),
        live.data_ptr(), gy0.data_ptr(), gx0.data_ptr(), n_valid.data_ptr(),
        out.data_ptr(), B, C, H, W, K, Fmax, T, *_build.device_and_stream(R0),
    )
    _build.check(err, "walk_scores")
    _build.launch_counts["walk_scores"] += 1
    return out


def window_sums(R, frame, oris, ys, xs, mask, window: int) -> torch.Tensor:
    """(K, window, window) int32: out[k, wy, wx] sums, over slots f with
    mask[k, f], R[frame[k], oris[k, f], ys[k, f] + wy, xs[k, f] + wx],
    reads outside the frame counting 0.  R is (B, C, H, W); ys/xs are the
    window origins of each feature (K, F).  The window refiners' plain
    core: each refiner supplies its own origins (and offset clip)."""
    B, C, H, W = R.shape
    K, Fmax = oris.shape
    dev = R.device
    fi = frame.long()[:, None, None]
    q = torch.arange(window, device=dev)
    acc = torch.zeros((K, window, window), dtype=torch.int32, device=dev)
    for f in range(Fmax):
        yy = ys[:, f, None].long() + q  # (K, window)
        xx = xs[:, f, None].long() + q
        inb = (((yy >= 0) & (yy < H))[:, :, None]
               & ((xx >= 0) & (xx < W))[:, None, :]
               & mask[:, f, None, None])
        v = R[fi, oris[:, f, None, None].long().clamp(0, C - 1),
              yy.clamp(0, H - 1)[:, :, None], xx.clamp(0, W - 1)[:, None, :]]
        acc += torch.where(inb, v.to(torch.int32), 0)
    return acc


def _as_batched(R, frame_idx, K: int):
    """(R as (B, C, H, W), frame index (K,)) for a (C, H, W) or (B, C, H,
    W) response stack; no frame_idx means frame 0 (the reference's
    default)."""
    if R.dim() == 3:
        R = R[None]
    if R.dim() != 4:
        raise ValueError(f"R: expected (C, H, W) or (B, C, H, W), got {tuple(R.shape)}")
    if frame_idx is None:
        frame_idx = torch.zeros(K, dtype=torch.int32, device=R.device)
    return R, frame_idx


def refine_scores_plain(R, oris, dys, dxs, nf, anchor_y, anchor_x,
                        window: int = 24, frame_idx=None) -> torch.Tensor:
    """Raw window scores (K, window, window) int32: out[k, wy, wx] sums,
    over slots f < nf[k], R[frame[k], oris[k, f], anchor_y[k] + dys[k, f]
    + wy, anchor_x[k] + dxs[k, f] + wx], zero past the frame."""
    K, Fmax = oris.shape
    R, frame_idx = _as_batched(R, frame_idx, K)
    slot = torch.arange(Fmax, device=R.device)
    return window_sums(R, frame_idx, oris, anchor_y[:, None] + dys,
                       anchor_x[:, None] + dxs, slot[None, :] < nf[:, None], window)


def refine_scores(R, oris, dys, dxs, nf, anchor_y, anchor_x,
                  window: int = 24, frame_idx=None) -> torch.Tensor:
    """K5: raw window scores (K, window, window) int32 — one block per
    candidate, one thread per window cell.  Operands: R (C, H, W) or (B,
    C, H, W) u8 with frame_idx (K,) int32 selecting each candidate's frame
    (None: frame 0); oris/dys/dxs (K, F) int32 with the offsets already
    clipped to [0, E0]; nf/anchor_y/anchor_x (K,) int32, anchors >= 0.
    Live feature slots must sit at [0, nf) (the refiners compact them)."""
    if R.device.type == "cpu":
        return refine_scores_plain(R, oris, dys, dxs, nf, anchor_y, anchor_x,
                                   window, frame_idx)
    K, Fmax = oris.shape
    R, frame_idx = _as_batched(R, frame_idx, K)
    B, C, H, W = R.shape
    if not 1 <= window <= 32:
        raise ValueError(f"window={window}: K5 runs one thread per cell, at most 32 x 32")
    dev = R.device
    _build.require(R, "R", torch.uint8)
    oris, dys, dxs = (a.contiguous() for a in (oris, dys, dxs))
    nf, anchor_y, anchor_x, frame_idx = (
        a.contiguous() for a in (nf, anchor_y, anchor_x, frame_idx))
    for name, t in (("oris", oris), ("dys", dys), ("dxs", dxs)):
        _build.require(t, name, torch.int32, (K, Fmax), dev)
    for name, t in (("nf", nf), ("anchor_y", anchor_y), ("anchor_x", anchor_x),
                    ("frame_idx", frame_idx)):
        _build.require(t, name, torch.int32, (K,), dev)
    out = torch.empty((K, window, window), dtype=torch.int32, device=dev)
    if K == 0:
        return out
    lib = _build.library()
    err = lib.lpe_refine_scores(
        R.data_ptr(), oris.data_ptr(), dys.data_ptr(), dxs.data_ptr(),
        nf.data_ptr(), anchor_y.data_ptr(), anchor_x.data_ptr(),
        frame_idx.data_ptr(), out.data_ptr(), C, H, W, K, Fmax, window,
        *_build.device_and_stream(R),
    )
    _build.check(err, "refine_scores")
    _build.launch_counts["refine_scores"] += 1
    return out
