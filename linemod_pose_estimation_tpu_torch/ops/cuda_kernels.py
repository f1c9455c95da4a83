"""Kernels K2 (spread + response maps, ``csrc/spread_response.cu``), K3
(cv::linemod's 16 x 16 local walk, ``csrc/walk_scores.cu``), K5 (dense
window scores around coarse candidates, ``csrc/refine_scores.cu``), XS
(the exact coarse scorer, ``csrc/exact_scores.cu``), TK (the
exhaustive select's top-k, ``csrc/select_topk.cu``) and BM (the pooled
tiers' bound margins, ``csrc/bound_margins.cu``), each with its plain
PyTorch version beside it.

K2 replaces ``linemod_pose_estimation_tpu/ops/pallas_kernels.py::
spread_response_batched``; K3 replaces ``walk_scores_pallas``; K5
replaces ``refine_scores_pallas``.  XS replaces no Pallas kernel: the
reference's exact coarse scores are an XLA dot_general over one-hot
weights; nor does TK: the reference selects with jax.lax.top_k; nor does
BM: the reference's bounds are a dot_general and a margin max.  A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import tracing
from . import _build
from . import features as F

WIN = 16  # OpenCV's fixed 16 x 16 local similarity map


def spread_rows(B: int, H: int, W: int) -> int:
    """Rows per K2 thread strip: 2 for a large batch (more strips keep more
    stores in flight), 4 otherwise (fewer halo rows re-read); the faster
    of 1-16 at each of the B=32 batch's two levels on an H100."""
    return 2 if B * H * -(-W // 4) >= 1 << 20 else 4


def _response_out(quant: torch.Tensor, out: torch.Tensor | None, channel: int
                  ) -> torch.Tensor:
    """The (B, C, H, W) u8 stack that receives channels [channel, channel
    + 8); a new (B, 8, H, W) one when `out` is None."""
    B, H, W = quant.shape
    if out is None:
        if channel:
            raise ValueError("channel needs out=")
        return torch.empty((B, 8, H, W), dtype=torch.uint8, device=quant.device)
    if (out.dim() != 4 or (out.shape[0], *out.shape[2:]) != (B, H, W)
            or out.dtype != torch.uint8 or out.device != quant.device):
        raise ValueError(f"out: expected a uint8 (B={B}, C, H={H}, W={W}) tensor on "
                         f"{quant.device}, got {out.dtype} {tuple(out.shape)} on {out.device}")
    if not 0 <= channel <= out.shape[1] - 8:
        raise ValueError(f"channel={channel}: out has {out.shape[1]} channels, needs 8 from it")
    return out


def spread_response_plain(quant: torch.Tensor, T: int, out: torch.Tensor | None = None,
                          channel: int = 0) -> torch.Tensor:
    """(B, H, W) u8 bitmasks -> (B, 8, H, W) u8 response maps, written
    into channels [channel, channel + 8) of `out` (B, C, H, W) when given;
    returns that channel slice."""
    out = _response_out(quant, out, channel)
    view = out[:, channel:channel + 8]
    view.copy_(F.response_maps(F.orientation_spread(quant, T)))
    return view


def spread_response(quant: torch.Tensor, T: int, out: torch.Tensor | None = None,
                    channel: int = 0) -> torch.Tensor:
    """T x T OR-spread over offsets [0, T) (zero past the frame edge),
    then the graded 4/3/2/1/0 response LUT: (B, H, W) u8 -> (B, 8, H, W)
    u8, bit-identical to the plain version.  With `out` (B, C, H, W) u8,
    the 8 planes go straight into its channels [channel, channel + 8) and
    the other channels are left as they are; returns that channel slice.
    The kernel takes T in [1, 8]."""
    if quant.device.type == "cpu":
        return spread_response_plain(quant, T, out, channel)
    if quant.dim() != 3:
        raise ValueError(f"quant: expected (B, H, W), got {tuple(quant.shape)}")
    if not 1 <= T <= 8:
        raise ValueError(f"T={T}: the kernel spreads over 1 to 8 pixels")
    _build.require(quant, "quant", torch.uint8)
    out = _response_out(quant, out, channel)
    _build.require(out, "out", torch.uint8)
    B, H, W = quant.shape
    lib = _build.library()
    err = lib.lpe_spread_response(quant.data_ptr(), out.data_ptr(), B, H, W, T,
                                  out.shape[1], channel, spread_rows(B, H, W),
                                  *_build.device_and_stream(quant))
    _build.check(err, "spread_response")
    tracing.count("launch.spread_response")
    return out[:, channel:channel + 8]


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
    candidate slot, two placements a thread, the slot's in-frame live
    features compacted in shared memory and read 16 at a time.  Operands:
    R0 (B, C, H, W) u8 with C * H * W < 2^31; oris/dys/dxs (B, K, F) int32
    (offsets already clipped to [0, E0]); live (B, K, F) bool; gy0/gx0 (B,
    K) int32; n_valid (B,) int32."""
    if R0.device.type == "cpu":
        return walk_scores_plain(R0, oris, dys, dxs, live, gy0, gx0, n_valid, T)
    if R0.dim() != 4:
        raise ValueError(f"R0: expected (B, C, H, W), got {tuple(R0.shape)}")
    B, C, H, W = R0.shape
    K, Fmax = oris.shape[1:]
    if C * H * W >= 1 << 31:
        raise ValueError(f"R0: a frame of {C * H * W} bytes; K3 indexes one in int32")
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
    if out.numel() == 0:
        return out
    lib = _build.library()
    err = lib.lpe_walk_scores(
        R0.data_ptr(), oris.data_ptr(), dys.data_ptr(), dxs.data_ptr(),
        live.data_ptr(), gy0.data_ptr(), gx0.data_ptr(), n_valid.data_ptr(),
        out.data_ptr(), B, C, H, W, K, Fmax, T, *_build.device_and_stream(R0),
    )
    _build.check(err, "walk_scores")
    tracing.count("launch.walk_scores")
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


# K5 adds a word-alignment residual of up to 3 to a byte offset in a frame
# and keeps the sum in int32.
K5_MAX_FRAME_BYTES = (1 << 31) - 4


def words_readable(R: torch.Tensor) -> bool:
    """Whether R's storage covers the aligned 32-bit words around R's first
    and last byte, so that a kernel may read any word that holds a byte of
    R (K5 reads bytes only when it does not)."""
    storage = R.untyped_storage()
    lo = storage.data_ptr()
    first = R.data_ptr()
    end = first + R.numel() * R.element_size()
    return first // 4 * 4 >= lo and -(-end // 4) * 4 <= lo + storage.nbytes()


def check_window_frame(C: int, H: int, W: int, window: int) -> None:
    """Raise for a (C, H, W) frame or a window that K5 does not take."""
    if window < 1:
        raise ValueError(f"window={window}: K5 needs at least one cell")
    if C * H * W > K5_MAX_FRAME_BYTES:
        raise ValueError(f"R: a frame of {C * H * W} bytes; K5 indexes one in int32")


def refine_scores(R, oris, dys, dxs, nf, anchor_y, anchor_x,
                  window: int = 24, frame_idx=None) -> torch.Tensor:
    """K5: raw window scores (K, window, window) int32, for any window >= 1.
    What bounds it is the gather between L2 and the SMs, not device
    memory: each feature reads `window` rows of `window` bytes at an
    arbitrary byte offset, each row in its own cache line, far more rows
    than L1 keeps.  So eight lanes share a row segment of 28 cells: each
    loads one aligned 32-bit word, takes its neighbour's by shuffle and
    shifts the pair by the misalignment (one L1 pass and one or two L2
    sectors fetch a whole row), and a block (one per candidate, and per window tile past 512 threads) takes 8
    staged features a step with no mask when all of them read inside the
    frame, else a walk that masks byte by byte.  Operands: R (C, H, W) or
    (B, C, H, W) u8, any W and any data pointer, C * H * W below 2^31, with
    frame_idx (K,) int32 selecting each candidate's frame (None: frame 0);
    oris/dys/dxs (K, F) int32 (the refiners clip the offsets to [0, E0]);
    nf/anchor_y/anchor_x (K,) int32.  Live feature slots must sit at [0,
    nf) (the refiners compact them); nf above F counts as F."""
    if R.device.type == "cpu":
        return refine_scores_plain(R, oris, dys, dxs, nf, anchor_y, anchor_x,
                                   window, frame_idx)
    K, Fmax = oris.shape
    R, frame_idx = _as_batched(R, frame_idx, K)
    B, C, H, W = R.shape
    check_window_frame(C, H, W, window)
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
        frame_idx.data_ptr(), out.data_ptr(), B, C, H, W, K, Fmax, window,
        int(words_readable(R)), *_build.device_and_stream(R),
    )
    _build.check(err, "refine_scores")
    tracing.count("launch.refine_scores")
    return out


# ---------------------------------------------------------------------------
# XS: the exact coarse scorer
# ---------------------------------------------------------------------------

XS_ROW_CELLS = 20  # cells a lane of the every-cell geometry holds along a row
XS_STAGE_BYTES = 115_200  # a stage buffer; two of them fit the card's 227 KB


class ExactGeometry(NamedTuple):
    """The every-cell launch's band geometry: BH cell rows a block, lane-
    major planes of Hp rows of XS bytes, LS lanes a shared-memory stage."""

    BH: int
    Hp: int
    XS: int
    LS: int


def exact_geometry(Hc: int, Wc: int, Kc: int, L: int) -> ExactGeometry:
    """A warp holds BH cell rows of ceil(Wc / 20) lanes each; the row pitch
    XS (a multiple of 8 bytes, for 8-byte copies) is the shortest that
    holds a lane's 6-word read at any cell shift and, where one exists
    within 32 words, puts the 32 lanes' words in 32 banks."""
    segs = -(-Wc // XS_ROW_CELLS)
    if segs > 32:
        raise ValueError(f"Wc={Wc}: the exact scorer takes at most {32 * XS_ROW_CELLS} "
                         "cells a row")
    nbands = -(-Hc // (32 // segs))
    BH = -(-Hc // nbands)
    words = (Kc - 1) // 4 + segs * XS_ROW_CELLS // 4 + 1
    words += words % 2
    lanes = [(r, s) for r in range(BH) for s in range(segs)]
    for w in range(words, words + 32, 2):
        if len({(r * w + s * XS_ROW_CELLS // 4) % 32 for r, s in lanes}) == len(lanes):
            words = w
            break
    XS = 4 * words
    BHs = BH + Kc - 1
    LS = min(L, XS_STAGE_BYTES // (BHs * XS))
    if LS < 1:
        raise ValueError(f"Kc={Kc}, Wc={Wc}: a lane's band does not fit a stage")
    return ExactGeometry(BH, nbands * BH + Kc - 1, XS, LS)


def exact_planes(Rb: torch.Tensor, T: int, Kc: int, g: ExactGeometry) -> torch.Tensor:
    """(B, C, H, W) responses -> lane-major planes (B, C*T*T, g.Hp, g.XS)
    u8: plane c*T*T + ry*T + rx holds R[c, i*T + ry, j*T + rx] at (i, j),
    zero past (H // T, W // T)."""
    B, C, H, W = Rb.shape
    Hc, Wc = H // T, W // T
    out = torch.zeros((B, C, T, T, g.Hp, g.XS), dtype=torch.uint8, device=Rb.device)
    out[..., :Hc, :Wc] = (Rb[:, :, :Hc * T, :Wc * T].reshape(B, C, Hc, T, Wc, T)
                          .permute(0, 1, 3, 5, 2, 4))
    return out.view(B, C * T * T, g.Hp, g.XS)


def _exact_rows(Rb: torch.Tensor, T: int, frame, pos):
    """(frame, pos) int64 of the rows asked for: every cell of every frame
    when both are None."""
    B, _, H, W = Rb.shape
    if (frame is None) != (pos is None):
        raise ValueError("frame and pos: give both or neither")
    if frame is None:
        P = (H // T) * (W // T)
        dev = Rb.device
        return (torch.arange(B, device=dev).repeat_interleave(P),
                torch.arange(P, device=dev).repeat(B))
    return frame.reshape(-1).long(), pos.reshape(-1).long()


# (row, table slot) pairs exact_scores_plain gathers at a time
XS_PLAIN_CHUNK = 1 << 24


def exact_scores_plain(Rb: torch.Tensor, table: torch.Tensor, T: int, Kc: int,
                       frame: torch.Tensor | None = None, pos: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Raw exact coarse scores (M, N) int32: row m (frame[m], cell pos[m]
    = py * Wc + px; every cell of every frame when both are None) and
    template n sum, over n's live table entries e = ((qy*Kc + qx)*C + c)
    *T*T + ry*T + rx, the response R[frame, c, (py + qy)*T + ry, (px + qx)
    *T + rx], zero past the frame's Hc*T x Wc*T crop."""
    B, C, H, W = Rb.shape
    Hc, Wc = H // T, W // T
    L = C * T * T
    dev = Rb.device
    frame, pos = _exact_rows(Rb, T, frame, pos)
    Hpx, Wpx = (Hc + Kc) * T, (Wc + Kc) * T
    Rp = torch.zeros((B, C, Hpx, Wpx), dtype=torch.int32, device=dev)
    Rp[:, :, :Hc * T, :Wc * T] = Rb[:, :, :Hc * T, :Wc * T]
    Rp = Rp.reshape(-1)
    live = table >= 0
    e = table.clamp(min=0).long()
    lane, cell = e % L, e // L
    qy, qx = cell // Kc, cell % Kc
    c, ry, rx = lane // (T * T), lane // T % T, lane % T
    feat = (c * Hpx + qy * T + ry) * Wpx + qx * T + rx  # (N, F)
    base = (frame * C * Hpx + torch.div(pos, Wc, rounding_mode="floor") * T) * Wpx \
        + pos % Wc * T  # (M,)
    N, Fw = table.shape
    out = torch.empty((base.shape[0], N), dtype=torch.int32, device=dev)
    step = max(1, XS_PLAIN_CHUNK // max(1, N * Fw))
    for m0 in range(0, base.shape[0], step):
        v = Rp[base[m0:m0 + step, None, None] + feat[None]]
        out[m0:m0 + step] = torch.where(live, v, 0).sum(dim=2, dtype=torch.int32)
    return out


def exact_scores(Rb: torch.Tensor, table: torch.Tensor, T: int, Kc: int,
                 frame: torch.Tensor | None = None, pos: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """XS: the exact coarse scores of exact_scores_plain, (M, N) int32,
    bit for bit (and so the one-hot int8 GEMM's rows), as a gather-sum
    straight from the linearized planes.  With frame and pos None it scores
    every cell of every frame (M = B * Hc * Wc, the exhaustive scorer) from
    lane-major planes in bands of cell rows; with a row list (frame, pos)
    (M,) it scores those rows from lanes-last planes, two rows a block.
    Operands: Rb (B, C, H, W) u8 responses in [0, 4] (the response LUT's
    range: the every-cell launch sums 63 features in a byte); table (N, F)
    int32, the GEMM row of each live feature or -1 (F <= 256), every entry
    below Kc*Kc*C*T*T."""
    if Rb.device.type == "cpu":
        return exact_scores_plain(Rb, table, T, Kc, frame, pos)
    if Rb.dim() != 4:
        raise ValueError(f"Rb: expected (B, C, H, W), got {tuple(Rb.shape)}")
    B, C, H, W = Rb.shape
    Hc, Wc = H // T, W // T
    L = C * T * T
    N, Fw = table.shape
    if Fw > 256:
        raise ValueError(f"table: {Fw} slots a template; the kernel takes at most 256")
    if Kc * Kc * L >= 1 << 31:
        raise ValueError(f"Kc={Kc}, C*T*T={L}: a GEMM row index past int32")
    _build.require(Rb, "Rb", torch.uint8)
    dev = Rb.device
    if Fw % 4:
        table = torch.nn.functional.pad(table, (0, -Fw % 4), value=-1)
    table = table.contiguous()
    _build.require(table, "table", torch.int32, device=dev)
    every_cell = frame is None and pos is None
    if not every_cell:
        frame, pos = (a.contiguous() for a in _exact_rows(Rb, T, frame, pos))
        _build.require(frame, "frame", torch.int64, pos.shape, dev)
        _build.require(pos, "pos", torch.int64, frame.shape, dev)
    M_ = B * Hc * Wc if every_cell else frame.shape[0]
    out = torch.empty((M_, N), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    if every_cell:
        g = exact_geometry(Hc, Wc, Kc, L)
        planes = exact_planes(Rb, T, Kc, g)
        rows = (None, None)
    else:
        g = ExactGeometry(0, 0, 0, 0)
        planes = F.linearize_responses_lanes(Rb, T, Kc)
        rows = (frame.data_ptr(), pos.data_ptr())
        table = table.view(N, -1, 4).transpose(0, 1).contiguous()  # (F / 4, N, 4)
    lib = _build.library()
    err = lib.lpe_exact_scores(
        planes.data_ptr(), *rows, table.data_ptr(), out.data_ptr(), B, out.shape[0], L,
        Hc, Wc, Kc, N, table.numel() // N, g.Hp, g.XS, g.BH, g.LS,
        *_build.device_and_stream(Rb))
    _build.check(err, "exact_scores")
    tracing.count("launch.exact_scores")
    return out


# ---------------------------------------------------------------------------
# TK: the exhaustive select's top-k
# ---------------------------------------------------------------------------

SELECT_MAX_K = 512  # the largest k TK takes: the detector's top_k
SELECT_STEP = 16384  # elements of a frame a TK block takes at a time (the kernel's STEP)
SELECT_MAX_BLOCKS = 512  # blocks a frame at most


def topk_first_index(vals: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim of f32 or int32 `vals`, ties broken by the
    LOWER index first (JAX top_k's order), via one topk on a unique int64
    key: the value (a float's order-preserving int32 image), then the
    inverted index."""
    if vals.dtype == torch.int32:
        key32 = vals.to(torch.int64)
    else:
        bits = vals.contiguous().view(torch.int32)
        key32 = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    n = vals.shape[-1]
    inv = (0xFFFFFFFF - torch.arange(n, device=vals.device, dtype=torch.int64))
    _, idx = torch.topk(key32 * (1 << 32) + inv, k, dim=-1, largest=True, sorted=True)
    return torch.gather(vals, -1, idx), idx


def select_topk_plain(raw: torch.Tensor, scale: torch.Tensor, vpos: torch.Tensor, k: int,
                      lo: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of sim = where(vpos, raw[:, :, lo:lo + N] * scale, -1.0)
    in each frame of raw (B, P, >= lo + N) int32, over the window's flat
    index p * N + n, the lower index first on ties: (vals (B, k) f32, idx
    (B, k) int64).  scale (N,) f32 and vpos (P, N) bool are the window's;
    the window is the whole row by default."""
    N = scale.shape[0]
    out = []
    for b in range(raw.shape[0]):  # one frame at a time bounds the (P*N) key memory
        win = raw[b, :, lo:lo + N].to(torch.float32)
        sim = torch.where(vpos, win * scale[None, :], -1.0).reshape(-1)
        out.append(topk_first_index(sim, k))
    vals, idx = zip(*out)
    return torch.stack(vals), torch.stack(idx)


def select_topk(raw: torch.Tensor, scale: torch.Tensor, vpos: torch.Tensor, k: int,
                lo: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """TK: select_topk_plain's (vals, idx), bit for bit, for all B frames in
    one call and with no host sync: an exact radix select on sim's order
    key over the window read three times in place (no copy of its
    columns), the keys made as it is read (none is written), the ties kept
    by index order (csrc/select_topk.cu).  What bounds it is the window's
    bytes.  Operands: raw (B, P, ld) int32 with P * ld < 2^31; the window
    columns [lo, lo + N) with N = scale's length and P * N < 2^30; scale
    (N,) f32; vpos (P, N) bool; 1 <= k <= min(512, P * N)."""
    if raw.device.type == "cpu":
        return select_topk_plain(raw, scale, vpos, k, lo)
    if raw.dim() != 3:
        raise ValueError(f"raw: expected (B, P, N), got {tuple(raw.shape)}")
    B, P, ld = raw.shape
    N = scale.shape[0]
    if not (0 <= lo and lo + N <= ld):
        raise ValueError(f"the window [{lo}, {lo} + {N}) does not lie in raw's {ld} columns: "
                         "scale's shape (N,) gives its width")
    if P * ld >= 1 << 31:
        raise ValueError(f"P * ld = {P * ld}: TK indexes a frame of raw in int32")
    n = P * N
    if not 1 <= k <= min(SELECT_MAX_K, n):
        raise ValueError(f"k={k}: TK takes 1 to min({SELECT_MAX_K}, P * N = {n})")
    if n >= 1 << 30:
        raise ValueError(f"P * N = {n}: TK indexes a frame in int32")
    dev = raw.device
    raw, scale, vpos = raw.contiguous(), scale.contiguous(), vpos.contiguous()
    _build.require(raw, "raw", torch.int32)
    _build.require(scale, "scale", torch.float32, (N,), dev)
    _build.require(vpos, "vpos", torch.bool, (P, N), dev)
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, k), dtype=torch.int64, device=dev)
    if B == 0:
        return vals, idx
    # blocks a frame: about four a multiprocessor over the batch, each at
    # least one step of the frame
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    G = max(1, min(SELECT_MAX_BLOCKS, -(-n // SELECT_STEP), 4 * sms // B))
    i32 = dict(dtype=torch.int32, device=dev)
    hist = torch.zeros((2, B, 1 << 16), **i32)
    state = torch.empty((B, 4), **i32)
    cand = torch.empty((2, B, SELECT_MAX_K), **i32)
    cand_cnt = torch.zeros(B, **i32)
    eq_idx = torch.empty((B, G, k), **i32)
    eq_cnt = torch.empty((B, G), **i32)
    lib = _build.library()
    err = lib.lpe_select_topk(
        raw.data_ptr(), scale.data_ptr(), vpos.data_ptr(), hist.data_ptr(), state.data_ptr(),
        cand[0].data_ptr(), cand[1].data_ptr(), cand_cnt.data_ptr(), eq_idx.data_ptr(),
        eq_cnt.data_ptr(), vals.data_ptr(), idx.data_ptr(), B, P, N, ld, lo, k, G,
        *_build.device_and_stream(raw))
    _build.check(err, "select_topk")
    tracing.count("launch.select_topk")
    return vals, idx


# ---------------------------------------------------------------------------
# BM: the pooled tiers' bound margins
# ---------------------------------------------------------------------------

BM_ROWS, BM_COLS = 128, 256  # BM's output tile: rows, templates
INT32_MIN = -(2**31)


def int8_product(a: torch.Tensor, nk: torch.Tensor, n: int) -> torch.Tensor:
    """(m, k) int8 x the first n rows of the K-major (>= n, k) int8 weight
    nk, transposed -> (m, n) int32, exact (torch._int_mm).  cuBLASLt's
    int8 path takes m > 16, so short operands are zero-padded on the card."""
    m = a.shape[0]
    if a.is_cuda and m <= 16:
        a = torch.nn.functional.pad(a, (0, 0, 0, 17 - m))
    return torch._int_mm(a.contiguous(), nk.t())[:m, :n]


def bound_margins_plain(A: torch.Tensor, nk: torch.Tensor, n: int, t: torch.Tensor,
                        vpos: torch.Tensor, pos: torch.Tensor | None = None,
                        keep: torch.Tensor | None = None, sentinel: int = INT32_MIN
                        ) -> torch.Tensor:
    """Row margins (M,) int32: max over the n templates of (valid ?
    ub - t : sentinel), ub = A (M, K) int8 times nk's first n rows (the
    int8 bound), valid = vpos[row's position] & keep[row]; the position is
    pos[m], or m % P with pos None (the rows of every position of B
    frames); keep None keeps every row.  vpos (P, n) bool, t (n,) int32."""
    M = A.shape[0]
    rows = torch.arange(M, device=A.device) % vpos.shape[0] if pos is None else pos.long()
    valid = vpos[rows]
    if keep is not None:
        valid = valid & keep[:, None]
    return torch.where(valid, int8_product(A, nk, n) - t[None, :], sentinel).amax(dim=1)


def bound_margins(A: torch.Tensor, nk: torch.Tensor, n: int, t: torch.Tensor,
                  vpos: torch.Tensor, pos: torch.Tensor | None = None,
                  keep: torch.Tensor | None = None, sentinel: int = INT32_MIN
                  ) -> torch.Tensor:
    """BM: bound_margins_plain's (M,) int32, bit for bit, with the int8
    product and its epilogue in one kernel (csrc/bound_margins.cu): no (M,
    n) bound or mask reaches device memory.  What bounds it is the int8
    tensor cores.  Operands as the plain version's, n >= 1; a contraction
    K off a multiple of 16 (the tensor maps' stride unit) is zero-padded,
    and validity rows off a multiple of 8 bytes are copied padded."""
    if A.device.type == "cpu":
        return bound_margins_plain(A, nk, n, t, vpos, pos, keep, sentinel)
    if A.dim() != 2 or nk.dim() != 2 or nk.shape[1] != A.shape[1]:
        raise ValueError(f"A (M, K) and nk (>= n, K): got {tuple(A.shape)}, {tuple(nk.shape)}")
    M, K = A.shape
    if not 1 <= n <= nk.shape[0]:
        raise ValueError(f"n={n}: nk has {nk.shape[0]} rows")
    if not INT32_MIN <= sentinel < 2**31:
        raise ValueError(f"sentinel={sentinel} is not an int32")
    dev = A.device
    P = vpos.shape[0]
    if K % 16:
        A = torch.nn.functional.pad(A, (0, -K % 16))
        nk = torch.nn.functional.pad(nk, (0, -K % 16))
    A, nk = A.contiguous(), nk.contiguous()
    A = A if A.data_ptr() % 16 == 0 else A.clone()
    nk = nk if nk.data_ptr() % 16 == 0 else nk.clone()
    _build.require(A, "A", torch.int8, device=dev)
    _build.require(nk, "nk", torch.int8, device=dev)
    vpos = vpos.contiguous()
    _build.require(vpos, "vpos", torch.bool, (P, n), dev)
    if n % 8 or vpos.data_ptr() % 8:  # the kernel reads a row in aligned 8-byte chunks
        vpos = torch.nn.functional.pad(vpos, (0, -n % 8))
    _build.require(t, "t", torch.int32, (n,), dev)
    n_tiles, m_tiles = -(-n // BM_COLS), -(-M // BM_ROWS)
    t = torch.nn.functional.pad(t, (0, n_tiles * BM_COLS - n))
    if pos is not None:
        pos = pos.contiguous()
        _build.require(pos, "pos", torch.int64, (M,), dev)
    if keep is not None:
        _build.require(keep, "keep", torch.bool, (M,), dev)
        keep = torch.nn.functional.pad(keep.to(torch.uint8), (0, m_tiles * BM_ROWS - M))
    out = torch.full((M,), INT32_MIN, dtype=torch.int32, device=dev)
    if M == 0:
        return out
    lib = _build.library()
    err = lib.lpe_bound_margins(
        A.data_ptr(), nk.data_ptr(), t.data_ptr(), vpos.data_ptr(),
        None if pos is None else pos.data_ptr(), None if keep is None else keep.data_ptr(),
        out.data_ptr(), M, n, nk.shape[0], A.shape[1], P, vpos.shape[1], sentinel,
        *_build.device_and_stream(A))
    _build.check(err, "bound_margins")
    tracing.count("launch.bound_margins")
    return out
