"""The plain reference of cv::linemod's matcher: the two-level response
pyramid, every template scored at every coarse position by a direct sum,
the top-k selection and the exact 16 x 16 local walk.

Straightforward by design: no pruning, no pooling, no GEMM, no kernel.  A
coarse score is the sum over a template's features of the level-1
response at (position + offset), read as zero past the cropped grid; the
walk scores the 16 x 16 placements around a candidate at level 0.  The
float expressions (similarity scales, thresholds) are the engine's, so
every selected candidate and every walked match is reproduced exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import features as F
from .bank import Bank

WIN = 16  # OpenCV's fixed 16 x 16 local similarity map


class Matches(NamedTuple):
    """Refined matches in top-k slot order (mask by `valid`)."""

    template_id: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    similarity: torch.Tensor
    valid: torch.Tensor


def _topk_first_index(vals: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, ties broken by the lower index first."""
    if vals.dtype == torch.int32:
        key32 = vals.to(torch.int64)
    else:
        bits = vals.contiguous().view(torch.int32)
        key32 = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    n = vals.shape[-1]
    inv = (0xFFFFFFFF - torch.arange(n, device=vals.device, dtype=torch.int64))
    _, idx = torch.topk(key32 * (1 << 32) + inv, k, dim=-1, largest=True, sorted=True)
    return torch.gather(vals, -1, idx), idx


def preprocess(rgbs: torch.Tensor, depths_mm: torch.Tensor | None, bank: Bank,
               dtype: torch.dtype = torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, 3) u8 [+ (B, H, W) mm] -> response stacks R0 (B, C, H, W),
    R1 (B, C, H/2, W/2) u8; C = 8 per modality, ColorGradient first.
    Level 1 quantizes the pyrDown of each colour channel and subsamples
    the level-0 normals."""
    T0, T1 = bank.T
    use_depth = "DepthNormal" in bank.modalities

    def respond(q, T):
        return F.response_maps(F.orientation_spread(q, T))

    q0 = F.quantize_color_gradient(rgbs, bank.weak_threshold, dtype)[0]
    rgb1 = torch.stack([F.pyr_down(rgbs[..., c].to(torch.float32)) for c in range(3)], -1)
    q1 = F.quantize_color_gradient(rgb1, bank.weak_threshold, dtype)[0]
    r0, r1 = [respond(q0, T0)], [respond(q1, T1)]
    if use_depth:
        n0 = F.quantize_depth_normal(depths_mm, bank.distance_threshold,
                                     bank.difference_threshold, dtype=dtype)
        r0.append(respond(n0, T0))
        r1.append(respond(n0[:, ::2, ::2], T1))
    return torch.cat(r0, 1), torch.cat(r1, 1)


class _Packed(NamedTuple):
    dy: torch.Tensor  # (N, F) int64
    dx: torch.Tensor
    ori: torch.Tensor
    live: torch.Tensor  # (N, F) bool
    count: torch.Tensor  # (N,) int64
    size: torch.Tensor  # (N, 2) int64 (h, w)


def _pack(rows: list[np.ndarray], size: np.ndarray, device) -> _Packed:
    N = len(rows)
    Fm = max(len(r) for r in rows)
    a = np.zeros((N, Fm, 3), np.int64)
    live = np.zeros((N, Fm), bool)
    for n, r in enumerate(rows):
        a[n, :len(r)] = r
        live[n, :len(r)] = True
    t = lambda x: torch.from_numpy(x).to(device)
    return _Packed(t(a[..., 0]), t(a[..., 1]), t(a[..., 2]), t(live),
                   t(live.sum(1)), t(size.astype(np.int64)))


class ReferenceMatcher:
    """Exact matches of frames against `bank` tiled `reps` times (copy k of
    template i is template k * N + i: the copies score alike, so each
    unique template is scored once).  `order` is the flat order that ties
    fall back on: "position" (position-major, the batched engine's) or
    "template" (template-major, the single-frame engine's); each uses its
    engine's similarity expression.  `dtype` is the float chains'
    precision (float32 as stated; the control runs bfloat16)."""

    def __init__(self, bank: Bank, threshold: float, top_k: int, reps: int = 1,
                 order: str = "position", device="cuda", dtype=torch.float32,
                 block: int = 128):
        if order not in ("position", "template"):
            raise ValueError(f"order={order!r}")
        self.bank, self.threshold, self.top_k, self.reps = bank, threshold, top_k, reps
        self.order, self.device, self.dtype, self.block = order, torch.device(device), dtype, block
        self.f1 = _pack(bank.levels[1], bank.sizes[1], self.device)
        self.f0 = _pack(bank.levels[0], bank.sizes[0], self.device)
        # Level-0 pixel extent of the bank rounded up to 8: the walk clips
        # feature offsets to [0, E0].
        self.E0 = max((int(bank.sizes[0].max()) + 1 + 7) // 8 * 8, 8)

    # -- coarse level ------------------------------------------------------

    def coarse_scores(self, R1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(C, H1, W1) u8 -> raw (N, P) int32 over the Hc x Wc grid
        (P = Hc * Wc, row-major) and its validity (N, P): the template lies
        inside the cropped grid."""
        T = self.bank.T[1]
        C, H1, W1 = R1.shape
        Hc, Wc = H1 // T, W1 // T
        f = self.f1
        pad_y, pad_x = int(f.dy.max()) + 1, int(f.dx.max()) + 1
        Rp = torch.zeros((C, Hc * T + pad_y, Wc * T + pad_x), dtype=torch.uint8,
                         device=R1.device)
        Rp[:, :Hc * T, :Wc * T] = R1[:, :Hc * T, :Wc * T]
        Hp, Wp = Rp.shape[1:]
        flat = Rp.reshape(-1)
        ii = torch.arange(Hc, device=R1.device)
        jj = torch.arange(Wc, device=R1.device)
        posoff = ((ii[:, None] * T) * Wp + jj[None, :] * T).reshape(-1)
        base = f.ori * (Hp * Wp) + f.dy * Wp + f.dx
        N = base.shape[0]
        raw = torch.empty((N, Hc * Wc), dtype=torch.int32, device=R1.device)
        for s in range(0, N, self.block):
            b = base[s:s + self.block]
            v = flat[b[:, :, None] + posoff[None, None, :]].to(torch.int32)
            v = torch.where(f.live[s:s + self.block, :, None], v, 0)
            raw[s:s + self.block] = v.sum(dim=1, dtype=torch.int32)
        h, w = f.size[:, 0:1], f.size[:, 1:2]
        vrow = (ii[None, :] * T + h <= Hc * T)  # (N, Hc)
        vcol = (jj[None, :] * T + w <= Wc * T)  # (N, Wc)
        vpos = (vrow[:, :, None] & vcol[:, None, :]).reshape(N, -1)
        return raw, vpos

    def select(self, raw: torch.Tensor, vpos: torch.Tensor) -> np.ndarray:
        """The top_k coarse candidates at threshold - 5 in slot order:
        (n, 3) int64 rows (template, position, ...) with the similarity
        beside them, ties by the engine's flat order.  Returns (t, pos, sim)
        numpy arrays of the candidates that pass the coarse gate."""
        den = 4.0 * self.f1.count.clamp(min=1).to(torch.float32)
        if self.order == "position":
            scale = torch.full_like(den, 100.0) / den
            sim = raw.to(torch.float32) * scale[:, None]
        else:
            sim = 100.0 * raw.to(torch.float32) / den[:, None]
        sim = torch.where(vpos, sim, -1.0)
        thr = torch.tensor(self.threshold - 5.0, dtype=torch.float32, device=sim.device)
        t, pos = torch.nonzero(sim >= thr, as_tuple=True)
        s = sim[t, pos].cpu().numpy()
        t, pos = t.cpu().numpy(), pos.cpu().numpy()
        N = self.f1.count.shape[0]
        # Every copy of a passing template passes alike.
        t = np.concatenate([t + k * N for k in range(self.reps)])
        pos = np.tile(pos, self.reps)
        s = np.tile(s, self.reps)
        keys = (t, pos) if self.order == "position" else (pos, t)
        idx = np.lexsort((*keys, -s))[:self.top_k]  # last key is the primary
        return t[idx], pos[idx], s[idx]

    # -- the walk ------------------------------------------------------------

    def walk(self, R0: torch.Tensor, t: np.ndarray, pos: np.ndarray, Wc: int) -> dict:
        """cv::linemod's walk of candidates (template t at coarse position
        pos) over the (C, H, W) level-0 responses: numpy arrays template_id,
        x, y, similarity, valid."""
        T0, T1 = self.bank.T
        C, H, W = R0.shape
        N = self.f0.count.shape[0]
        dev = R0.device
        u = torch.from_numpy(t % N).to(dev)
        cy = torch.from_numpy(pos // Wc).to(dev)
        cx = torch.from_numpy(pos % Wc).to(dev)
        off_c = T1 // 2 + (T1 % 2 - 1)
        off_f = T0 // 2 + (T0 % 2 - 1)
        border = 8 * T0
        h0, w0 = self.f0.size[u, 0], self.f0.size[u, 1]
        x = torch.minimum(((cx * T1 + off_c) * 2 + 1).clamp(min=border), W - w0 - border)
        y = torch.minimum(((cy * T1 + off_c) * 2 + 1).clamp(min=border), H - h0 - border)
        gx0 = (torch.div(x, T0, rounding_mode="floor") - 8).clamp(min=0)
        gy0 = (torch.div(y, T0, rounding_mode="floor") - 8).clamp(min=0)
        q = torch.arange(WIN, device=dev)
        dy = self.f0.dy[u].clamp(0, self.E0)
        dx = self.f0.dx[u].clamp(0, self.E0)
        rows = (gy0[:, None, None] + q[None, None, :]) * T0 + dy[:, :, None]  # (n, F, 16)
        cols = (gx0[:, None, None] + q[None, None, :]) * T0 + dx[:, :, None]
        ok = (((rows >= 0) & (rows < H))[..., :, None] & ((cols >= 0) & (cols < W))[..., None, :]
              & self.f0.live[u][:, :, None, None])
        ori = self.f0.ori[u][:, :, None, None]
        v = R0[ori, rows.clamp(0, H - 1)[..., :, None], cols.clamp(0, W - 1)[..., None, :]]
        score = torch.where(ok, v.to(torch.int32), 0).sum(dim=1).reshape(-1, WIN * WIN)
        best = score.argmax(dim=1)  # the first maximum, row-major
        raw = torch.gather(score, 1, best[:, None])[:, 0]
        cnt = self.f0.count[u].clamp(min=1).to(torch.float32)
        sim = 100.0 * raw.to(torch.float32) / (4.0 * cnt)
        thr = torch.tensor(self.threshold, dtype=torch.float32, device=dev)
        host = lambda a: a.cpu().numpy()
        return dict(
            template_id=t.astype(np.int32),
            x=host(((gx0 + best % WIN) * T0 + off_f).to(torch.int32)),
            y=host(((gy0 + torch.div(best, WIN, rounding_mode="floor")) * T0
                    + off_f).to(torch.int32)),
            similarity=host(sim), valid=host(sim >= thr))

    # -- frames ----------------------------------------------------------------

    def match(self, rgbs: np.ndarray, depths_mm: np.ndarray | None) -> list[dict]:
        """Frames (B, H, W, 3) u8 [+ (B, H, W) mm] -> per frame the walked
        candidates in slot order (dicts of numpy arrays; mask by valid)."""
        out = []
        for b in range(rgbs.shape[0]):
            rgb = torch.from_numpy(np.ascontiguousarray(rgbs[b:b + 1])).to(self.device)
            dep = None if depths_mm is None else torch.from_numpy(
                np.ascontiguousarray(depths_mm[b:b + 1], np.float32)).to(self.device)
            R0, R1 = preprocess(rgb, dep, self.bank, self.dtype)
            raw, vpos = self.coarse_scores(R1[0])
            t, pos, _ = self.select(raw, vpos)
            Wc = R1.shape[-1] // self.bank.T[1]
            out.append(self.walk(R0[0], t, pos, Wc))
        return out


def valid_set(m: dict) -> list[tuple]:
    """A frame's valid matches as a sorted list of (template, x, y,
    similarity bits): neighbouring candidates may walk to one match, so an
    entry can repeat."""
    v = np.asarray(m["valid"], bool)
    sims = np.asarray(m["similarity"], np.float32)[v].view(np.int32)
    return sorted(zip(np.asarray(m["template_id"])[v].tolist(), np.asarray(m["x"])[v].tolist(),
                      np.asarray(m["y"])[v].tolist(), sims.tolist()))
