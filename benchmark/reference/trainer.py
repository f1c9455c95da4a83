"""The plain reference of the offline trainer for a sample of views: each
view rendered alone by the frozen copy of the plain z-buffer scan,
quantized at both pyramid levels by the frozen copy of the plain
modalities, and its features extracted from the whole frame.

The extraction below is a frozen copy of the program's
``models/templates.py`` (OpenCV's selectScatteredFeatures, the gradient
and normal candidates, cropTemplates), kept as it was; the program
extracts from a window of each view, pipelined a chunk at a time, and
claims the same features as the whole frame gives.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.ndimage import distance_transform_edt

from . import features as F
from .pose.renderer import _pad_triangles, render
from .viewsphere import ViewSphereParams, generate_views

# The program's TrainerConfig() defaults (the reference system's renderer
# node): 640x480, these focal lengths, ColorGradient (weak 10, strong 55)
# and DepthNormal (2000 mm, 50 mm, extract threshold 2), 63 features each.
WIDTH, HEIGHT = 640, 480
FX, FY = 535.566011, 537.168115
WEAK, STRONG, NUM = 10.0, 55.0, 63
DIST, DIFF, EXTRACT = 2000.0, 50.0, 2
T_PYRAMID = (5, 8)


def _select_scattered(candidates: np.ndarray, scores: np.ndarray, num: int) -> np.ndarray:
    order = np.argsort(-scores, kind="stable")
    return _select_from_sorted(candidates[order], num)


def _select_from_sorted(cand: np.ndarray, num: int) -> np.ndarray:
    n = cand.shape[0]
    if n == 0:
        return cand
    distance = float(n / num + 1)
    cap = min(num, n)
    cy = cand[:, 0].astype(np.float64)
    cx = cand[:, 1].astype(np.float64)
    mind2 = np.full(n, np.inf)
    kept_idx: list[int] = []
    while len(kept_idx) < cap and distance >= 1.0:
        d2 = distance * distance
        passing = np.nonzero(mind2 >= d2)[0]
        for j in passing:
            if mind2[j] >= d2:
                kept_idx.append(j)
                np.minimum(mind2, (cy - cy[j]) ** 2 + (cx - cx[j]) ** 2, out=mind2)
                if len(kept_idx) == cap:
                    break
        if len(kept_idx) == cap:
            break
        s = float(np.sqrt(mind2.max()))
        distance -= max(1.0, float(np.ceil(distance - s)))
    return cand[kept_idx].copy() if kept_idx else cand[:0].copy()


def _bit_to_index(bitmask: np.ndarray) -> np.ndarray:
    return np.argmax((bitmask[..., None] >> np.arange(8)) & 1, axis=-1).astype(np.int32)


def _gradient_features(mask, quant, mag2):
    sel = (quant != 0) & (mag2 > STRONG ** 2) & (mask > 0)
    ys, xs = np.nonzero(sel)
    if ys.size < NUM // 2 or ys.size == 0:
        return None
    cand = np.stack([ys, xs, _bit_to_index(quant[ys, xs])], axis=1).astype(np.int32)
    feats = _select_scattered(cand, mag2[ys, xs], NUM)
    return feats if feats.shape[0] >= NUM // 2 else None


def _normal_features(mask, quant):
    dist = distance_transform_edt(mask > 0)
    sel = (quant != 0) & (dist > EXTRACT)
    ys, xs = np.nonzero(sel)
    if ys.size == 0:
        return None
    cand = np.stack([ys, xs, _bit_to_index(quant[ys, xs])], axis=1).astype(np.int32)
    feats = _select_scattered(cand, dist[ys, xs], NUM)
    return feats if feats.shape[0] >= NUM // 2 else None


def extract(mask: np.ndarray, grad: list, norm: list) -> dict | None:
    """One view's template from its whole-frame quantizations (per level
    (bitmask, squared magnitude) and normal bitmask): grad, norm (per level
    (F, 3) rows (y, x, ori)), size (per level (h, w)), rect0; None when
    the view has too few features."""
    grad_l, norm_l = [], []
    cur = (mask > 0).astype(np.uint8)
    for lv in range(len(T_PYRAMID)):
        g = _gradient_features(cur, *grad[lv])
        if g is None:
            return None
        n = _normal_features(cur, norm[lv])
        if n is None:
            return None
        grad_l.append(g)
        norm_l.append(n)
        cur = cur[::2, ::2]
    cat = np.concatenate([fl[:, :2].astype(np.int64) << lv
                          for lv in range(len(T_PYRAMID)) for fl in (grad_l[lv], norm_l[lv])])
    y0, x0 = cat[:, 0].min(), cat[:, 1].min()
    y1, x1 = cat[:, 0].max(), cat[:, 1].max()
    sizes = []
    for lv in range(len(T_PYRAMID)):
        o = np.array([int(y0) >> lv, int(x0) >> lv, 0], np.int32)
        grad_l[lv] = grad_l[lv] - o
        norm_l[lv] = norm_l[lv] - o
        sizes.append((int(y1 - y0) >> lv, int(x1 - x0) >> lv))
    return dict(grad=grad_l, norm=norm_l, size=sizes,
                rect0=(int(x0), int(y0), int(x1 - x0 + 1), int(y1 - y0 + 1)))


def views(max_views: int):
    """The view sphere's first `max_views` views, as the trainer walks it."""
    return generate_views(ViewSphereParams())[:max_views]


def train_views(triangles: np.ndarray, view_ids, max_views: int, device="cuda",
                dtype=torch.float32, batch: int = 16, width: int = WIDTH,
                height: int = HEIGHT, fx: float = FX, fy: float = FY) -> dict:
    """view id -> None (skipped) or its template dict with R, T, K, D,
    Ori_dist and Rect beside the features."""
    dev = torch.device(device)
    tris = torch.from_numpy(_pad_triangles(np.asarray(triangles, np.float32), 64)).to(dev)
    K = torch.tensor([[fx, 0, width / 2.0], [0, fy, height / 2.0], [0, 0, 1]],
                     dtype=torch.float32, device=dev)
    K_np = K.cpu().numpy()
    vs = views(max_views)
    ids = [int(i) for i in view_ids]
    out: dict = {}
    for s in range(0, len(ids), batch):
        chunk = [vs[i] for i in ids[s:s + batch]]
        Rs = torch.from_numpy(np.stack([v.R.astype(np.float32) for v in chunk])).to(dev)
        Ts = torch.from_numpy(np.stack([v.T.astype(np.float32) for v in chunk])).to(dev)
        r = render(tris, Rs, Ts, K.expand(len(chunk), 3, 3), width, height)
        q0, m0 = F.quantize_color_gradient(r.rgb, WEAK, dtype)
        rgb1 = torch.stack([F.pyr_down(r.rgb[..., c]) for c in range(3)], -1)
        q1, m1 = F.quantize_color_gradient(rgb1, WEAK, dtype)
        n0 = F.quantize_depth_normal(r.depth_mm, DIST, DIFF, dtype=dtype)
        host = [a.cpu().numpy() for a in (r.mask, r.rect, r.depth_mm, q0, m0, q1, m1, n0)]
        mask, rect, depth, q0, m0, q1, m1, n0 = host
        for j, (i, v) in enumerate(zip(ids[s:s + batch], chunk)):
            t = None
            if rect[j, 2] != 0 and rect[j, 3] != 0:
                t = extract(mask[j], [(q0[j], m0[j]), (q1[j], m1[j])],
                            [n0[j], n0[j][::2, ::2]])
            if t is not None:
                cd = float(depth[j, height // 2, width // 2]) / 1000.0
                t.update(R=v.R, T=v.T, K=K_np, D=v.D_obj - float(cd), Ori_dist=v.D_obj,
                         Rect=rect[j].copy())
            out[i] = t
    return out
