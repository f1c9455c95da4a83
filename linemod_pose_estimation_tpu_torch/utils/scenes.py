"""Synthetic RGB-D bin-picking scenes from the committed 640x480 renders
(``tests/data/render_cache``), numpy only.

The layout follows the reference bench's scenes: a low-texture gradient
background at 1500 mm with three flat distractor blocks, and rendered
object views planted, colour and depth, at random in-frame offsets.
"""

from __future__ import annotations

import glob
import os

import numpy as np

RENDER_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "tests",
                          "data", "render_cache")
BG_MM = 1500.0


def load_views():
    """The committed 640x480 renders, in file-name order: a list of
    (rgb (H, W, 3) u8, depth_mm (H, W) f32, mask (H, W) bool,
    rect (x, y, w, h))."""
    views = []
    for f in sorted(glob.glob(os.path.join(RENDER_DIR, "*.npz"))):
        with np.load(f) as z:
            if z["rgb"].shape[:2] != (480, 640):
                continue
            views.append((z["rgb"].copy(), z["depth_mm"].astype(np.float32),
                          z["mask"] > 0, [int(v) for v in z["rect"]]))
    return views


def background(H: int, W: int, rng: np.random.Generator):
    """Gradient background at BG_MM with three flat distractor blocks."""
    yy, xx = np.mgrid[0:H, 0:W]
    bg = (40 + 60 * yy / H + 30 * np.sin(xx / 200.0)).astype(np.uint8)
    fr = np.stack([bg, (bg * 0.9).astype(np.uint8),
                   (bg * 1.1).clip(0, 255).astype(np.uint8)], -1)
    dp = np.full((H, W), BG_MM, np.float32)
    for _ in range(3):
        y0, x0 = int(rng.integers(0, H - 80)), int(rng.integers(0, W - 120))
        fr[y0:y0 + 80, x0:x0 + 120] = rng.integers(60, 160, size=3)
        dp[y0:y0 + 80, x0:x0 + 120] = float(rng.uniform(1200, 1800))
    return fr, dp


def plant(fr, dp, view, rng: np.random.Generator):
    """Paste a view's object pixels (colour and depth) at a random offset
    that keeps it in frame; returns the object's new (x, y) origin."""
    rgb, vdep, mask, (x, y, w, h) = view
    H, W = dp.shape
    dy = int(rng.integers(-y, H - (y + h)))
    dx = int(rng.integers(-x, W - (x + w)))
    sub = mask[y:y + h, x:x + w]
    tgt = np.s_[y + dy:y + dy + h, x + dx:x + dx + w]
    fr[tgt][sub] = rgb[y:y + h, x:x + w][sub]
    dp[tgt][sub] = vdep[y:y + h, x:x + w][sub]
    return x + dx, y + dy


def golden_batch(seed: int = 0):
    """The 8-frame check batch: each committed 640x480 render planted once,
    shifted, on its own background, plus one frame of background only.
    Returns (rgbs (8, H, W, 3) u8, depths (8, H, W) f32, truths) with
    truths[b] a list of (view index, x, y)."""
    views = load_views()
    rng = np.random.default_rng(seed)
    H, W = views[0][0].shape[:2]
    frames, depths, truths = [], [], []
    for v in range(len(views) + 1):
        fr, dp = background(H, W, rng)
        planted = []
        if v < len(views):
            planted.append((v, *plant(fr, dp, views[v], rng)))
        frames.append(fr)
        depths.append(dp)
        truths.append(planted)
    return np.stack(frames), np.stack(depths), truths


# Templates of the committed RGB-D bank that match golden_crops() at
# threshold 70, then a stride sample of the rest of the bank (64 in all):
# a small bank for the CPU tests.
CROP_MATCHING = [25, 42, 158, 175, 179, 192, 196, 308, 329, 346, 350, 363, 908,
                 1501, 2540]
CROP_BANK_SUBSET = CROP_MATCHING + [
    i for i in range(0, 2652, 53) if i not in CROP_MATCHING][:49]


def golden_crops(frames=(4, 3)):
    """240x320 crops of golden_batch(0) frames centred on their objects:
    (rgbs (n, 240, 320, 3) u8, depths (n, 240, 320) f32)."""
    rgbs, deps, truths = golden_batch(0)
    views = load_views()
    out_r, out_d = [], []
    for b in frames:
        v, x, y = truths[b][0]
        w, h = views[v][3][2:]
        cy = int(np.clip(y + h // 2 - 120, 0, 240))
        cx = int(np.clip(x + w // 2 - 160, 0, 320))
        out_r.append(rgbs[b, cy:cy + 240, cx:cx + 320])
        out_d.append(deps[b, cy:cy + 240, cx:cx + 320])
    return np.stack(out_r), np.stack(out_d)


def bin_picking_batch(B: int, seed: int = 3):
    """B frames, each with two random committed views planted."""
    views = load_views()
    rng = np.random.default_rng(seed)
    H, W = views[0][0].shape[:2]
    frames, depths, truths = [], [], []
    for _ in range(B):
        fr, dp = background(H, W, rng)
        planted = []
        for _ in range(2):
            v = int(rng.integers(0, len(views)))
            planted.append((v, *plant(fr, dp, views[v], rng)))
        frames.append(fr)
        depths.append(dp)
        truths.append(planted)
    return np.stack(frames), np.stack(depths), truths


def cuboid_mesh(dims=(0.088, 0.144, 0.076), subdiv: int = 18):
    """A closed cuboid centred at the origin, (T, 3, 3) f32 triangles.

    The default dimensions (metres, along the object's x, y, z) stand in
    for the boxNew STL the committed banks were trained on: a PCA of the
    model cloud in ``data/sweep_view00_clouds.npz`` gives ~0.148 x 0.093 x
    0.076 m; axis-permuted to the bank's object frame and refined so that
    renders at the bank's own poses and intrinsics reproduce
    ``data/boxNew_rgbd_params.yml.gz``'s Rects within a few pixels.  Each
    face is a grid of quads, `subdiv` segments along the longest edge and
    proportionally fewer along the others: at the default 18, 1952
    triangles (1984 padded to a multiple of 64, boxNew.stl's count).

    Returns a ``utils.stl.Mesh``."""
    from .stl import Mesh, _recompute_normals

    d = np.asarray(dims, np.float64)
    n = [max(1, int(round(subdiv * v / d.max()))) for v in d]
    tris = []
    for ax in range(3):  # the two faces normal to axis `ax`
        u, v = [a for a in range(3) if a != ax]
        gu = np.linspace(-d[u] / 2, d[u] / 2, n[u] + 1)
        gv = np.linspace(-d[v] / 2, d[v] / 2, n[v] + 1)
        for side in (-1.0, 1.0):
            for i in range(n[u]):
                for j in range(n[v]):
                    q = np.zeros((4, 3))
                    q[:, ax] = side * d[ax] / 2
                    q[:, u] = [gu[i], gu[i + 1], gu[i + 1], gu[i]]
                    q[:, v] = [gv[j], gv[j], gv[j + 1], gv[j + 1]]
                    tris += [q[[0, 1, 2]], q[[0, 2, 3]]]
    tris = np.asarray(tris, np.float32)
    return Mesh(triangles=tris, normals=_recompute_normals(tris))


def found_rate(valid, xs, ys, truths, tol: int = 8) -> tuple[int, int]:
    """(found, total): a planted object counts as found when some valid
    match lies within `tol` px of its origin in x and y."""
    ok = total = 0
    for b, planted in enumerate(truths):
        v = np.asarray(valid[b])
        x, y = np.asarray(xs[b]), np.asarray(ys[b])
        for _, px, py in planted:
            total += 1
            ok += bool((v & (np.abs(x - px) <= tol) & (np.abs(y - py) <= tol)).any())
    return ok, total
