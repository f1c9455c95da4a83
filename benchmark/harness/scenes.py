"""The benchmark's traffic generator: synthetic RGB-D bin-picking scenes,
numpy only, from a seed.

A frozen copy of the program's ``utils/scenes.py`` arithmetic (the
gradient background at 1500 mm with three flat distractor blocks, views
planted colour and depth at a random in-frame offset, the cuboid that
stands in for the boxNew mesh, the organized cloud of a depth frame).  The
views are the cuboid rendered at bank poses drawn from the seed, by the
reference's plain z-buffer scan: renders at a bank pose match the bank at
the production threshold, as the seven renders the program's tests plant
do not.  The seed moves the views, offsets and blocks; the sizes of a pool
are the mix's.
"""

from __future__ import annotations

import numpy as np

BG_MM = 1500.0


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


def scene_pool(n: int, objects: int, rng: np.random.Generator, views: list):
    """`n` scenes of `objects` planted views each (later plants overlap
    earlier ones): (rgbs (n, H, W, 3) u8, depths (n, H, W) f32, truths),
    truths[i] a list of (view, x, y)."""
    H, W = views[0][0].shape[:2]
    rgbs = np.empty((n, H, W, 3), np.uint8)
    deps = np.empty((n, H, W), np.float32)
    truths = []
    for i in range(n):
        fr, dp = background(H, W, rng)
        planted = []
        for _ in range(objects):
            v = int(rng.integers(0, len(views)))
            planted.append((v, *plant(fr, dp, views[v], rng)))
        rgbs[i], deps[i] = fr, dp
        truths.append(planted)
    return rgbs, deps, truths


def depth_to_cloud(depth_mm: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """Organized cloud (H, W, 3) f32 metres of a depth frame in mm at a
    pinhole camera with its principal point at the frame's centre; 0 depth
    is NaN."""
    H, W = depth_mm.shape
    z = depth_mm.astype(np.float32) / np.float32(1000.0)
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)
    x = (u - np.float32(W / 2.0)) * z / np.float32(fx)
    y = (v - np.float32(H / 2.0)) * z / np.float32(fy)
    cloud = np.stack([x, y, z], -1)
    cloud[depth_mm <= 0] = np.nan
    return cloud


def cuboid_triangles(dims=(0.088, 0.144, 0.076), subdiv: int = 18) -> np.ndarray:
    """A closed cuboid centred at the origin as (T, 3, 3) f32 triangles: the
    stand-in for the boxNew mesh (1952 triangles at the defaults)."""
    d = np.asarray(dims, np.float64)
    n = [max(1, int(round(subdiv * v / d.max()))) for v in d]
    tris = []
    for ax in range(3):
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
    return np.asarray(tris, np.float32)


def cube_rotation(k: int) -> np.ndarray:
    """The k-th (mod 24) rotation that maps the axes onto the axes
    (a signed permutation matrix of determinant +1)."""
    mats = []
    for perm in ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)):
        for signs in np.ndindex(2, 2, 2):
            m = np.zeros((3, 3))
            for r, (c, s) in enumerate(zip(perm, signs)):
                m[r, c] = -1.0 if s else 1.0
            if np.linalg.det(m) > 0:
                mats.append(m)
    return mats[k % len(mats)]


def write_binary_stl(path: str, triangles: np.ndarray) -> None:
    """A binary STL of (T, 3, 3) f32 triangles (float32 on disk, so a reader
    gets the same numbers back)."""
    tris = np.asarray(triangles, np.float32)
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    rec = np.zeros(len(tris), dtype=[("n", "<f4", 3), ("v", "<f4", (3, 3)), ("a", "<u2")])
    rec["n"], rec["v"] = n, tris
    with open(path, "wb") as f:
        f.write(b"benchmark cuboid".ljust(80, b" "))
        f.write(np.uint32(len(tris)).tobytes())
        f.write(rec.tobytes())


def render_views(triangles: np.ndarray, R: np.ndarray, T: np.ndarray, fx: float,
                 fy: float, W: int = 640, H: int = 480, device="cuda"):
    """Views for `plant`: the mesh rendered at each pose (R (n, 3, 3), T
    (n, 3), the bank's convention X_cam = R (X + T)) by the plain z-buffer
    scan of the reference, on `device`: [(rgb, depth_mm, mask, rect)]."""
    import torch

    from ..reference.pose.renderer import _pad_triangles, render

    dev = torch.device(device)
    tris = torch.from_numpy(_pad_triangles(np.asarray(triangles, np.float32), 64)).to(dev)
    K = torch.tensor([[fx, 0, W / 2.0], [0, fy, H / 2.0], [0, 0, 1]], dtype=torch.float32,
                     device=dev)
    out = []
    for i in range(len(R)):
        r = render(tris, torch.as_tensor(np.asarray(R[i], np.float32), device=dev),
                   torch.as_tensor(np.asarray(T[i], np.float32), device=dev), K, W, H)
        dep, mask, rgb, rect = (a.cpu().numpy() for a in r)
        if rect[2] > 0 and rect[3] > 0:
            out.append((rgb, dep.astype(np.float32), mask > 0, [int(v) for v in rect]))
    return out
