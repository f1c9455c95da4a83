"""Odd operand sets that hold kernels K3 (the walk), K4 (the z-buffer), K5
(the window scores), DN (the DepthNormal quantizer) and BM (the bound
margins) to their plain versions off the main path's shapes.  chip_smoke.py
and tests/test_torch_cuda.py run the same sets (the CPU tests hold DN's
plain version to the reference on its sets, and BM's plain route to the
chain it replaced on its own).  Each is made from a fixed seed and placed
on the device asked for.
"""

from __future__ import annotations

import numpy as np
import torch

WALK_SHAPE = dict(B=4, C=16, H=480, W=640, K=64, F=128, T=5)


def _walk_case(rng, device, B, C, H, W, K, F, T, edges=False):
    R0 = rng.integers(0, 5, size=(B, C, H, W), dtype=np.uint8)
    oris = rng.integers(0, C, size=(B, K, F))
    dys = rng.integers(0, 193, size=(B, K, F))
    dxs = rng.integers(0, 193, size=(B, K, F))
    live = rng.random((B, K, F)) < 0.9
    gy0 = rng.integers(0, max(1, (H - 192) // T - 15), size=(B, K))
    gx0 = rng.integers(0, max(1, (W - 192) // T - 15), size=(B, K))
    if edges:
        # Placements past the frame's bottom and right edges, and (a
        # row-sharded stripe's negative origin) above its top.
        gy0 = H // T - rng.integers(0, 24, size=(B, K))
        gx0 = W // T - rng.integers(0, 24, size=(B, K))
        gy0[:, :4] = -rng.integers(1, 20, size=(B, 4))
    n_valid = rng.integers(0, K + 1, size=B)
    n_valid[0] = K
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    return [torch.as_tensor(R0, device=device), i32(oris), i32(dys), i32(dxs),
            torch.as_tensor(live, device=device), i32(gy0), i32(gx0), i32(n_valid)], T


def walk_cases(device) -> dict[str, tuple[torch.Tensor, tuple, int]]:
    """name -> (R0, operands, T) for cuda_kernels.walk_scores(R0, *operands,
    T): frames with n_valid = 0, walked slots whose features are all dead,
    F = 37 and F = 300 (past one 256-feature round), placements past the
    frame's edges, B = 1 at K = 512 (the detect's walk), and T = 4."""
    rng = np.random.default_rng(5)
    s = WALK_SHAPE
    out = {}
    for name, kw in (("n_valid_0", {}), ("dead_slot", {}), ("F37", dict(F=37)),
                     ("F300", dict(F=300)), ("edges", dict(edges=True)),
                     ("B1_K512", dict(B=1, K=512)), ("T4", dict(T=4))):
        ops, T = _walk_case(rng, device, **{**s, **kw})
        if name == "n_valid_0":
            ops[7][1::2] = 0
        if name == "dead_slot":
            ops[4][0, :3] = False
            ops[4][2, 1] = False
        out[name] = (ops[0], tuple(ops[1:]), T)
    return out


WINDOW_CASES = ("window_1", "window_7", "window_24", "window_40", "F37", "F300_u8",
                "nf_0_and_past_F", "W643", "edge", "top_left", "chw_input",
                "odd_ptr", "odd_ptr_tight")


def _window_case(rng, device, B=2, C=8, H=120, W=160, K=6, F=20, window=24, vmax=5,
                 E=40, place="mixed", batched=True, storage="own"):
    """(R, (oris, dys, dxs, nf, anchor_y, anchor_x), window, frame_idx)."""
    n = B * C * H * W
    vals = rng.integers(0, vmax, size=n, dtype=np.uint8)
    if storage == "own":
        R = torch.as_tensor(vals, device=device)
    else:
        # One byte into a storage: the data pointer is odd.  "tight": the
        # storage ends with the tensor, off a multiple of 4, so the aligned
        # word around the last byte reaches past it.
        assert storage == "padded" or (n + 1) % 4
        base = torch.zeros(n + (8 if storage == "padded" else 1), dtype=torch.uint8,
                           device=device)
        R = base[1:n + 1]
        R.copy_(torch.as_tensor(vals, device=device))
        assert R.data_ptr() % 2 == 1
    R = R.view(B, C, H, W)
    oris = rng.integers(0, C, size=(K, F))
    dys = rng.integers(0, E + 1, size=(K, F))
    dxs = rng.integers(0, E + 1, size=(K, F))
    nf = rng.integers(1, F + 1, size=K)
    nf[0] = F
    # Half the candidates keep every read inside the frame (where the frame
    # has room), the others lie anywhere, windows over the edges included.
    ay, ax = rng.integers(0, H, size=K), rng.integers(0, W, size=K)
    ay[::2] = rng.integers(0, max(1, H - E - window), size=len(ay[::2]))
    ax[::2] = rng.integers(0, max(1, W - E - window), size=len(ax[::2]))
    if place == "edge":  # the bottom-right corner, the last frame's last byte
        ay, ax = H - 1 - np.arange(K) % 3, W - 1 - np.arange(K) % 5
        dys[:, 0] = dxs[:, 0] = 0
        oris[0, 0] = C - 1
    if place == "top_left":  # reads above and left of the frame
        ay, ax = -rng.integers(0, 12, size=K), -rng.integers(0, 12, size=K)
        dys[:, ::3] -= 9
        dxs[:, ::3] -= 9
    frame = rng.integers(0, B, size=K)
    frame[0] = B - 1
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    ops = (i32(oris), i32(dys), i32(dxs), i32(nf), i32(ay), i32(ax))
    if not batched:
        return R[0], ops, window, None
    return R, ops, window, i32(frame)


def window_cases(device) -> dict[str, tuple]:
    """name -> (R, operands, window, frame_idx) for cuda_kernels.
    refine_scores(R, *operands, window=window, frame_idx=frame_idx):
    windows of 1, 7, 24 and 40 cells (40: two row segments, and past one
    block's threads); F = 37 and F = 300 (past one staging round) with
    responses up to 255; nf of 0 and above F; W = 643; anchors on the
    bottom-right edge; reads above and left of the frame; a (C, H, W)
    input without frame_idx; and an R one byte into its storage, with the
    storage reaching past it and ending with it."""
    rng = np.random.default_rng(11)
    spec = dict(
        window_1=dict(window=1), window_7=dict(window=7), window_24=dict(window=24),
        window_40=dict(window=40, K=4), F37=dict(F=37),
        F300_u8=dict(F=300, K=4, vmax=256), nf_0_and_past_F=dict(),
        W643=dict(H=70, W=643, C=3), edge=dict(place="edge"),
        top_left=dict(place="top_left"), chw_input=dict(batched=False),
        odd_ptr=dict(storage="padded", H=71, W=83),
        odd_ptr_tight=dict(storage="tight", B=1, C=3, H=21, W=23, window=7, E=8),
    )
    assert tuple(spec) == WINDOW_CASES
    out = {}
    for name, kw in spec.items():
        case = _window_case(rng, device, **kw)
        if name == "F300_u8":  # a sum past 16 bits: 300 reads of 255
            case[0][:, 0] = 255
            case[1][0][0] = 0
        if name == "nf_0_and_past_F":
            case[1][3][1] = 0
            case[1][3][2] = case[1][0].shape[1] + 5
        out[name] = case
    return out


def raster_cases(device, params_path: str) -> dict[str, tuple[torch.Tensor, int, int]]:
    """name -> (coefs, width, height) for raster.raster_zbuffer:

    - dup_rows_tie: the cuboid (1984 padded triangles) at four bank poses
      in the 256 x 256 viewport, every row appended again with shade
      1 - shade, so that every covered pixel ties exactly and only the
      first index may win;
    - dense_tile: 700 small triangles (a tenth of them repeated rows)
      over a 24 x 24 pixel corner of a 64 x 48 frame, so that tiles there
      list more than 256 triangles and take several cull rounds;
    - viewport_250x170: two poses, a viewport off the 16-pixel tile in
      both axes;
    - viewport_1x1: one pixel, on the object's centre."""
    from ..models.renderer import _pad_triangles
    from ..models.templates import TemplateBank
    from ..ops import raster as RA
    from .scenes import cuboid_mesh

    meta, glob = TemplateBank.read_params_yaml(params_path)
    tris = torch.from_numpy(_pad_triangles(cuboid_mesh().triangles, 64)).to(device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)

    def cuboid(ids, cx, cy):
        K = f32([[glob.focal_length_x, 0, cx], [0, glob.focal_length_y, cy], [0, 0, 1]])
        return RA.triangle_coefficients(tris, f32(meta.R[ids]), f32(meta.T[ids]),
                                        K.expand(len(ids), 3, 3))

    out = {}
    c = cuboid([0, 300, 700, 1000], 128.0, 128.0)
    dup = c.clone()
    shade = RA.COEFS.index("shade")
    dup[..., shade] = 1.0 - dup[..., shade]
    out["dup_rows_tie"] = (torch.cat([c, dup], dim=1).contiguous(), 256, 256)

    rng = np.random.default_rng(7)
    n, fpx = 700, 100.0
    centre = rng.uniform(0.0, 24.0, size=(n, 1, 2))
    uv = centre + rng.uniform(-6.0, 6.0, size=(n, 3, 2))
    z = rng.uniform(0.5, 1.0, size=(n, 1)) + rng.uniform(0.0, 0.05, size=(n, 3))
    cam = np.concatenate([uv / fpx * z[..., None], z[..., None]], axis=-1)
    cam[n - n // 10:] = cam[:n // 10]  # repeated rows: exact ties
    K = f32([[fpx, 0, 0], [0, fpx, 0], [0, 0, 1]])
    dense = RA.triangle_coefficients(f32(cam), torch.eye(3, device=device)[None],
                                     f32([[0.0, 0.0, 0.0]]), K[None])
    dense[:, n - n // 10:, shade] = 1.0 - dense[:, n - n // 10:, shade]
    out["dense_tile"] = (dense, 64, 48)

    out["viewport_250x170"] = (cuboid([1400, 2000], 125.0, 85.0), 250, 170)
    out["viewport_1x1"] = (cuboid([2400], 0.5, 0.5), 1, 1)
    return out


DEPTH_NORMAL_CASES = ("zeros", "odd_3x37x53", "small_2x11x11", "distance_edges", "steps",
                      "holes", "far_65535", "noise", "noise_diff300", "int32_input")


def _surface(rng, B: int, H: int, W: int, base: float) -> np.ndarray:
    """Tilted, gently curved planes with fractional millimetres."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = []
    for _ in range(B):
        gx, gy, cv = rng.uniform(-6.0, 6.0), rng.uniform(-6.0, 6.0), rng.uniform(-0.05, 0.05)
        out.append(base + gx * xx + gy * yy + cv * (xx - W / 2) * (yy - H / 2)
                   + rng.random((H, W)))
    return np.stack(out).astype(np.float32)


def depth_normal_cases(device) -> dict[str, tuple[torch.Tensor, float, float]]:
    """name -> (depth_mm (B, H, W), distance_threshold, difference_threshold)
    for cuda_preprocess.quantize_depth_normal:

    - zeros: an all-zero depth;
    - odd_3x37x53, small_2x11x11: shapes off the kernel's 64 x 32 tile
      and off 4 columns; 11 x 11 is smaller than the quantizer's band, so
      the output is all zero;
    - distance_edges: column bands at 1999.9, 2000.0 and 2000.5 mm (whole
      millimetres 1999, 2000, 2000 after truncation) and a ramp through
      2000 mm with fractional steps;
    - steps: a staircase of 49, 50 and 51 mm jumps (and 49.9 and 50.9,
      which truncation makes 49 and 50 or 50 and 51) across rows and
      columns, against the difference threshold of 50;
    - holes: surfaces with 3% zero pixels and a zero rectangle;
    - far_65535: depths from 65000 to 65535 mm at a distance threshold of
      70,000, so the products above 2^24 round;
    - noise, noise_diff300: uniform depths in [0, 2600) mm, at difference
      thresholds 50 and 300;
    - int32_input: a surface given as int32 millimetres."""
    rng = np.random.default_rng(18)
    out = {}
    out["zeros"] = (np.zeros((2, 40, 52), np.float32), 2000.0, 50.0)
    out["odd_3x37x53"] = (_surface(rng, 3, 37, 53, 900.0), 2000.0, 50.0)
    out["small_2x11x11"] = (_surface(rng, 2, 11, 11, 900.0), 2000.0, 50.0)

    H, W = 48, 70
    yy, xx = np.mgrid[0:H, 0:W]
    d = _surface(rng, 2, H, W, 1990.0)
    d[0, :, :20], d[0, :, 20:40], d[0, :, 40:] = 1999.9, 2000.0, 2000.5
    d[1] = 1985.0 + 0.45 * xx + 0.1 * yy
    out["distance_edges"] = (d, 2000.0, 50.0)

    jumps = np.array([49.0, 50.0, 51.0, 49.9, 50.9], np.float32)
    s = np.zeros((2, H, W), np.float32)
    s[0] = 800.5 + np.cumsum(jumps[(xx // 6) % 5] * (xx % 6 == 0), axis=1)
    s[1] = 800.5 + np.cumsum(jumps[(yy // 6) % 5] * (yy % 6 == 0), axis=0)
    out["steps"] = (s, 2000.0, 50.0)

    h = _surface(rng, 2, H, W, 1200.0)
    h[rng.random(h.shape) < 0.03] = 0.0
    h[1, 10:25, 30:50] = 0.0
    out["holes"] = (h, 2000.0, 50.0)

    f = np.clip(_surface(rng, 2, H, W, 65300.0), 65000.0, 65535.0)
    f[0, :, :8] = 65535.0
    f[1, 20:30] = 65534.9
    out["far_65535"] = (f, 70000.0, 50.0)

    n = (rng.random((2, H, W)) * 2600.0).astype(np.float32)
    out["noise"] = (n, 2000.0, 50.0)
    out["noise_diff300"] = (n, 2000.0, 300.0)
    out["int32_input"] = (_surface(rng, 2, H, W, 700.0).astype(np.int32), 2000.0, 50.0)
    assert tuple(out) == DEPTH_NORMAL_CASES
    return {k: (torch.as_tensor(v, device=device), dt, df) for k, (v, dt, df) in out.items()}


# BM's operand sets: rows (M, or B frames of every position with pos
# "none"), positions P, templates n, contraction K, the rows' positions
# ("none": m % P; "random"), the live rows ("none", "prefix": the first
# `live`, as a pool fills, "holes": a prefix with dead rows inside), the
# sentinel, and "full" int8 operands in place of responses and counts.
_NEG = -(2**30)
_I32_MIN = -(2**31)
BOUND_MARGIN_CASES = {
    # the four call shapes, cut to a CPU's size, and the ragged edges
    "group_tier": dict(M=2 * 1200, P=1200, n=664, K=2304, pos="none", sentinel=_NEG),
    "cell_tier_dead_slots": dict(M=300, P=1200, n=1000, K=2304, keep="holes", live=150),
    "fine_tier": dict(M=70, P=1200, n=600, K=9216, keep="prefix", live=50),
    "every_position_int32_min": dict(M=2 * 300, P=300, n=523, K=1152, pos="none",
                                     sentinel=_I32_MIN),
    "short_rows_odd_k": dict(M=9, P=5, n=37, K=24, keep="holes", live=9),
    "full_int8_operands": dict(M=200, P=50, n=301, K=160, full=True),
    "one_template": dict(M=130, P=10, n=1, K=128, keep="prefix", live=129),
}
# The batch cells' shapes (a card's size): planted's and fullbin's group,
# cell and fine tiers (B=32 x 1200 positions, 10,624 templates, RGB-D K),
# twoobj's every-position bound (5304 templates), ensenso's cell and fine
# tiers (one modality's K).
BOUND_MARGIN_SHAPES = {
    "planted_group": dict(M=32 * 1200, P=1200, n=664, K=2304, pos="none", sentinel=_NEG),
    "planted_cell": dict(M=32 * 1200, P=1200, n=10624, K=2304, keep="prefix", live=30000),
    "planted_fine": dict(M=56 * 32, P=1200, n=10624, K=9216, keep="prefix", live=1200),
    "twoobj_positions": dict(M=32 * 1200, P=1200, n=5304, K=2304, pos="none",
                             sentinel=_I32_MIN),
    "ensenso_cell": dict(M=32 * 1200, P=1200, n=10624, K=1152, keep="prefix", live=20000),
    "ensenso_fine": dict(M=64 * 32, P=1200, n=10624, K=4608, keep="prefix", live=1500),
}


def bound_margin_case(name: str, device) -> tuple:
    """(A (M, K) int8, nk (ceil8(n), K) int8 K-major with zero rows past
    n, n, t (n,) int32, vpos (P, n) bool, pos (M,) int64 or None, keep
    (M,) bool or None, sentinel) for kernel BM's case or shape `name`:
    responses in [0, 4] against sparse counts whose bounds straddle the
    thresholds, 80% of (position, template) pairs valid, or the full int8
    range against thresholds past +-2^30."""
    c = {**dict(pos="random", keep="none", sentinel=_NEG, full=False),
         **(BOUND_MARGIN_CASES.get(name) or BOUND_MARGIN_SHAPES[name])}
    g = torch.Generator().manual_seed(sum(map(ord, name)))
    M, P, n, K = c["M"], c["P"], c["n"], c["K"]
    n8 = -(-n // 8) * 8
    if c["full"]:
        A = torch.randint(-128, 128, (M, K), generator=g, dtype=torch.int8)
        W = torch.randint(-128, 128, (n, K), generator=g, dtype=torch.int8)
        t = torch.randint(-(2**30) - 2**27, 2**30 + 2**27, (n,), generator=g, dtype=torch.int32)
    else:
        A = torch.randint(0, 5, (M, K), generator=g, dtype=torch.int8)
        hit = torch.rand((n, K), generator=g) < 63.0 / K
        W = (hit * torch.randint(1, 4, (n, K), generator=g)).to(torch.int8)
        t = torch.randint(60, 200, (n,), generator=g, dtype=torch.int32)
    nk = torch.zeros((n8, K), dtype=torch.int8)
    nk[:n] = W
    vpos = torch.rand((P, n), generator=g) < 0.8
    vpos[0] = True  # a position where every template is valid
    pos = None if c["pos"] == "none" else torch.randint(0, P, (M,), generator=g)
    keep = None
    if c["keep"] != "none":
        keep = torch.arange(M) < c["live"]
        if c["keep"] == "holes":
            keep[torch.randint(0, c["live"], (max(1, c["live"] // 10),), generator=g)] = False
    on = lambda x: None if x is None else x.to(device)
    return on(A), on(nk), n, on(t), on(vpos), on(pos), on(keep), c["sentinel"]
