"""Offline template trainer: STL -> view-sphere renders -> template bank —
the port of ``linemod_pose_estimation_tpu/models/trainer.py`` (the
original system's renderer_node, and renderer_only_image_node in the
RGB-only mode):

  for each view on the (radius x in-plane angle x sphere point) grid:
      render depth / mask / RGB at the view pose       [device, a chunk at once]
      quantize both pyramid levels                     [device]
      extract LINEMOD features (gradient [+ normals])  [host]
      skip views with too few features (addTemplate == -1)
      record {R, T, K, D, Ori_dist, Rect}
  write templates.yml + renderer_params.yml

Per chunk of `render_batch` views the device runs the render (kernel K4
on the card), ``templates.quantize_levels`` (K1's variant with the
squared magnitudes at level 0 on the u8 frames and at level 1 on their
pyrDown as integer-valued f32; DepthNormal once at level 0), then copies
what the host needs into pinned buffers behind an event.  The next
chunk's launches are queued before the host waits for this one, so the
device renders chunk i + 1 while the host extracts chunk i (two sets of
pinned buffers, used in turn).

The host extracts each view from a window of its full-frame arrays: the
render rect with 2 px of margin, an even origin, reaching the frame's edge
where the margin would pass it.  That window holds every candidate and a
ring of background around the mask at both levels, so the selection
(candidate order, the border distances) and the features are those of
the whole frame; rect0 is re-based to the frame.  The reference's
fixed 288-px crops, static thresholds and padded last chunk serve a
remote TPU's per-transfer latency and XLA's retraces, and are not carried
over: the bank is the same.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..utils.stl import load_stl
from ..utils.viewsphere import ViewSphereParams, generate_views
from .detector import Detector
from .renderer import Renderer, render
from .templates import (
    DetectorParams,
    RendererGlobals,
    TemplateBank,
    TemplateMetadata,
    quantize_levels,
)

MARGIN = 2  # px of background kept around a view's rect on the host


@dataclass
class TrainerConfig:
    view_sphere: ViewSphereParams = field(default_factory=ViewSphereParams)
    width: int = 640
    height: int = 480
    focal_length_x: float = 535.566011
    focal_length_y: float = 537.168115
    near: float = 0.1
    far: float = 1000.0
    detector: DetectorParams = field(default_factory=DetectorParams)
    render_batch: int = 16
    class_id: str = "obj"


def _window(rect, H: int, W: int):
    """(oy, ox, ey, ex) of a view's host window at level 0: origin even,
    end None where the window reaches the frame's edge."""
    x, y, w, h = (int(v) for v in rect)
    oy, ox = max(y - MARGIN, 0) & ~1, max(x - MARGIN, 0) & ~1
    ey, ex = y + h + MARGIN, x + w + MARGIN
    return oy, ox, (ey if ey < H else None), (ex if ex < W else None)


def _level_slice(win, l: int):
    oy, ox, ey, ex = win
    up = lambda e: None if e is None else (e + (1 << l) - 1) >> l
    return np.s_[oy >> l:up(ey), ox >> l:up(ex)]


def chunk_arrays(out, params: DetectorParams) -> list[torch.Tensor]:
    """What the host needs of a chunk's renders (a RenderOutput with a
    leading batch axis), in order: mask, rect, the centre pixel's depth,
    per pyramid level K1's (bitmask, squared magnitude), and with
    DepthNormal its level-0 bitmask (the host subsamples it per level)."""
    H, W = out.mask.shape[-2:]
    grad, norm = quantize_levels(
        out.rgb, out.depth_mm if params.use_depth_normal else None, params)
    return ([out.mask, out.rect, out.depth_mm[:, H // 2, W // 2]]
            + [a for q_m in grad for a in q_m] + norm[:1])


def add_views(det: Detector, class_id: str, arrays: list[np.ndarray]) -> list[int]:
    """Extract one chunk's views from its host arrays (``chunk_arrays``'
    order) into `det`: per view its template id, or -1 when nothing was
    rendered or the view has too few features (it is skipped).  Each view
    is extracted from its window and its rect0 re-based to the frame."""
    dp = det.params
    levels = dp.pyramid_levels
    mask, rect, _, *rest = arrays
    H, W = mask.shape[-2:]
    n_grad = levels if dp.use_color_gradient else 0
    grad = [(rest[2 * l], rest[2 * l + 1]) for l in range(n_grad)]
    norm0 = rest[2 * n_grad] if dp.use_depth_normal else None
    tids = []
    for j in range(mask.shape[0]):
        if rect[j, 2] == 0 or rect[j, 3] == 0:
            tids.append(-1)  # nothing rendered
            continue
        win = _window(rect[j], H, W)
        sl = [_level_slice(win, l) for l in range(levels)]
        pre = {
            "grad": [(q[j][sl[l]], m[j][sl[l]]) for l, (q, m) in enumerate(grad)],
            "norm": ([norm0[j][::1 << l, ::1 << l][sl[l]] for l in range(levels)]
                     if dp.use_depth_normal else []),
        }
        tid = det.add_template(None, mask[j][sl[0]], class_id, precomputed=pre)
        if tid >= 0:
            t = det._templates[class_id][tid]
            x0, y0, w0, h0 = t.rect0  # window-local: re-base to the frame
            t.rect0 = (x0 + win[1], y0 + win[0], w0, h0)
        tids.append(tid)
    return tids


class _ChunkOnDevice:
    """One chunk's render and quantizations, on their way to the host."""

    def __init__(self, renderer, Rs, Ts, params: DetectorParams, pinned):
        cuda = Rs.device.type == "cuda"
        if cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        out = render(renderer.triangles, Rs, Ts, renderer.K.expand(Rs.shape[0], 3, 3),
                     renderer.width, renderer.height)
        arrays = chunk_arrays(out, params)
        n = Rs.shape[0]
        if cuda:
            for a, b in zip(arrays, pinned):
                b[:n].copy_(a, non_blocking=True)
            self.host = [b[:n].numpy() for b in pinned]
            self.done = torch.cuda.Event(enable_timing=True)
            self.done.record()
        else:
            self.host = [a.numpy() for a in arrays]
            self.done = None

    def wait(self) -> float | None:
        """Block until the chunk is on the host; its device span in ms
        (None on the CPU)."""
        if self.done is None:
            return None
        self.done.synchronize()
        return self.start.elapsed_time(self.done)


def _pinned_buffers(B: int, H: int, W: int, params: DetectorParams) -> list[torch.Tensor]:
    """Pinned host buffers for one chunk, in chunk_arrays' order."""
    shapes = [((B, H, W), torch.uint8), ((B, 4), torch.int32), ((B,), torch.float32)]
    h, w = H, W
    for _ in range(params.pyramid_levels if params.use_color_gradient else 0):
        shapes += [((B, h, w), torch.uint8), ((B, h, w), torch.float32)]
        h, w = (h + 1) // 2, (w + 1) // 2
    if params.use_depth_normal:
        shapes.append(((B, H, W), torch.uint8))
    return [torch.empty(s, dtype=dt, pin_memory=True) for s, dt in shapes]


def train_from_stl(
    stl_path: str,
    config: TrainerConfig | None = None,
    max_views: int | None = None,
    progress: bool = False,
    device=DEFAULT_DEVICE,
    stats: dict | None = None,
) -> tuple[Detector, TemplateBank]:
    """The renderer_node main loop, a chunk of views at a time on `device`
    (default the card).  `stats`, when given, is filled with what the run
    did: views, chunks, templates, wall_s, and the host's seconds spent
    queueing chunks (`dispatch_s`), waiting for them (`wait_s`) and
    extracting (`extract_s`); on a card also each chunk's device span
    (`chunk_device_ms`: CUDA events from its first launch to its last copy)
    and their sum over the wall time (`busy_share`)."""
    t_start = time.perf_counter()
    cfg = config or TrainerConfig()
    dev = resolve_device(device)
    dp = cfg.detector
    H, W = cfg.height, cfg.width
    r = Renderer(load_stl(stl_path), W, H, cfg.focal_length_x, cfg.focal_length_y,
                 cfg.near, cfg.far, device=dev)
    views = generate_views(cfg.view_sphere)
    if max_views is not None:
        views = views[:max_views]
    det = Detector(dp, device=dev)
    K_np = np.array(
        [[cfg.focal_length_x, 0, W / 2.0], [0, cfg.focal_length_y, H / 2.0], [0, 0, 1.0]],
        np.float32,
    )
    B = cfg.render_batch
    # Every view's pose, on the device once.
    Rs = torch.from_numpy(np.stack([v.R.astype(np.float32) for v in views])
                          if views else np.zeros((0, 3, 3), np.float32)).to(dev)
    Ts = torch.from_numpy(np.stack([v.T.astype(np.float32) for v in views])
                          if views else np.zeros((0, 3), np.float32)).to(dev)
    pinned = ([_pinned_buffers(min(B, len(views)), H, W, dp) for _ in range(2)]
              if dev.type == "cuda" and views else [None, None])
    starts = list(range(0, len(views), B))
    timing = dict(dispatch_s=0.0, wait_s=0.0, extract_s=0.0)

    def dispatch(ci):
        t0 = time.perf_counter()
        s = starts[ci]
        chunk = _ChunkOnDevice(r, Rs[s:s + B], Ts[s:s + B], dp, pinned[ci % 2])
        timing["dispatch_s"] += time.perf_counter() - t0
        return chunk

    Rl, Tl, Ks, Ds, Ods, Rects = [], [], [], [], [], []
    cid = cfg.class_id
    chunk_ms = []
    pending = dispatch(0) if starts else None
    for ci, s in enumerate(starts):
        cur = pending
        if ci + 1 < len(starts):
            pending = dispatch(ci + 1)
        t0 = time.perf_counter()
        span = cur.wait()
        timing["wait_s"] += time.perf_counter() - t0
        if span is not None:
            chunk_ms.append(span)
        t0 = time.perf_counter()
        chunk = views[s:s + B]
        tids = add_views(det, cid, cur.host)
        rect, centre = cur.host[1], cur.host[2]
        for j, (v, tid) in enumerate(zip(chunk, tids)):
            if tid < 0:
                continue
            # D = Ori_dist - the render's centre surface depth
            cd = float(centre[j]) / 1000.0
            Rl.append(v.R)
            Tl.append(v.T)
            Ks.append(K_np)
            Ds.append(v.D_obj - float(cd))
            Ods.append(v.D_obj)
            Rects.append(rect[j].copy())
        timing["extract_s"] += time.perf_counter() - t0
        if progress:
            print(f"trained {det.num_templates(cid)} / {s + len(chunk)} views")

    meta = TemplateMetadata(
        R=np.stack(Rl) if Rl else np.zeros((0, 3, 3)),
        T=np.stack(Tl) if Tl else np.zeros((0, 3)),
        K=np.stack(Ks) if Ks else np.zeros((0, 3, 3), np.float32),
        D=np.array(Ds),
        Ori_dist=np.array(Ods),
        Rect=np.stack(Rects).astype(np.int32) if Rects else np.zeros((0, 4), np.int32),
    )
    vs = cfg.view_sphere
    globals_ = RendererGlobals(
        n_points=vs.n_points, angle_step=vs.angle_step, radius_min=vs.radius_min,
        radius_max=vs.radius_max, radius_step=vs.radius_step, width=W, height=H,
        focal_length_x=cfg.focal_length_x, focal_length_y=cfg.focal_length_y,
        near=cfg.near, far=cfg.far,
    )
    bank = TemplateBank(cid, dp, det._templates.setdefault(cid, []), f_cap=det.f_cap,
                        metadata=meta, globals_=globals_)
    det.attach_bank(bank)
    if stats is not None:
        wall = time.perf_counter() - t_start
        stats.update(views=len(views), chunks=len(starts), templates=len(Rl), wall_s=wall,
                     **timing)
        if chunk_ms:
            stats.update(chunk_device_ms=chunk_ms,
                         busy_share=sum(chunk_ms) / 1e3 / wall)
    return det, bank


def train_and_write(
    stl_path: str,
    templates_yml: str,
    params_yml: str,
    config: TrainerConfig | None = None,
    max_views: int | None = None,
    device=DEFAULT_DEVICE,
) -> tuple[Detector, TemplateBank]:
    """Train, then write both YAML files: the templates in cv::linemod's
    schema and the renderer_params."""
    det, bank = train_from_stl(stl_path, config, max_views, device=device)
    bank.write_templates_yaml(templates_yml)
    bank.write_params_yaml(params_yml)
    return det, bank
