"""Visualization and diagnostics helpers, host-side numpy — a copy of
``linemod_pose_estimation_tpu/utils/visualization.py``: rectangle and
feature-dot overlays (the reference's cv::rectangle and drawResponse), a
dependency-free PNG writer, and a per-stage wall-clock timer.
"""

from __future__ import annotations

import struct
import time
import zlib
from contextlib import contextmanager

import numpy as np


def write_png(path: str, img: np.ndarray) -> None:
    """Minimal RGB(A) / gray PNG writer (stdlib only)."""
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + img[i].astype(np.uint8).tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))


def draw_rect(img: np.ndarray, rect, color=(255, 0, 0), thickness: int = 2) -> np.ndarray:
    """Rectangle overlay, `thickness` px inside the rect's edges."""
    out = img.copy()
    x, y, w, h = (int(v) for v in rect)
    H, W = out.shape[:2]
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + w, W - 1), min(y + h, H - 1)
    for t in range(thickness):
        if y0 + t < H:
            out[y0 + t, x0:x1 + 1] = color
        if 0 <= y1 - t < H:
            out[y1 - t, x0:x1 + 1] = color
        if x0 + t < W:
            out[y0:y1 + 1, x0 + t] = color
        if 0 <= x1 - t < W:
            out[y0:y1 + 1, x1 - t] = color
    return out


def draw_features(img: np.ndarray, features: np.ndarray, origin_xy=(0, 0),
                  color=(0, 255, 0)) -> np.ndarray:
    """Feature-dot overlay: a 3 x 3 dot per feature row (y, x, ...),
    relative to the template bbox origin `origin_xy`."""
    out = img.copy()
    H, W = out.shape[:2]
    ox, oy = origin_xy
    for f in np.asarray(features):
        y, x = int(f[0]) + oy, int(f[1]) + ox
        if 1 <= y < H - 1 and 1 <= x < W - 1:
            out[y - 1:y + 2, x - 1:x + 2] = color
    return out


class StageTimer:
    """Per-stage wall-clock accumulator (host clock; a stage that ends in
    queued device work is timed only if it waits for the device)."""

    def __init__(self, verbose: bool = False):
        self.times: dict[str, float] = {}
        self.verbose = verbose

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            if self.verbose:
                print(f"Time consumed by {name}: {dt:.4f}s")

    def report(self) -> str:
        return "\n".join(f"{k}: {v * 1000:.2f} ms" for k, v in self.times.items())
