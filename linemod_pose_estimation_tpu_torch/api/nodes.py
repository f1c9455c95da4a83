"""The application nodes and the offline replay seam — the port of
``linemod_pose_estimation_tpu/api/nodes.py``.

- StreamingDetector: the carmine node; every fed frame runs the full
  cascade, and the best-scored detection goes to the publish callback.
- PollingMultiObjectDetector: the two-object alternator; run_once() grabs
  a frame and detects the next object in rotation.
- ReplayFrameSource: detection without camera hardware, from .npz frame
  fixtures ({rgb, cloud}) or ASCII .pcd clouds.

The detects run on each pipeline's device.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..models.pipeline import Detection, DetectionPipeline
from ..utils.visualization import StageTimer
from .service import Frame, ObjectConfig


def load_pcd_ascii(path: str, width: int | None = None, height: int | None = None) -> np.ndarray:
    """Minimal ASCII PCD reader -> organized (H, W, 3) float32 cloud (or
    (1, N, 3) when the header's WIDTH x HEIGHT does not fit the points).
    NaNs pass through."""
    w = h = None
    data = []
    with open(path) as f:
        in_data = False
        for line in f:
            if in_data:
                data.append([float(v) for v in line.split()[:3]])
                continue
            key, *rest = line.split()
            if key == "WIDTH":
                w = int(rest[0])
            elif key == "HEIGHT":
                h = int(rest[0])
            elif key == "DATA":
                if rest[0] != "ascii":
                    raise ValueError("only ascii PCD supported by the replay reader")
                in_data = True
    arr = np.array(data, np.float32)
    w = width or w
    h = height or h
    if h and w and h * w == arr.shape[0]:
        return arr.reshape(h, w, 3)
    return arr.reshape(1, -1, 3)


class ReplayFrameSource:
    """Round-robin frames from the .npz fixtures ({rgb, cloud}) of a
    directory, in file-name order, or from one .npz file — callable like
    the camera grab."""

    def __init__(self, path: str):
        self.frames: list[Frame] = []
        paths = sorted(glob.glob(os.path.join(path, "*.npz"))) if os.path.isdir(path) else [path]
        for p in paths:
            with np.load(p) as z:
                self.frames.append(Frame(rgb=z["rgb"], cloud=z["cloud"]))
        if not self.frames:
            raise FileNotFoundError(f"no replay frames under {path}")
        self._i = 0

    def __call__(self) -> Frame:
        f = self.frames[self._i % len(self.frames)]
        self._i += 1
        return f


def save_replay_frame(path: str, rgb: np.ndarray, cloud: np.ndarray) -> None:
    np.savez_compressed(path, rgb=rgb, cloud=cloud)


@dataclass
class StreamingDetector:
    """Continuous per-frame detection, the best detection published.  The
    carmine node canonicalizes z-down and verifies its hypotheses: build
    the pipeline with CascadeParams(canonicalize="z_down", enable_hv=True)
    for that."""

    pipeline: DetectionPipeline
    threshold: float = 89.0  # the carmine node's default
    on_pose: Callable[[Detection], None] | None = None
    timer: StageTimer = field(default_factory=StageTimer)

    def feed(self, frame: Frame) -> Detection | None:
        with self.timer.stage("detect_total"):
            dets = self.pipeline.detect(frame.rgb, frame.cloud, self.threshold)
        if not dets:
            return None
        best = dets[0]
        if self.on_pose is not None:
            self.on_pose(best)
        return best


@dataclass
class PollingMultiObjectDetector:
    """Alternate over the registered objects (in id order), one grab +
    detect per tick."""

    frame_source: Callable[[], Frame]
    objects: dict[int, ObjectConfig] = field(default_factory=dict)
    on_pose: Callable[[int, Detection], None] | None = None
    _order: list[int] = field(default_factory=list)
    _i: int = 0

    def register_object(self, object_id: int, cfg: ObjectConfig) -> None:
        self.objects[object_id] = cfg
        self._order = sorted(self.objects)

    def run_once(self) -> tuple[int, list[Detection]]:
        if not self._order:
            return -1, []
        oid = self._order[self._i % len(self._order)]
        self._i += 1
        cfg = self.objects[oid]
        frame = self.frame_source()
        dets = cfg.pipeline.detect(frame.rgb, frame.cloud, cfg.threshold)
        if dets and self.on_pose is not None:
            self.on_pose(oid, dets[0])
        return oid, dets
