"""Driver of the single-frame detect: one request at a time through
`DetectionPipeline.detect`, closed loop, like a robot that waits for each
reply.  A request is a host frame (rgb, depth in mm) and its organized
cloud; the reply is the list of detections on the host.

Traffic parameters: `pool` (scenes, drawn in turn), `objects`, `views`,
`threshold`, `trace_steps`.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from linemod_pose_estimation_tpu_torch.models import cascade as CC
from linemod_pose_estimation_tpu_torch.models.detector import Detector
from linemod_pose_estimation_tpu_torch.models.pipeline import DetectionPipeline

from ..reference import bank as RB
from ..reference import detect as RD
from ..reference.matcher import valid_set
from . import scenes, spans
from .common import Limits, bank_path, params_path, rng, seeded_templates

# match_frames_wrong: scenes whose valid matches differ from the
# reference's (exact); detections_wrong: scenes whose detections differ in
# number or in any rect (exact); pose_deg / pose_mm: the widest rotation
# and translation gap between paired detections' poses.  The pose limits
# sit between the program's widest reading over the proving seeds and the
# control's least (PERF.md, section 2).
LIMITS = Limits(match_frames_wrong=0, detections_wrong=0, pose_deg=0.01, pose_mm=0.01)


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.config, self.device = config, device
        self.threshold = float(traffic["threshold"])
        self.prm = RB.read_params(params_path(config))
        g = self.prm.globals
        self.triangles = scenes.cuboid_triangles()
        fd, self.stl = tempfile.mkstemp(prefix="bench_mesh_", suffix=".stl")
        os.close(fd)
        scenes.write_binary_stl(self.stl, self.triangles)
        self.pipe = DetectionPipeline.from_files(bank_path(config), params_path(config),
                                                 self.stl, CC.CascadeParams(), device=device)
        tids = seeded_templates(seed, len(self.prm.R), int(traffic["views"]))
        views = scenes.render_views(self.triangles, self.prm.R[tids], self.prm.T[tids],
                                    g["focal_length_x"], g["focal_length_y"], device=device)
        self.rgbs, self.deps, _ = scenes.scene_pool(int(traffic["pool"]),
                                                    int(traffic["objects"]), rng(seed, 2),
                                                    views)
        self.clouds = [scenes.depth_to_cloud(d, g["focal_length_x"], g["focal_length_y"])
                       for d in self.deps]
        self.records: list = []  # (scene, device Matches, detections)
        self._matches: list = []
        self._spy_matches()
        self.next = 0
        for _ in range(len(self.rgbs)):  # warm-up: every scene once
            self.step()
        if device.type == "cuda":
            torch.cuda.synchronize()
        self.records.clear()
        self.next = 0

    def _spy_matches(self) -> None:
        """Keep each detect's matches (device tensors, read after the
        window), by a wrapper on the detector's match_raw that adds no
        device work and no host sync."""
        det = self.pipe.detector

        def match_raw(*a, **k):
            out = type(det).match_raw(det, *a, **k)  # the class's, patched or not
            self._matches.append(out[self.pipe.class_id])
            return out

        det.match_raw = match_raw

    def step(self) -> int:
        i = self.next
        self.next = (self.next + 1) % len(self.rgbs)
        dets = self.pipe.detect(self.rgbs[i], self.clouds[i], self.threshold,
                                depth_mm=self.deps[i])
        self.records.append((i, self._matches.pop(), [(d.pose, d.rect) for d in dets]))
        return 1

    def end_to_end(self, units: int, elapsed: float, times_ms: list) -> dict:
        q = np.percentile(np.asarray(times_ms), [50, 95], method="linear")
        return {"detect_ms_p50": float(q[0]), "detect_ms_p95": float(q[1])}

    def trace_patches(self, p, launches: dict) -> None:
        p.span(DetectionPipeline, "detect", "detect")
        p.span(Detector, "match_raw", "match")
        p.span(CC, "cluster_matches", "cluster")
        p.span(CC, "nms_iou", "cluster")
        p.span(CC, "rough_pose_and_refine", "pose")
        spans.record_k4(p, launches)

    def counters(self) -> dict:
        return {"detects": len(self.records)}

    def free(self) -> None:
        del self.pipe
        os.remove(self.stl)

    # -- correctness ---------------------------------------------------------

    def answers(self) -> list[tuple[int, tuple]]:
        host = lambda m: {k: getattr(m, k).cpu().numpy() for k in m._fields}
        return [(i, (valid_set(host(m)), dets)) for i, m, dets in self.records]

    def reference(self, scene_ids, lower: bool = False) -> dict:
        """scene -> (valid matches, [(pose, rect)]) of the reference
        (`lower`: bfloat16 float chains and TF32 products, the control)."""
        bank = RB.read_templates(bank_path(self.config))
        ref = RD.ReferenceDetect(bank, self.prm, self.triangles, self.threshold,
                                 device=self.device,
                                 dtype=torch.bfloat16 if lower else torch.float32)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = lower
        try:
            out = {}
            for i in sorted(scene_ids):
                m, dets = ref.detect(self.rgbs[i], self.deps[i], self.clouds[i])
                host = {k: getattr(m, k).cpu().numpy() for k in m._fields}
                out[i] = (valid_set(host), [(d["pose"], d["rect"]) for d in dets])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        return out

    @staticmethod
    def compare(answers: list, want: dict) -> dict:
        mw = dw = 0
        deg = mm = 0.0
        for i, (matches, dets) in answers:
            wm, wd = want[i]
            mw += matches != wm
            if len(dets) != len(wd) or any(tuple(a[1]) != tuple(b[1]) for a, b in zip(dets, wd)):
                dw += 1
                continue
            for (pa, _), (pb, _) in zip(dets, wd):
                d, t = pose_gap(pa, pb)
                deg, mm = max(deg, d), max(mm, t)
        return LIMITS.numbers(match_frames_wrong=mw, detections_wrong=dw, pose_deg=deg,
                              pose_mm=mm)


def pose_gap(a: np.ndarray, b: np.ndarray) -> tuple[float, float]:
    """(rotation angle in degrees, translation distance in mm) between two
    (4, 4) poses.  The angle comes from the chord ||Ra - Rb|| = 2 sqrt(2)
    sin(angle / 2), which reads 0 for equal float32 rotations; the trace
    formula reads their small departures from orthonormality as ~0.1
    degree."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    chord = np.linalg.norm(a[:3, :3] - b[:3, :3]) / (2.0 * np.sqrt(2.0))
    return (float(np.degrees(2.0 * np.arcsin(min(chord, 1.0)))),
            float(np.linalg.norm(a[:3, 3] - b[:3, 3]) * 1000.0))
