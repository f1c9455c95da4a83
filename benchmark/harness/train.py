"""Driver of the offline trainer: back-to-back `train_from_stl` calls, each a
fresh bank of the view sphere's first `views` views (RGB-D, 640x480,
chunks of `render_batch`), like a user training a new object.

The trainer walks the sphere in its fixed order, so the seed cannot pick
the views: it turns the object instead (one of the 24 rotations that map
the cuboid's axes onto the axes), which changes every view's silhouette
and leaves the sizes of the work alone, and it draws the views the
reference checks.

Traffic parameters: `views`, `render_batch`, `width`, `height` (the focal
lengths scale with the width), `check_views`, `trace_steps`.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from linemod_pose_estimation_tpu_torch.models import trainer
from linemod_pose_estimation_tpu_torch.models.templates import DetectorParams

from ..reference import trainer as RT
from . import scenes, spans
from .common import Limits, rng

# views_wrong: checked views whose template (features, sizes, rect0) or
# pose record (R, T, K, D, Ori_dist, Rect), or whose being skipped, differs
# from the reference's: an exact comparison.
LIMITS = Limits(views_wrong=0)


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.device = device
        self.views = int(traffic["views"])
        self.batch = int(traffic["render_batch"])
        self.seed = seed
        self.check_views = int(traffic["check_views"])
        rot = scenes.cube_rotation(int(rng(seed, 3).integers(24)))
        self.triangles = (scenes.cuboid_triangles().astype(np.float64) @ rot.T).astype(np.float32)
        fd, self.stl = tempfile.mkstemp(prefix="bench_mesh_", suffix=".stl")
        os.close(fd)
        scenes.write_binary_stl(self.stl, self.triangles)
        # TrainerConfig's camera (640x480) unless the mix scales it down.
        self.width, self.height = int(traffic["width"]), int(traffic["height"])
        scale = self.width / 640.0
        base = trainer.TrainerConfig()
        self.cfg = trainer.TrainerConfig(detector=DetectorParams(use_depth_normal=True),
                                 render_batch=self.batch, width=self.width,
                                 height=self.height,
                                 focal_length_x=base.focal_length_x * scale,
                                 focal_length_y=base.focal_length_y * scale)
        self.banks: list = []
        self._call(self.batch)  # warm-up: one chunk, the window's shapes
        if device.type == "cuda":
            torch.cuda.synchronize()
        self.banks.clear()

    def _call(self, n_views: int) -> None:
        _, bank = trainer.train_from_stl(self.stl, self.cfg, max_views=n_views, device=self.device)
        self.banks.append(bank)

    def step(self) -> int:
        self._call(self.views)
        return self.views

    def end_to_end(self, units: int, elapsed: float, times_ms: list) -> dict:
        return {"train_views_per_s": units / elapsed}

    def trace_patches(self, p, launches: dict) -> None:
        p.span(trainer._ChunkOnDevice, "__init__", "chunk")
        p.span(trainer, "add_views", "extract")
        spans.record_k1(p, launches)
        spans.record_k4(p, launches)

    def counters(self) -> dict:
        return {"calls": len(self.banks), "views_per_call": self.views}

    def free(self) -> None:
        os.remove(self.stl)

    # -- correctness ---------------------------------------------------------

    def checked_views(self) -> list[int]:
        n = min(self.check_views, self.views)
        return sorted(int(v) for v in rng(self.seed, 4).choice(self.views, n, replace=False))

    def answers(self) -> list[tuple[int, dict]]:
        """Per call of the window, view -> its template record (None when
        the call skipped it) for the checked views."""
        vs = RT.views(self.views)
        out = []
        for bank in self.banks:
            meta = bank.metadata
            by_pose = {(meta.R[i].tobytes(), meta.T[i].tobytes()): i for i in range(len(meta.R))}
            got = {}
            for v in self.checked_views():
                i = by_pose.get((vs[v].R.tobytes(), vs[v].T.tobytes()))
                if i is None:
                    got[v] = None
                    continue
                t = bank.templates[i]
                got[v] = dict(grad=t.grad, norm=t.norm, size=[tuple(s) for s in t.size],
                              rect0=tuple(t.rect0), R=meta.R[i], T=meta.T[i], K=meta.K[i],
                              D=float(meta.D[i]), Ori_dist=float(meta.Ori_dist[i]),
                              Rect=meta.Rect[i])
            out.append((0, got))
        return out

    def reference(self, _ids=None, lower: bool = False) -> dict:
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = lower
        try:
            ref = RT.train_views(self.triangles, self.checked_views(), self.views,
                                 device=self.device,
                                 dtype=torch.bfloat16 if lower else torch.float32,
                                 batch=self.batch, width=self.width, height=self.height,
                                 fx=self.cfg.focal_length_x, fy=self.cfg.focal_length_y)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        return {0: ref}

    @staticmethod
    def compare(answers: list, want: dict) -> dict:
        wrong = 0
        for key, got in answers:
            for v, w in want[key].items():
                g = got.get(v)
                if (g is None) != (w is None):
                    wrong += 1
                    continue
                if g is None:
                    continue
                same = (all(np.array_equal(a, b) for a, b in zip(g["grad"], w["grad"]))
                        and all(np.array_equal(a, b) for a, b in zip(g["norm"], w["norm"]))
                        and len(g["grad"]) == len(w["grad"]) and len(g["norm"]) == len(w["norm"])
                        and [tuple(s) for s in g["size"]] == [tuple(s) for s in w["size"]]
                        and tuple(g["rect0"]) == tuple(w["rect0"])
                        and all(np.array_equal(g[k], w[k]) for k in ("R", "T", "K", "Rect"))
                        and g["D"] == w["D"] and g["Ori_dist"] == w["Ori_dist"])
                wrong += not same
        return LIMITS.numbers(views_wrong=wrong)
