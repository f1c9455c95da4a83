"""Driver of the batched matcher: B host frames a step through
`BatchedMatcher.match_batch`, closed loop, each step's matches copied to
the host.

Traffic parameters (`benchmark/traffic/<mix>.json`): `batch`, `pool`
(scenes in the seeded pool, drawn in turn), `objects` (planted views a
scene, later ones may overlap earlier ones), `views` (bank poses rendered
as the views to plant, drawn from the seed), `threshold`, `trace_steps`.
"""

from __future__ import annotations

import numpy as np
import torch

from linemod_pose_estimation_tpu_torch.models import serving
from linemod_pose_estimation_tpu_torch.models.detector import Detector
from linemod_pose_estimation_tpu_torch.ops import match as M

from ..reference import bank as RB
from ..reference import matcher as RM
from . import scenes, spans
from .common import Limits, bank_path, params_path, rng, seeded_templates

# frames_wrong: frames whose valid matches differ from the reference's in
# any (template, x, y, similarity bits): an exact comparison.
LIMITS = Limits(frames_wrong=0)


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.config, self.device = config, device
        self.B = int(traffic["batch"])
        self.threshold = float(traffic["threshold"])
        det = Detector.read(bank_path(config), device=device)
        cid = det.class_ids[0]
        reps, pad_to = config.get("tile", [1, 0])
        if reps > 1:
            det.attach_bank(det.bank(cid).tile(reps, pad_to))
        self.matcher = serving.BatchedMatcher(det, cid, self.threshold, self.B,
                                              device=device, **serving.slice_settings(self.B))
        self.top_k = self.matcher.top_k
        # The scenes: bank poses of the seed's templates rendered from the
        # cuboid, planted on seeded backgrounds (numpy, pageable memory).
        prm = RB.read_params(params_path(config))
        tids = seeded_templates(seed, len(prm.R), int(traffic["views"]))
        views = scenes.render_views(scenes.cuboid_triangles(), prm.R[tids], prm.T[tids],
                                    prm.globals["focal_length_x"],
                                    prm.globals["focal_length_y"], device=device)
        pool = int(traffic["pool"])
        if pool % self.B:
            raise ValueError(f"pool {pool} is not a whole number of batches of {self.B}")
        self.rgbs, self.deps, _ = scenes.scene_pool(pool, int(traffic["objects"]),
                                                    rng(seed, 2), views)
        # The batches, drawn in turn: contiguous slices of the pool, so a
        # step hands the program its frames without a copy on the host.
        self.batches = [np.arange(s, s + self.B) for s in range(0, pool, self.B)]
        self.records: list = []  # (scene indices, host Matches fields)
        self.fallback: list[bool] = []
        self.next = 0
        for _ in range(2):  # warm-up: builds the kernels, fills the allocator
            self.step()
        if device.type == "cuda":
            torch.cuda.synchronize()
        self.records.clear()
        self.fallback.clear()
        self.next = 0

    def step(self) -> int:
        idx = self.batches[self.next]
        self.next = (self.next + 1) % len(self.batches)
        sl = slice(int(idx[0]), int(idx[-1]) + 1)
        m = self.matcher.match_batch(self.rgbs[sl], self.deps[sl])
        self.records.append((idx, {k: getattr(m, k).cpu().numpy() for k in m._fields}))
        self.fallback.append(bool(self.matcher.last_pool.fallback))
        return self.B

    def end_to_end(self, units: int, elapsed: float, times_ms: list) -> dict:
        return {"frames_per_s": units / elapsed}

    def trace_patches(self, p, launches: dict) -> None:
        p.span(serving, "_frames", "entry.h2d")
        p.span(M, "preprocess_frames_batched", "preprocess")
        p.span(M, "match_pooled_fine_with_fallback", "pooled_matcher")
        p.span(M, "refine_candidates_opencv_batched", "walk")
        spans.record_k1(p, launches)
        spans.record_k2(p, launches)

    def counters(self) -> dict:
        return {"pool_fallback": list(self.fallback), "batches": len(self.records)}

    def free(self) -> None:
        del self.matcher

    # -- correctness ---------------------------------------------------------

    def answers(self) -> list[tuple[int, list]]:
        """(scene, its valid matches) for every frame of the window."""
        return [(int(i), RM.valid_set({k: v[b] for k, v in host.items()}))
                for idx, host in self.records for b, i in enumerate(idx)]

    def reference(self, scenes_ids, lower: bool = False) -> dict:
        """scene -> the reference's valid matches (`lower`: the control's
        precision)."""
        bank = RB.read_templates(bank_path(self.config))
        ref = RM.ReferenceMatcher(bank, self.threshold, self.top_k,
                                  reps=self.config.get("tile", [1, 0])[0], order="position",
                                  device=self.device,
                                  dtype=torch.bfloat16 if lower else torch.float32)
        ids, out = sorted(scenes_ids), {}
        for s in range(0, len(ids), 8):
            chunk = ids[s:s + 8]
            for i, m in zip(chunk, ref.match(self.rgbs[chunk], self.deps[chunk])):
                out[i] = RM.valid_set(m)
        return out

    @staticmethod
    def compare(answers: list[tuple[int, list]], want: dict) -> dict:
        return LIMITS.numbers(frames_wrong=sum(a != want[i] for i, a in answers))
