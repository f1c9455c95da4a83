"""Driver of the merged multi-class matcher: B host frames a step through
`MultiClassBatchedMatcher.match_batch` (the pooled path), closed loop,
every class's matches copied to the host.

Configuration keys it reads: `templates`, `params`, `classes` (the bank
file's class first; the same bank is attached again under each further
id), `thresholds` (one a class) and `matcher` (the matcher's settings, the
pools per frame of the batch).  Traffic parameters
(`benchmark/traffic/<mix>.json`): `batch`, `pool` (scenes in the seeded
pool, drawn in turn), `objects` (planted views a scene, later ones may
overlap earlier ones), `views` (bank poses rendered as the views to plant,
drawn from the seed), `trace_steps`.
"""

from __future__ import annotations

import numpy as np
import torch

from linemod_pose_estimation_tpu_torch.models import serving
from linemod_pose_estimation_tpu_torch.models.detector import Detector
from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank
from linemod_pose_estimation_tpu_torch.ops import match as M

from ..reference import bank as RB
from ..reference import matcher as RM
from ..reference.multiclass import MultiClassReference
from . import scenes
from .common import Limits, bank_path, params_path, rng, seeded_templates

# frames_wrong: frames where any class's valid matches differ from the
# reference's in any (template, x, y, similarity bits): an exact comparison.
# classes_unmatched: classes with no valid match in any of the reference's
# frames, so that a class the window never exercises fails the run rather
# than passing on empty answers.
LIMITS = Limits(frames_wrong=0, classes_unmatched=0)


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.config, self.device = config, device
        self.B = int(traffic["batch"])
        self.classes = list(config["classes"])
        self.thresholds = [float(t) for t in config["thresholds"]]
        det = Detector.read(bank_path(config), device=device)
        bank = det.bank(det.class_ids[0])
        if bank.class_id != self.classes[0]:
            raise ValueError(f"the bank file holds class {bank.class_id!r}, the "
                             f"configuration names {self.classes[0]!r} first")
        for cid in self.classes[1:]:
            det.attach_bank(TemplateBank(cid, bank.params, bank.templates, f_cap=bank.f_cap))
        mk = config["matcher"]
        self.top_k = int(mk["top_k"])
        self.matcher = serving.MultiClassBatchedMatcher(
            det, self.classes, self.thresholds, self.B, top_k=self.top_k,
            fine_g=int(mk["fine_g"]), prune_mode=mk["prune_mode"],
            pool_coarse=int(mk["pool_coarse_per_frame"]) * self.B,
            pool_fine=int(mk["pool_fine_per_frame"]) * self.B,
            sel_row_cap=int(mk["sel_row_cap"]), device=device)
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
        # Contiguous slices of the pool, drawn in turn: a step hands the
        # program its frames without a copy on the host.
        self.batches = [np.arange(s, s + self.B) for s in range(0, pool, self.B)]
        self.records: list = []  # (scene indices, [host Matches fields per class])
        self.next = 0
        for _ in range(2):  # warm-up: builds the kernels, fills the allocator
            self.step()
        if device.type == "cuda":
            torch.cuda.synchronize()
        self.records.clear()
        self.next = 0

    def step(self) -> int:
        idx = self.batches[self.next]
        self.next = (self.next + 1) % len(self.batches)
        sl = slice(int(idx[0]), int(idx[-1]) + 1)
        out = self.matcher.match_batch(self.rgbs[sl], self.deps[sl])
        self.records.append((idx, [{k: getattr(out[c], k).cpu().numpy()
                                    for k in M.Matches._fields} for c in self.classes]))
        return self.B

    def end_to_end(self, units: int, elapsed: float, times_ms: list) -> dict:
        return {"frames_per_s": units / elapsed}

    def trace_patches(self, p, launches: dict) -> None:
        """Nothing to patch: the cell's metrics read the program's own spans."""

    def counters(self) -> dict:
        return {"batches": len(self.records)}

    def free(self) -> None:
        del self.matcher

    # -- correctness ---------------------------------------------------------

    def answers(self) -> list[tuple[int, tuple]]:
        """(scene, per class its valid matches) for every frame of the window."""
        return [(int(i), tuple(RM.valid_set({k: v[b] for k, v in host.items()})
                               for host in hosts))
                for idx, hosts in self.records for b, i in enumerate(idx)]

    def reference(self, scenes_ids, lower: bool = False) -> dict:
        """scene -> per class the reference's valid matches (`lower`: the
        control's precision)."""
        bank = RB.read_templates(bank_path(self.config))
        ref = MultiClassReference([bank] * len(self.classes), self.thresholds, self.top_k,
                                  device=self.device,
                                  dtype=torch.bfloat16 if lower else torch.float32)
        ids, out = sorted(scenes_ids), {}
        for s in range(0, len(ids), 8):
            chunk = ids[s:s + 8]
            for i, frame in zip(chunk, ref.match(self.rgbs[chunk], self.deps[chunk])):
                out[i] = tuple(RM.valid_set(m) for m in frame)
        return out

    @staticmethod
    def compare(answers: list[tuple[int, tuple]], want: dict) -> dict:
        n = len(next(iter(want.values())))
        unmatched = sum(not any(w[c] for w in want.values()) for c in range(n))
        return LIMITS.numbers(frames_wrong=sum(a != want[i] for i, a in answers),
                              classes_unmatched=unmatched)
