"""Driver of the Ensenso deployment: B raw mono frames a step, as the
camera's stereo-left image arrives (752x480 u8), through
`BatchedMatcher.match_batch` with the pose service's frame conditioning
(one copy to the card as they are; mono -> 3 channels, the 3x3 blur and the
640x480 crop on the card), against the colour-only bank, closed loop, each
step's matches copied to the host.

Configuration keys it reads: `templates`, `params`, `modalities`, `tile`,
`frame_in`, `bias_x`, `crop`, `blur`, `threshold`.  The matcher's pools are
the program's own for the bank's modalities (`serving.slice_settings`).
Traffic parameters (`benchmark/traffic/<mix>.json`): `batch`, `pool`
(scenes in the seeded pool, drawn in turn), `objects` (planted views a
scene, later ones may overlap earlier ones), `views` (bank poses rendered
as the views to plant, drawn from the seed), `threshold`, `width`,
`height` and `bias_x` (the camera's frames, which must be the
configuration's), `trace_steps`.

The scenes are rendered in colour at the camera's size and turned to mono
by one fixed integer formula (BT.601 luma): the Ensenso is a grayscale
camera.
"""

from __future__ import annotations

import numpy as np
import torch

from linemod_pose_estimation_tpu_torch.api.service import FrameConditioning
from linemod_pose_estimation_tpu_torch.models import serving
from linemod_pose_estimation_tpu_torch.models.detector import Detector

from ..reference import bank as RB
from ..reference import ensenso as RE
from ..reference import matcher as RM
from . import scenes
from .common import Limits, bank_path, params_path, rng, seeded_templates

# frames_wrong: frames whose valid matches differ from the reference's in
# any (template, x, y, similarity bits): an exact comparison.
# window_unmatched: 1 where the reference matches nothing in any frame of
# the window, so that a window the threshold leaves empty fails the run
# rather than passing on empty answers.
LIMITS = Limits(frames_wrong=0, window_unmatched=0)


def to_mono(rgbs: np.ndarray) -> np.ndarray:
    """(n, H, W, 3) u8 RGB -> (n, H, W) u8 BT.601 luma, in integers:
    (4899 R + 9617 G + 1868 B + 8192) >> 14."""
    c = rgbs.astype(np.int32)
    return ((4899 * c[..., 0] + 9617 * c[..., 1] + 1868 * c[..., 2] + 8192) >> 14
            ).astype(np.uint8)


def conditioning(config: dict) -> dict:
    """The configuration's frame conditioning as keywords."""
    crop_w, crop_h = config["crop"]
    return dict(bias_x=int(config["bias_x"]), crop_w=int(crop_w), crop_h=int(crop_h),
                blur=bool(config["blur"]))


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.config, self.device = config, device
        self.B = int(traffic["batch"])
        self.threshold = float(config["threshold"])
        W, H = (int(v) for v in config["frame_in"])
        if (float(traffic["threshold"]), int(traffic["width"]), int(traffic["height"]),
                int(traffic["bias_x"])) != (self.threshold, W, H, int(config["bias_x"])):
            raise ValueError("the mix's threshold, frame size or bias_x is not the "
                             "configuration's")
        self.cond = conditioning(config)
        # The program's settings first: a program without the conditioned
        # entry or the one-modality pools fails here, before any work.
        settings = serving.slice_settings(self.B, modalities=len(config["modalities"]))
        det = Detector.read(bank_path(config), device=device)
        cid = det.class_ids[0]
        reps, pad_to = config.get("tile", [1, 0])
        if reps > 1:
            det.attach_bank(det.bank(cid).tile(reps, pad_to))
        self.matcher = serving.BatchedMatcher(
            det, cid, self.threshold, self.B, device=device,
            conditioning=FrameConditioning(**self.cond), **settings)
        self.top_k = self.matcher.top_k
        # The scenes: bank poses of the seed's templates rendered from the
        # cuboid at the camera's size, planted on seeded backgrounds, then
        # mono (numpy, pageable memory).
        prm = RB.read_params(params_path(config))
        tids = seeded_templates(seed, len(prm.R), int(traffic["views"]))
        views = scenes.render_views(scenes.cuboid_triangles(), prm.R[tids], prm.T[tids],
                                    prm.globals["focal_length_x"],
                                    prm.globals["focal_length_y"], W=W, H=H, device=device)
        pool = int(traffic["pool"])
        if pool % self.B:
            raise ValueError(f"pool {pool} is not a whole number of batches of {self.B}")
        rgbs, _, _ = scenes.scene_pool(pool, int(traffic["objects"]), rng(seed, 2), views)
        self.frames = to_mono(rgbs)
        # Contiguous slices of the pool, drawn in turn: a step hands the
        # program its frames without a copy on the host.
        self.batches = [np.arange(s, s + self.B) for s in range(0, pool, self.B)]
        self.records: list = []  # (scene indices, host Matches fields)
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
        m = self.matcher.match_batch(self.frames[int(idx[0]):int(idx[-1]) + 1])
        self.records.append((idx, {k: getattr(m, k).cpu().numpy() for k in m._fields}))
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

    def answers(self) -> list[tuple[int, list]]:
        """(scene, its valid matches) for every frame of the window."""
        return [(int(i), RM.valid_set({k: v[b] for k, v in host.items()}))
                for idx, host in self.records for b, i in enumerate(idx)]

    def reference(self, scenes_ids, lower: bool = False) -> dict:
        """scene -> the reference's valid matches on the same mono frames
        (`lower`: the control's precision)."""
        bank = RB.read_templates(bank_path(self.config))
        ref = RE.EnsensoReference(bank, self.threshold, self.top_k, self.cond,
                                  reps=self.config.get("tile", [1, 0])[0], device=self.device,
                                  dtype=torch.bfloat16 if lower else torch.float32)
        ids, out = sorted(scenes_ids), {}
        for s in range(0, len(ids), 8):
            chunk = ids[s:s + 8]
            for i, m in zip(chunk, ref.match(self.frames[chunk])):
                out[i] = RM.valid_set(m)
        return out

    @staticmethod
    def compare(answers: list[tuple[int, list]], want: dict) -> dict:
        return LIMITS.numbers(frames_wrong=sum(a != want[i] for i, a in answers),
                              window_unmatched=int(not any(want.values())))
