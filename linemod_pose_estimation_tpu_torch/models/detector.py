"""The Detector: cv::linemod::Detector-style host API over the scoring
engine — the port of ``linemod_pose_estimation_tpu/models/detector.py``.

`add_template` extracts a template from a view (its quantizations on the
detector's device: K1's trainer variant on the card) and appends it to
its class's list; `bank()` builds the class's padded bank from that list
when first asked.  `match_raw` / `match` are the single-frame engine: preprocess (K1, K2 at
B=1), the exact int8 GEMM over every coarse position, template-major
top-k selection, and cv::linemod's exact walk (K3 at B=1).
`make_matcher_fn` is the reference's serving fn: the same engine with
the position-major GEMM and select.  Frame batches go through
``models.serving.BatchedMatcher``.  `device` places the bank operands
and the computation (default the card; `device="cpu"` runs the plain
PyTorch versions on the host).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import match as M
from ..utils.device import DEFAULT_DEVICE, resolve_device
from .templates import DetectorParams, TemplateBank, TemplateFeatures, extract_template


def to_device(a, dtype, device) -> torch.Tensor:
    """A numpy array or tensor as a `dtype` tensor on `device` (numpy
    input is copied, so read-only arrays are fine)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


@dataclass
class MatchResult:
    """Host-side view of matches for one class (cv::linemod::Match analog)."""

    class_id: str
    x: np.ndarray  # (M,) int
    y: np.ndarray
    template_id: np.ndarray
    similarity: np.ndarray  # percent

    def __len__(self) -> int:
        return len(self.x)


class Detector:
    def __init__(self, params: DetectorParams | None = None, f_cap: int = 64,
                 device=DEFAULT_DEVICE):
        self.params = params or DetectorParams()
        self.f_cap = f_cap
        self.device = resolve_device(device)
        self._templates: dict[str, list[TemplateFeatures]] = {}
        self._banks: dict[str, TemplateBank] = {}
        self._operands: dict[str, tuple] = {}

    @property
    def class_ids(self) -> list[str]:
        return list(self._templates.keys())

    def num_templates(self, class_id: str | None = None) -> int:
        """Templates of one class (0 for an unknown one), or of all."""
        if class_id is not None:
            return len(self._templates.get(class_id, []))
        return sum(len(v) for v in self._templates.values())

    def add_template(self, rgb, mask, class_id: str = "obj", depth_mm=None,
                     precomputed: dict | None = None) -> int:
        """Extract and store a template (``templates.extract_template``);
        returns its id, or -1 when the view has too few features (the
        original trainer skips such views).  Drops the class's built bank
        and its device operands."""
        t = extract_template(rgb, depth_mm, mask, self.params, precomputed, device=self.device)
        if t is None:
            return -1
        self._templates.setdefault(class_id, []).append(t)
        self._banks.pop(class_id, None)
        self._operands.pop(class_id, None)
        return len(self._templates[class_id]) - 1

    def attach_bank(self, bank: TemplateBank) -> None:
        self._templates[bank.class_id] = bank.templates
        self._banks[bank.class_id] = bank
        self._operands.pop(bank.class_id, None)

    def bank(self, class_id: str) -> TemplateBank:
        """The class's bank, built from its template list when first asked."""
        if class_id not in self._banks:
            self._banks[class_id] = TemplateBank(class_id, self.params,
                                                 self._templates[class_id], f_cap=self.f_cap)
        return self._banks[class_id]

    def template_rect0(self, class_id: str, template_id: int) -> tuple[int, int, int, int]:
        """A template's level-0 (x, y, w, h) bounding box."""
        return self._templates[class_id][template_id].rect0

    # -- serialization ------------------------------------------------------

    def write(self, path: str, class_id: str | None = None) -> None:
        """Write one class's bank (the first by default) as a cv::linemod
        templates.yml."""
        self.bank(class_id or self.class_ids[0]).write_templates_yaml(path)

    @classmethod
    def read(cls, path: str, f_cap: int = 64, device=DEFAULT_DEVICE) -> "Detector":
        bank = TemplateBank.read_templates_yaml(path, f_cap=f_cap)
        det = cls(bank.params, f_cap=f_cap, device=device)
        det.attach_bank(bank)
        return det

    # -- matching -----------------------------------------------------------

    def _bank_operands(self, class_id: str):
        """(feats1, feats0, W_gemm) of a class on the detector's device,
        built once."""
        if class_id not in self._operands:
            bank = self.bank(class_id)
            feats1 = bank.merged_features(1).to(self.device)
            W = M.build_gemm_weights(feats1, 8 * bank.num_modalities,
                                     self.params.t_pyramid[1], bank.max_cell_extent(1))
            self._operands[class_id] = (feats1, bank.merged_features(0).to(self.device),
                                        M.MatmulWeight.from_kn(W))
        return self._operands[class_id]

    def match_raw(self, rgb, threshold: float, depth_mm=None,
                  class_ids: list[str] | None = None, top_k: int = 512
                  ) -> dict[str, M.Matches]:
        """Device-side match of one frame: padded (top_k,) Matches with a
        validity mask per class."""
        p = self.params
        use_depth = p.use_depth_normal and depth_mm is not None
        rgb = to_device(rgb, torch.uint8, self.device)
        if depth_mm is not None:
            depth_mm = to_device(depth_mm, torch.float32, self.device)
        pyr = M.preprocess_frame(rgb, depth_mm, T0=p.t_pyramid[0], T1=p.t_pyramid[1],
                                 use_depth=use_depth,
                                 weak_threshold=p.color.weak_threshold)
        return {cid: self._match_class(cid, pyr, threshold, top_k)
                for cid in class_ids or self.class_ids}

    def match(self, rgb, threshold: float, depth_mm=None,
              class_ids: list[str] | None = None, top_k: int = 512
              ) -> dict[str, MatchResult]:
        """Full pyramid match of every class over one frame, valid matches
        only, on the host."""
        out: dict[str, MatchResult] = {}
        for cid, m in self.match_raw(rgb, threshold, depth_mm, class_ids, top_k).items():
            ok = m.valid.cpu().numpy()
            out[cid] = MatchResult(
                class_id=cid, x=m.x.cpu().numpy()[ok], y=m.y.cpu().numpy()[ok],
                template_id=m.template_id.cpu().numpy()[ok],
                similarity=m.similarity.cpu().numpy()[ok],
            )
        return out

    def _response_stacks(self, pyr: M.FramePyramid):
        p = self.params
        r0 = [pyr.grad_r0] if p.use_color_gradient else []
        r1 = [pyr.grad_r1] if p.use_color_gradient else []
        if p.use_depth_normal:
            r0.append(pyr.norm_r0)
            r1.append(pyr.norm_r1)
        return torch.cat(r0, dim=0), torch.cat(r1, dim=0)

    def _match_class(self, class_id: str, pyr: M.FramePyramid, threshold: float,
                     top_k: int) -> M.Matches:
        p = self.params
        T0, T1 = p.t_pyramid
        bank = self.bank(class_id)
        feats1, feats0, W_gemm = self._bank_operands(class_id)
        R0, R1 = self._response_stacks(pyr)
        raw = M.coarse_scores_gemm(R1, W_gemm, T1, bank.max_cell_extent(1))
        Hc, Wc = raw.shape[1:]
        vpos = M.position_validity(feats1.size, T1, Hc, Wc)
        # The coarse gate is 5 below the reported (level-0) threshold.
        cand = M.select_candidates(raw, feats1.count, vpos, threshold - 5.0, top_k)
        return M.refine_candidates_opencv(R0, feats0, cand, T1, threshold,
                                          E0=bank.extent(0), fine_T=T0)

    # -- serving fn ---------------------------------------------------------

    def make_matcher_fn(self, class_id: str, threshold: float, top_k: int = 512,
                        approx_select: bool = True,
                        use_pallas_refine: bool | None = None):
        """fn(rgb, depth_mm=None) -> Matches (top_k,) of one frame:
        preprocess at B=1, the position-major exact int8 GEMM, the top_k
        select at threshold - 5 and cv::linemod's walk.  The reference's
        `approx_select` picks approx_max_k over an exact top_k; the port's
        select is exact either way (on the reference's CPU backend the two
        agree).  `use_pallas_refine=False` runs the walk's plain version
        even on the card; otherwise CUDA tensors launch K3."""
        p = self.params
        T0, T1 = p.t_pyramid
        bank = self.bank(class_id)
        feats1, feats0, W_gemm = self._bank_operands(class_id)
        Kc1, E0 = bank.max_cell_extent(1), bank.extent(0)
        plain = use_pallas_refine is False

        def fn(rgb, depth_mm=None) -> M.Matches:
            rgb = to_device(rgb, torch.uint8, self.device)
            if depth_mm is not None:
                depth_mm = to_device(depth_mm, torch.float32, self.device)
            pyr = M.preprocess_frame(rgb, depth_mm, T0=T0, T1=T1,
                                     use_depth=p.use_depth_normal,
                                     weak_threshold=p.color.weak_threshold)
            R0, R1 = self._response_stacks(pyr)
            raw = M.coarse_scores_gemm_flat(R1, W_gemm, T1, Kc1)
            Hc, Wc = R1.shape[1] // T1, R1.shape[2] // T1
            vpos = M.position_validity_flat(feats1.size, T1, Hc, Wc)
            cand = M.select_candidates_flat(raw[None], feats1.count, vpos,
                                            threshold - 5.0, top_k, Wc)
            return M.refine_candidates_opencv(
                R0, feats0, M.CoarseMatches(*(a[0] for a in cand)), T1,
                threshold, E0=E0, fine_T=T0, plain=plain)

        return fn
