"""The Detector: cv::linemod::Detector-style host API over the scoring
engine — the bank half of ``linemod_pose_estimation_tpu/models/detector.py``
(`read`, `bank`, `class_ids`, `params`, `attach_bank`).  Template
extraction (`add_template`) and the single-frame match engines are not
ported yet; frames are matched through ``models.serving.BatchedMatcher``.
"""

from __future__ import annotations

from .templates import DetectorParams, TemplateBank


class Detector:
    def __init__(self, params: DetectorParams | None = None, f_cap: int = 64):
        self.params = params or DetectorParams()
        self.f_cap = f_cap
        self._banks: dict[str, TemplateBank] = {}

    @property
    def class_ids(self) -> list[str]:
        return list(self._banks.keys())

    def attach_bank(self, bank: TemplateBank) -> None:
        self._banks[bank.class_id] = bank

    def bank(self, class_id: str) -> TemplateBank:
        return self._banks[class_id]

    @classmethod
    def read(cls, path: str, f_cap: int = 64) -> "Detector":
        bank = TemplateBank.read_templates_yaml(path, f_cap=f_cap)
        det = cls(bank.params, f_cap=f_cap)
        det.attach_bank(bank)
        return det
