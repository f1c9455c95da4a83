"""The plain reference of several object classes served from one frame.

What a merged multi-class matcher must reproduce: each class's valid
matches are those of that class's bank matched alone at that class's
threshold, by `matcher.ReferenceMatcher` (its top_k candidates at the
class's threshold - 5, walked, gated at the class's threshold).  Merging
the classes' template axes, pruning at the loosest threshold or walking
the classes' candidates together may change how the work is done, never
which matches a class reports.  Answers are compared per class as
multisets (`matcher.valid_set`): neighbouring candidates can walk to one
match.

Classes that share a bank share its coarse pass: one coarse scoring per
unique bank and frame, then one selection and one walk per class.
"""

from __future__ import annotations

import numpy as np
import torch

from . import matcher as RM
from .bank import Bank


class MultiClassReference:
    """Exact per-class matches of frames against `banks` (one per class,
    a bank object given twice is scored once) at `thresholds`.  `dtype`
    is the float chains' precision, as in ReferenceMatcher."""

    def __init__(self, banks: list[Bank], thresholds: list[float], top_k: int,
                 device="cuda", dtype=torch.float32):
        if len(banks) != len(thresholds):
            raise ValueError("need one threshold per class")
        self.classes = [RM.ReferenceMatcher(b, float(t), top_k, order="position",
                                            device=device, dtype=dtype)
                        for b, t in zip(banks, thresholds)]
        # class index -> the first class of its bank, whose coarse pass it reads
        first: dict[int, int] = {}
        self.owner = [first.setdefault(id(b), c) for c, b in enumerate(banks)]
        self.device, self.dtype = torch.device(device), dtype

    def match(self, rgbs: np.ndarray, depths_mm: np.ndarray | None) -> list[list[dict]]:
        """Frames (B, H, W, 3) u8 [+ (B, H, W) mm] -> per frame, per class,
        the walked candidates in slot order (dicts of numpy arrays; mask by
        valid)."""
        out = []
        for b in range(rgbs.shape[0]):
            rgb = torch.from_numpy(np.ascontiguousarray(rgbs[b:b + 1])).to(self.device)
            dep = None if depths_mm is None else torch.from_numpy(
                np.ascontiguousarray(depths_mm[b:b + 1], np.float32)).to(self.device)
            coarse: dict[int, tuple] = {}
            frame = []
            for c, ref in enumerate(self.classes):
                o = self.owner[c]
                if o not in coarse:
                    R0, R1 = RM.preprocess(rgb, dep, ref.bank, self.dtype)
                    coarse[o] = (R0[0], R1.shape[-1] // ref.bank.T[1], *ref.coarse_scores(R1[0]))
                R0, Wc, raw, vpos = coarse[o]
                t, pos, _ = ref.select(raw, vpos)
                frame.append(ref.walk(R0, t, pos, Wc))
            out.append(frame)
        return out
