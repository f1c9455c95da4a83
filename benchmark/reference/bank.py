"""The benchmark's own reader of cv::linemod bank files (OpenCV FileStorage
YAML, plain or gzipped), in plain Python and numpy.

It reads only what the plain reference needs and shares no code with the
program's loaders: per template and pyramid level the (y, x, orientation)
feature rows of each modality and the level's (h, w) size, and from a
renderer_params file each template's R, T, K, D, Ori_dist and Rect.
"""

from __future__ import annotations

import gzip
import re
from dataclasses import dataclass

import numpy as np

_INT_ROW = re.compile(r"\[\s*(-?\d+),\s*(-?\d+),\s*(-?\d+)\s*\]")
_ENTRY = re.compile(r"width:\s*(\d+)\s+height:\s*(\d+)\s+pyramid_level:\s*(\d+)")


def read_text(path: str) -> str:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return f.read()


@dataclass
class Bank:
    """A class's templates: `levels[l][n]` is template n's merged rows
    (dy, dx, ori) at level l, ColorGradient orientations 0-7 first, then
    DepthNormal's shifted to 8-15; `sizes[l]` (N, 2) the (h, w) per level."""

    class_id: str
    T: tuple[int, ...]
    modalities: tuple[str, ...]
    levels: list[list[np.ndarray]]
    sizes: list[np.ndarray]
    weak_threshold: float
    distance_threshold: float
    difference_threshold: float

    @property
    def num_templates(self) -> int:
        return len(self.levels[0])

    def tiled(self, reps: int) -> "Bank":
        """The bank repeated `reps` times (copy k of template i is template
        k * N + i).  Dead padding rows are never valid, so they are left
        out: the ids of the real templates are unchanged by them."""
        return Bank(self.class_id, self.T, self.modalities,
                    [lv * reps for lv in self.levels],
                    [np.tile(s, (reps, 1)) for s in self.sizes],
                    self.weak_threshold, self.distance_threshold,
                    self.difference_threshold)


def _modality_param(text: str, mod: str, key: str, default: float) -> float:
    m = re.search(rf"type:\s*{mod}(.*?)(?:- type:|\nT:)", text, re.S)
    if not m:
        return default
    k = re.search(rf"{key}:\s*([-\d.e+]+)", m.group(1))
    return float(k.group(1)) if k else default


def read_templates(path: str) -> Bank:
    text = read_text(path)
    head, _, body = text.partition("template_pyramids:")
    T = tuple(int(v) for v in re.search(r"\nT:\s*\[([^\]]*)\]", head).group(1).split(","))
    mods = tuple(re.findall(r"-\s*type:\s*(\w+)", head))
    cls_mods = re.search(r"class_id:.*?modalities:\s*\[([^\]]*)\]", head, re.S)
    order = tuple(s.strip() for s in cls_mods.group(1).split(",")) if cls_mods else mods
    class_id = re.search(r"class_id:\s*(\S+)", head).group(1)
    n_mod = len(order)
    levels: list[list[np.ndarray]] = [[] for _ in T]
    sizes: list[list[tuple[int, int]]] = [[] for _ in T]
    for pyr in body.split("- template_id:")[1:]:
        parts: dict[int, list] = {}
        size: dict[int, tuple[int, int]] = {}
        for j, entry in enumerate(pyr.split("- width:")[1:]):
            m = _ENTRY.match("width:" + entry)
            w, h, lvl = (int(v) for v in m.groups())
            rows = np.array(_INT_ROW.findall(entry), np.int32).reshape(-1, 3)
            # File rows are [x, y, label]; kept as (dy, dx, ori).
            rows = rows[:, [1, 0, 2]]
            if order[j % n_mod] == "DepthNormal":
                rows = rows + np.array([0, 0, 8], np.int32)
            parts.setdefault(lvl, []).append((order[j % n_mod], rows))
            hw = size.get(lvl, (0, 0))
            size[lvl] = (max(hw[0], h), max(hw[1], w))
        for lvl in range(len(T)):
            ordered = sorted(parts[lvl], key=lambda p: p[0] != "ColorGradient")
            levels[lvl].append(np.concatenate([r for _, r in ordered]))
            sizes[lvl].append(size[lvl])
    return Bank(
        class_id=class_id, T=T, modalities=order, levels=levels,
        sizes=[np.array(s, np.int32) for s in sizes],
        weak_threshold=_modality_param(head, "ColorGradient", "weak_threshold", 10.0),
        distance_threshold=_modality_param(head, "DepthNormal", "distance_threshold", 2000.0),
        difference_threshold=_modality_param(head, "DepthNormal", "difference_threshold",
                                             50.0),
    )


@dataclass
class Params:
    """A renderer_params file: per template R (N, 3, 3), T (N, 3), K (N, 3, 3),
    D, Ori_dist (N,), Rect (N, 4); and the renderer's globals."""

    R: np.ndarray
    T: np.ndarray
    K: np.ndarray
    D: np.ndarray
    Ori_dist: np.ndarray
    Rect: np.ndarray
    globals: dict


def _floats(block: str) -> list[float]:
    return [float(v) for v in re.findall(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?", block)]


def read_params(path: str) -> Params:
    text = read_text(path)
    chunks = re.split(r"\nTemplate \d+:", text)
    R, T, K, D, Od, Rect = [], [], [], [], [], []
    for c in chunks[1:]:
        mats = re.findall(r"data:\s*\[([^\]]*)\]", c)
        R.append(_floats(mats[0]))
        T.append(_floats(mats[1]))
        K.append(_floats(mats[2]))
        D.append(float(re.search(r"\n\s*D:\s*(\S+)", c).group(1)))
        Od.append(float(re.search(r"Ori_dist:\s*(\S+)", c).group(1)))
        Rect.append([int(v) for v in re.search(r"Rect:\s*\[([^\]]*)\]", c).group(1).split(",")])
    glob = {k: float(v) for k, v in re.findall(r"\nrenderer_(\w+):\s*(\S+)", text)}
    return Params(R=np.array(R).reshape(-1, 3, 3), T=np.array(T).reshape(-1, 3),
                  K=np.array(K, np.float32).reshape(-1, 3, 3), D=np.array(D),
                  Ori_dist=np.array(Od), Rect=np.array(Rect, np.int32), globals=glob)
