"""Template extraction and template banks — the port of
``linemod_pose_estimation_tpu/models/templates.py``.

- Extraction (cv::linemod's Modality::extractTemplate): the quantizations
  of every pyramid level come from the device (``quantize_levels``: K1's
  variant with the squared magnitudes and DN on the card, the plain
  versions on the CPU; DepthNormal once at level 0, subsampled per
  level); the
  selection is host numpy: the strongest scattered gradient features
  above strong_threshold (a stable sort by magnitude, then the greedy
  scatter walk with a shrinking distance), and interior surface-normal
  features ranked by their distance to the mask's border; both levels are
  cropped to a common bbox (cv::linemod cropTemplates).
- Banks: parameters, per-template feature lists, the padded LevelFeatures
  stacks and the derived extents, the per-template pose metadata of a
  renderer_params.yml (``TemplateMetadata``, ``RendererGlobals``), the
  bank's serialization in cv::linemod's own YAML schema, and the
  renderer's per-template render dump.  Banks and params load through the
  native C++ loader (``utils/native.py``) where it builds and through
  PyYAML (``utils/opencv_yaml.py``) otherwise, with equal results; the
  writers need neither.  Bank arrays live on the CPU; matchers copy what
  they need to their device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from scipy.ndimage import distance_transform_edt

from ..ops import cuda_preprocess as CP
from ..ops import features as F
from ..ops.match import LevelFeatures
from ..utils import opencv_yaml as oy
from ..utils import tracing
from ..utils.device import DEFAULT_DEVICE, resolve_device


def _maybe_ungz(path: str) -> str:
    """Decompress a `.gz` bank to a cached temp file so the native C++
    parser sees plain YAML (committed banks ship gzipped)."""
    if not path.endswith(".gz"):
        return path
    import gzip
    import hashlib
    import os
    import tempfile

    st = os.stat(path)
    tag = hashlib.sha1(
        f"{os.path.abspath(path)}:{st.st_size}:{st.st_mtime_ns}".encode()
    ).hexdigest()[:16]
    dst = os.path.join(tempfile.gettempdir(), f"lpe_bank_{tag}.yml")
    if not os.path.exists(dst):
        # Per-process temp + atomic replace: concurrent loaders publish
        # identical content, last writer wins.
        tmp = f"{dst}.{os.getpid()}.part"
        try:
            with gzip.open(path, "rb") as f, open(tmp, "wb") as g:
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    g.write(chunk)
            os.replace(tmp, dst)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return dst


@dataclass
class ModalityParams:
    weak_threshold: float = 10.0
    num_features: int = 63
    strong_threshold: float = 55.0
    # DepthNormal:
    distance_threshold: float = 2000.0
    difference_threshold: float = 50.0
    extract_threshold: int = 2


@dataclass
class DetectorParams:
    t_pyramid: tuple[int, ...] = (5, 8)  # T at level 0, level 1
    use_color_gradient: bool = True
    use_depth_normal: bool = False
    color: ModalityParams = field(default_factory=ModalityParams)
    depth: ModalityParams = field(default_factory=ModalityParams)

    @property
    def pyramid_levels(self) -> int:
        return len(self.t_pyramid)


@dataclass
class TemplateMetadata:
    """Per-template pose metadata — the renderer_params.yml schema."""

    R: np.ndarray  # (N, 3, 3) float64 object -> camera
    T: np.ndarray  # (N, 3) float64 (X_cam = R (X + T))
    K: np.ndarray  # (N, 3, 3) float32
    D: np.ndarray  # (N,) float64 (Ori_dist - centre surface depth)
    Ori_dist: np.ndarray  # (N,) float64
    Rect: np.ndarray  # (N, 4) int32 renderer mask bbox at level 0


@dataclass
class RendererGlobals:
    n_points: int = 150
    angle_step: int = 10
    radius_min: float = 0.5
    radius_max: float = 1.0
    radius_step: float = 0.1
    width: int = 640
    height: int = 480
    focal_length_x: float = 535.566011
    focal_length_y: float = 537.168115
    near: float = 0.1
    far: float = 1000.0


@dataclass
class TemplateFeatures:
    """One template: per-level, per-modality feature lists (numpy)."""

    # lists over pyramid levels; each entry (F, 3) int32 rows (y, x, ori)
    grad: list[np.ndarray]
    norm: list[np.ndarray]
    size: list[tuple[int, int]]  # (h, w) per level of the cropped bbox
    rect0: tuple[int, int, int, int]  # level-0 (x, y, w, h) bbox


# ---------------------------------------------------------------------------
# Extraction
# ---------------------------------------------------------------------------


def _select_scattered(candidates: np.ndarray, scores: np.ndarray, num: int) -> np.ndarray:
    """OpenCV selectScatteredFeatures: walk candidates in score order, keep
    those >= `distance` from every ALREADY-KEPT feature; when the scan wraps,
    relax distance by 1 and continue — accepted features persist across
    relaxations, as in OpenCV's loop."""
    tracing.count("extract.candidates", candidates.shape[0])
    order = np.argsort(-scores, kind="stable")
    return _select_from_sorted(candidates[order], num)


def _select_from_sorted(cand: np.ndarray, num: int) -> np.ndarray:
    """selectScatteredFeatures over candidates ALREADY in score order (a
    stable order: ties keep their candidate order)."""
    n = cand.shape[0]
    if n == 0:
        return cand
    distance = float(n / num + 1)
    cap = min(num, n)
    cy = cand[:, 0].astype(np.float64)
    cx = cand[:, 1].astype(np.float64)
    # mind2[i] = squared distance from candidate i to its nearest KEPT
    # feature, updated on every accept.  A wrap is one vectorized
    # mind2 >= d^2 test plus a short sequential re-check, and wraps that
    # cannot admit anything are skipped by jumping the distance to the
    # next one that can: the same candidates in the same order as the
    # naive walk (dense depth-normal candidate sets start the distance at
    # hundreds of pixels).
    mind2 = np.full(n, np.inf)
    kept_idx: list[int] = []
    while len(kept_idx) < cap and distance >= 1.0:
        d2 = distance * distance
        passing = np.nonzero(mind2 >= d2)[0]
        for j in passing:
            if mind2[j] >= d2:  # re-check vs accepts earlier in this wrap
                kept_idx.append(j)
                np.minimum(
                    mind2, (cy - cy[j]) ** 2 + (cx - cx[j]) ** 2, out=mind2
                )
                if len(kept_idx) == cap:
                    break
        if len(kept_idx) == cap:
            break
        # After a full wrap every candidate has mind2 < d2; the next wrap
        # that can admit anything is at distance - k with
        # k = ceil(distance - sqrt(max mind2)).
        s = float(np.sqrt(mind2.max()))
        distance -= max(1.0, float(np.ceil(distance - s)))
    return cand[kept_idx].copy() if kept_idx else cand[:0].copy()


def _bit_to_index(bitmask: np.ndarray) -> np.ndarray:
    """uint8 one-hot bitmask -> bin index (valid only where nonzero)."""
    return np.argmax((bitmask[..., None] >> np.arange(8)) & 1, axis=-1).astype(np.int32)


def extract_gradient_features(
    mask: np.ndarray, params: ModalityParams, num: int,
    quant: np.ndarray, mag2: np.ndarray,
) -> np.ndarray | None:
    """(y, x, ori) rows of one pyramid level from its bitmask and squared
    magnitudes, or None if too few features."""
    strong2 = params.strong_threshold**2
    sel = (quant != 0) & (mag2 > strong2) & (mask > 0)
    ys, xs = np.nonzero(sel)
    if ys.size < num // 2 or ys.size == 0:
        return None
    oris = _bit_to_index(quant[ys, xs])
    cand = np.stack([ys, xs, oris], axis=1).astype(np.int32)
    feats = _select_scattered(cand, mag2[ys, xs], num)
    return feats if feats.shape[0] >= num // 2 else None


def extract_normal_features(
    mask: np.ndarray, params: ModalityParams, num: int, quant: np.ndarray,
) -> np.ndarray | None:
    """(y, x, ori) rows of one pyramid level from its DepthNormal bitmask:
    candidates deeper than extract_threshold inside the mask, ranked by
    their distance to its border; or None if too few features."""
    dist = distance_transform_edt(mask > 0)
    sel = (quant != 0) & (dist > params.extract_threshold)
    ys, xs = np.nonzero(sel)
    if ys.size == 0:
        return None
    oris = _bit_to_index(quant[ys, xs])
    cand = np.stack([ys, xs, oris], axis=1).astype(np.int32)
    feats = _select_scattered(cand, dist[ys, xs], num)
    return feats if feats.shape[0] >= num // 2 else None


def quantize_levels(rgb: torch.Tensor, depth_mm: torch.Tensor | None,
                    params: "DetectorParams") -> tuple[list, list]:
    """The quantizations extraction selects from, for a batch of views on
    one device: rgb (B, H, W, 3) u8 and, with DepthNormal, depth_mm
    (B, H, W) in mm -> (grad, norm), per pyramid level: grad[l] = (bitmask
    (B, H_l, W_l) u8, squared magnitude f32) of K1's trainer variant
    (level 0 on the u8 frame, each next level on the pyrDown of the last
    as integer-valued f32), norm[l] the DepthNormal bitmask, quantized
    once at level 0 by DN and subsampled [::2, ::2] per level (cv::linemod's
    DepthNormalPyramid::pyrDown)."""
    grad, norm = [], []
    cur = rgb
    qn = None
    if params.use_depth_normal:
        qn = CP.quantize_depth_normal(depth_mm, params.depth.distance_threshold,
                                      params.depth.difference_threshold)
    for l in range(params.pyramid_levels):
        if params.use_color_gradient:
            grad.append(CP.quantize_color_gradient_mag2(cur.contiguous(),
                                                        params.color.weak_threshold))
        if qn is not None:
            norm.append(qn)
        if l + 1 < params.pyramid_levels:
            if params.use_color_gradient:
                cur = torch.stack([F.pyr_down(cur[..., c]) for c in range(cur.shape[-1])], -1)
            if qn is not None:
                qn = qn[..., ::2, ::2]
    return grad, norm


def extract_template(
    rgb: np.ndarray,
    depth_mm: np.ndarray | None,
    mask: np.ndarray,
    params: DetectorParams,
    precomputed: dict | None = None,
    device=DEFAULT_DEVICE,
) -> TemplateFeatures | None:
    """Extract a multi-level template; None mimics addTemplate == -1 (too
    few features: the view is skipped).

    `precomputed`, when given, holds per-level host quantizations from a
    batched device pass, {"grad": [(quant, mag2), ...], "norm": [quant,
    ...]}, of the same window as `mask`, and `rgb` and `depth_mm` are not
    read; otherwise the quantizations are computed on `device` from `rgb`
    (H, W, 3) u8 and, with DepthNormal, `depth_mm` (H, W) in mm (None
    then gives None, as the reference's addTemplate fails)."""
    tracing.count("extract.views")
    levels = params.pyramid_levels
    if precomputed is None:
        if params.use_depth_normal and depth_mm is None:
            return None
        dev = resolve_device(device)

        def t(a, dtype):
            a = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
            return a.to(device=dev, dtype=dtype)[None]

        grad, norm = quantize_levels(
            t(rgb, torch.uint8), t(depth_mm, torch.float32) if params.use_depth_normal else None,
            params)
        precomputed = {"grad": [(q[0].cpu().numpy(), m[0].cpu().numpy()) for q, m in grad],
                       "norm": [n[0].cpu().numpy() for n in norm]}
    grad_l: list[np.ndarray] = []
    norm_l: list[np.ndarray] = []
    cur_mask = (mask > 0).astype(np.uint8)
    for l in range(levels):
        if params.use_color_gradient:
            with tracing.span("lpe.extract.grad"):
                g = extract_gradient_features(cur_mask, params.color,
                                              params.color.num_features,
                                              *precomputed["grad"][l])
            if g is None:
                return None
            grad_l.append(g)
        if params.use_depth_normal:
            with tracing.span("lpe.extract.norm"):
                n = extract_normal_features(cur_mask, params.depth,
                                            params.depth.num_features,
                                            precomputed["norm"][l])
            if n is None:
                return None
            norm_l.append(n)
        cur_mask = cur_mask[::2, ::2]

    # Crop to the common bbox in level-0 coords (cv::linemod cropTemplates).
    all_xy0: list[np.ndarray] = []
    for l in range(levels):
        for fl in ([grad_l[l]] if params.use_color_gradient else []) + (
            [norm_l[l]] if params.use_depth_normal else []
        ):
            all_xy0.append(fl[:, :2].astype(np.int64) << l)
    cat = np.concatenate(all_xy0, axis=0)
    y0, x0 = cat[:, 0].min(), cat[:, 1].min()
    y1, x1 = cat[:, 0].max(), cat[:, 1].max()
    sizes = []
    for l in range(levels):
        oy_, ox_ = int(y0) >> l, int(x0) >> l
        if params.use_color_gradient:
            grad_l[l] = grad_l[l] - np.array([oy_, ox_, 0], np.int32)
        if params.use_depth_normal:
            norm_l[l] = norm_l[l] - np.array([oy_, ox_, 0], np.int32)
        sizes.append((int(y1 - y0) >> l, int(x1 - x0) >> l))
    return TemplateFeatures(
        grad=grad_l if params.use_color_gradient else [],
        norm=norm_l if params.use_depth_normal else [],
        size=sizes,
        rect0=(int(x0), int(y0), int(x1 - x0 + 1), int(y1 - y0 + 1)),
    )


# ---------------------------------------------------------------------------
# Bank arrays
# ---------------------------------------------------------------------------


def stack_level_features(
    templates: list[TemplateFeatures], level: int, modality: str, f_cap: int
) -> LevelFeatures:
    """Pad one (level, modality)'s features across the bank into arrays."""
    N = len(templates)
    offsets = np.zeros((N, f_cap, 2), np.int32)
    oris = np.zeros((N, f_cap), np.int32)
    count = np.zeros((N,), np.int32)
    size = np.zeros((N, 2), np.int32)
    for i, t in enumerate(templates):
        fl = (t.grad if modality == "grad" else t.norm)[level]
        n = min(fl.shape[0], f_cap)
        offsets[i, :n] = fl[:n, :2]
        oris[i, :n] = fl[:n, 2]
        count[i] = n
        size[i] = t.size[level]
    live = np.arange(f_cap, dtype=np.int32)[None, :] < count[:, None]
    return LevelFeatures(
        offsets=torch.from_numpy(offsets),
        oris=torch.from_numpy(oris),
        live=torch.from_numpy(live),
        count=torch.from_numpy(count),
        size=torch.from_numpy(size),
    )


DEAD_SIZE = 10**6  # template size of a dead row: invalid at every position


def _append_dead(lf: LevelFeatures, n: int) -> LevelFeatures:
    z = lambda a: torch.cat([a, torch.zeros((n,) + a.shape[1:], dtype=a.dtype)])
    size = torch.cat([lf.size, torch.full((n, 2), DEAD_SIZE, dtype=lf.size.dtype)])
    return LevelFeatures(z(lf.offsets), z(lf.oris), z(lf.live), z(lf.count), size)


class TemplateBank:
    """A class's templates as padded arrays (CPU tensors)."""

    def __init__(
        self,
        class_id: str,
        params: DetectorParams,
        templates: list[TemplateFeatures],
        f_cap: int = 64,
        n_dead: int = 0,
        metadata: TemplateMetadata | None = None,
        globals_: RendererGlobals | None = None,
    ):
        """`n_dead` appends that many dead array rows after the templates:
        no features, count 0 and a size no frame fits, so they are never
        valid anywhere (padding of a tiled bank, see `tile`).  `metadata`
        and `globals_` are the pose records `write_params_yaml` writes."""
        self.class_id = class_id
        self.params = params
        self.templates = templates
        self.f_cap = f_cap
        self.n_dead = n_dead
        self.metadata = metadata
        self.globals = globals_ or RendererGlobals()
        self._merged: dict[int, LevelFeatures] = {}
        self._dense: dict[int, torch.Tensor] = {}
        self._build_arrays()

    def _build_arrays(self) -> None:
        p = self.params
        self.levels: list[dict[str, LevelFeatures]] = []
        for l in range(p.pyramid_levels):
            d: dict[str, LevelFeatures] = {}
            if p.use_color_gradient:
                d["grad"] = stack_level_features(self.templates, l, "grad", self.f_cap)
            if p.use_depth_normal:
                d["norm"] = stack_level_features(self.templates, l, "norm", self.f_cap)
            if self.n_dead:
                d = {m: _append_dead(lf, self.n_dead) for m, lf in d.items()}
            self.levels.append(d)
        # Total features per template per level (similarity normalization).
        self.total_features = [
            sum(lf.count for lf in self.levels[l].values())
            for l in range(p.pyramid_levels)
        ]

    @property
    def num_templates(self) -> int:
        """Array rows: the templates plus any dead padding rows."""
        return len(self.templates) + self.n_dead

    def tile(self, reps: int, pad_to: int) -> "TemplateBank":
        """A bank of this one's templates repeated `reps` times, padded with
        dead rows to `pad_to` rows (a realistic-scale bank built from a
        smaller one).  Extents are those of the real templates."""
        n = len(self.templates) * reps
        if pad_to < n:
            raise ValueError(f"pad_to={pad_to} < {n} tiled templates")
        return TemplateBank(self.class_id, self.params, self.templates * reps,
                            f_cap=self.f_cap, n_dead=pad_to - n)

    @property
    def num_modalities(self) -> int:
        return len(self.levels[0])

    def _max_size(self, level: int) -> int | None:
        n = len(self.templates)  # dead rows carry no extent
        sizes = torch.stack([lf.size[:n] for lf in self.levels[level].values()])
        return int(sizes.max()) if sizes.numel() else None

    def max_cell_extent(self, level: int) -> int:
        """Max template extent in T-cells at `level`: max_offset // T + 1
        (`size` stores the template's maximum feature offset)."""
        m = self._max_size(level)
        return 1 if m is None else m // self.params.t_pyramid[level] + 1

    def extent(self, level: int) -> int:
        """Max template pixel extent at `level`, rounded up to a multiple
        of 8."""
        m = self._max_size(level)
        e = m + 1 if m is not None else 8
        return max((e + 7) // 8 * 8, 8)

    def merged_features(self, level: int) -> LevelFeatures:
        """Modality-merged LevelFeatures for this level (cached)."""
        from ..ops.match import merge_modalities

        if level not in self._merged:
            fl = list(self.levels[level].values())
            dummy = [torch.zeros((8, 8, 8), dtype=torch.uint8)] * len(fl)
            self._merged[level], _ = merge_modalities(fl, dummy)
        return self._merged[level]

    def dense_weights(self, level: int) -> torch.Tensor:
        """The one-hot convolution filters (N, 8 * modalities, E, E) int8 of
        ``ops.match.coarse_scores_conv``, E = extent(level) (cached)."""
        from ..ops.match import build_dense_weights

        if level not in self._dense:
            self._dense[level] = build_dense_weights(
                self.merged_features(level), 8 * self.num_modalities, self.extent(level))
        return self._dense[level]

    # -- serialization ------------------------------------------------------

    def write_params_yaml(self, path: str) -> None:
        """renderer_params.yml, in the byte-level schema of the original
        renderer's writeLinemodTemplateParams: one `Template i` node per
        template ({ID, R, T, K, D, Ori_dist, Rect}), then the renderer's
        globals."""
        if self.metadata is None:
            raise ValueError("bank has no pose metadata")
        m, g = self.metadata, self.globals
        doc: dict = {}
        for i in range(len(self.templates)):
            doc[f"Template {i}"] = {
                "ID": i,
                "R": oy.CvMatrix(m.R[i].astype(np.float64)),
                "T": oy.CvMatrix(m.T[i].reshape(3, 1).astype(np.float64)),
                "K": oy.CvMatrix(m.K[i].astype(np.float32)),
                "D": float(m.D[i]),
                "Ori_dist": float(m.Ori_dist[i]),
                "Rect": [int(v) for v in m.Rect[i]],
            }
        for name in _GLOBAL_FIELDS:
            doc[f"renderer_{name}"] = getattr(g, name)
        oy.dump(doc, path)

    @staticmethod
    def write_render_dump(
        path: str,
        depths_mm: list[np.ndarray],
        masks: list[np.ndarray],
        rects: list[tuple[int, int, int, int]],
    ) -> None:
        """The original renderer's writeLinemodRender: per template its
        rendered depth (u16 mm), mask (u8) and Rect, as `Template i ->
        {ID, Depth, Mask, Rect}` FileStorage nodes."""
        doc: dict = {}
        for i, (d, m, rc) in enumerate(zip(depths_mm, masks, rects)):
            doc[f"Template {i}"] = {
                "ID": i,
                "Depth": oy.CvMatrix(np.asarray(d, np.uint16)),
                "Mask": oy.CvMatrix(np.asarray(m, np.uint8)),
                "Rect": [int(v) for v in rc],
            }
        oy.dump(doc, path)

    @staticmethod
    def read_render_dump(path: str) -> list:
        """A render dump back: a list of (depth_mm u16, mask u8, rect)."""
        doc = oy.load(path)
        out = []
        i = 0
        while f"Template {i}" in doc:
            t = doc[f"Template {i}"]
            out.append((
                np.asarray(t["Depth"], np.uint16),
                np.asarray(t["Mask"], np.uint8),
                tuple(int(v) for v in t["Rect"]),
            ))
            i += 1
        return out

    @staticmethod
    def read_params_yaml(path: str) -> tuple[TemplateMetadata, RendererGlobals]:
        """Parse a renderer_params.yml (or .yml.gz): through the native
        loader when the toolchain built it, through PyYAML otherwise; both
        give the same arrays."""
        from ..utils import native

        path = _maybe_ungz(path)
        nat = native.load_params_native(path) if native.available() else None
        if nat is not None:
            R, T, K, D, Od, Rect, g = nat
            return (
                TemplateMetadata(R=R, T=T, K=K, D=D, Ori_dist=Od, Rect=Rect),
                RendererGlobals(**{
                    name: kind(v) for (name, kind), v in zip(_GLOBAL_FIELDS.items(), g)}),
            )
        return _params_from_doc(oy.load(path))

    def _modality_names(self) -> list[str]:
        p = self.params
        return (["ColorGradient"] if p.use_color_gradient else []) + (
            ["DepthNormal"] if p.use_depth_normal else []
        )

    def write_templates_yaml(self, path: str) -> None:
        """Detector + templates YAML in cv::linemod's OWN serialization
        schema (Detector::write, writeClass, Template::write,
        Feature::write), so banks written here load in OpenCV and vice
        versa:

        - template entries carry NO modality name; a TemplatePyramid is the
          flat list tp[level * num_modalities + modality_index],
        - feature rows are ``[x, y, label]`` (the rows held here are
          (y, x, ori): swapped at this boundary),
        - the class node lists its modality names.
        """
        p = self.params
        mods = []
        if p.use_color_gradient:
            mods.append({
                "type": "ColorGradient",
                "weak_threshold": p.color.weak_threshold,
                "num_features": p.color.num_features,
                "strong_threshold": p.color.strong_threshold,
            })
        if p.use_depth_normal:
            mods.append({
                "type": "DepthNormal",
                "distance_threshold": p.depth.distance_threshold,
                "difference_threshold": p.depth.difference_threshold,
                "num_features": p.depth.num_features,
                "extract_threshold": p.depth.extract_threshold,
            })
        pyramids = []
        for i, t in enumerate(self.templates):
            entries = []
            for l in range(p.pyramid_levels):
                mods_l = ([t.grad[l]] if p.use_color_gradient else []) + (
                    [t.norm[l]] if p.use_depth_normal else [])
                for fl in mods_l:
                    entries.append({
                        "width": int(t.size[l][1]),
                        "height": int(t.size[l][0]),
                        "pyramid_level": l,
                        "features": oy.BlockRows(
                            [int(f[1]), int(f[0]), int(f[2])] for f in fl),
                    })
            pyramids.append({"template_id": i, "templates": entries})
        doc = {
            "pyramid_levels": p.pyramid_levels,
            "modalities": mods,
            "T": list(p.t_pyramid),
            "classes": [{
                "class_id": self.class_id,
                "modalities": self._modality_names(),
                "pyramid_levels": p.pyramid_levels,
                "template_pyramids": pyramids,
            }],
        }
        oy.dump(doc, path)

    @staticmethod
    def read_templates_yaml(path: str, f_cap: int = 64) -> "TemplateBank":
        """Load a cv::linemod templates.yml (or .yml.gz): through the
        native loader when the toolchain built it, through PyYAML
        otherwise; both give the same bank."""
        from ..utils import native

        path = _maybe_ungz(path)
        nat = native.load_templates_native(path) if native.available() else None
        if nat is None:
            return _bank_from_doc(oy.load(path), f_cap)
        return _bank_from_native(nat, path, f_cap)


_GLOBAL_FIELDS = {  # renderer_<name> keys of a params file, in file order
    "n_points": int, "angle_step": int, "radius_min": float, "radius_max": float,
    "radius_step": float, "width": int, "height": int, "focal_length_x": float,
    "focal_length_y": float, "near": float, "far": float,
}


def _params_from_doc(doc: dict) -> tuple[TemplateMetadata, RendererGlobals]:
    """A parsed renderer_params.yml -> (TemplateMetadata, RendererGlobals)."""
    n = 0
    while f"Template {n}" in doc:
        n += 1
    R = np.zeros((n, 3, 3))
    T = np.zeros((n, 3))
    K = np.zeros((n, 3, 3), np.float32)
    D = np.zeros((n,))
    Od = np.zeros((n,))
    Rect = np.zeros((n, 4), np.int32)
    for i in range(n):
        t = doc[f"Template {i}"]
        R[i] = t["R"]
        T[i] = np.asarray(t["T"]).ravel()
        K[i] = t["K"]
        D[i] = t["D"]
        Od[i] = t["Ori_dist"]
        Rect[i] = t["Rect"]
    default = RendererGlobals()
    g = RendererGlobals(**{
        name: kind(doc.get(f"renderer_{name}", getattr(default, name)))
        for name, kind in _GLOBAL_FIELDS.items()})
    return TemplateMetadata(R=R, T=T, K=K, D=D, Ori_dist=Od, Rect=Rect), g


def _bank_from_native(nat, path: str, f_cap: int) -> TemplateBank:
    """The native loader's blobs (of the plain-YAML file at `path`) -> a
    TemplateBank."""
    import re

    entries, features, header, mparams = nat
    # header[1] is a modality bitmask: bit0 ColorGradient, bit1 DepthNormal.
    levels, mod_mask, T0, T1 = (int(v) for v in header)
    cp = ModalityParams(
        weak_threshold=float(mparams[0, 0]) or 10.0,
        num_features=int(mparams[0, 1]) or 63,
        strong_threshold=float(mparams[0, 2]) or 55.0,
    )
    dp = ModalityParams(
        distance_threshold=float(mparams[1, 0]) or 2000.0,
        difference_threshold=float(mparams[1, 1]) or 50.0,
        num_features=int(mparams[1, 2]) or 63,
        extract_threshold=int(mparams[1, 3]) or 2,
    )
    params = DetectorParams(
        t_pyramid=(T0, T1),
        use_color_gradient=bool(mod_mask & 1),
        use_depth_normal=bool(mod_mask & 2),
        color=cp,
        depth=dp,
    )
    templates: list[TemplateFeatures] = []
    fo = 0
    cur_pid = -1
    for e in entries:
        pid, w, h, level, mod, nf = (int(v) for v in e)
        if pid != cur_pid:
            templates.append(
                TemplateFeatures(
                    grad=[None] * levels, norm=[None] * levels,  # type: ignore
                    size=[(0, 0)] * levels, rect0=(0, 0, 0, 0),
                )
            )
            cur_pid = pid
        t = templates[-1]
        # Blob rows are raw file order [x, y, label] -> (y, x, ori).
        fl = features[fo:fo + nf][:, [1, 0, 2]].copy()
        fo += nf
        t.size[level] = (h, w)
        if mod == 0:
            t.grad[level] = fl
        else:
            t.norm[level] = fl
    for t in templates:
        t.grad = [g for g in t.grad if g is not None]
        t.norm = [n for n in t.norm if n is not None]
        if t.size[0] != (0, 0):
            t.rect0 = (0, 0, t.size[0][1], t.size[0][0])
    # class_id lives in a small header region; grab it cheaply.
    with open(path, "rt") as f:
        head = f.read(65536)
    m = re.search(r"class_id:\s*(\S+)", head)
    class_id = m.group(1) if m else "obj"
    return TemplateBank(class_id, params, templates, f_cap=f_cap)


def _bank_from_doc(doc: dict, f_cap: int) -> TemplateBank:
    """A parsed cv::linemod templates.yml -> a TemplateBank."""
    mods = {m["type"]: m for m in doc["modalities"]}
    cp = ModalityParams()
    dp = ModalityParams()
    if "ColorGradient" in mods:
        m = mods["ColorGradient"]
        cp.weak_threshold = float(m["weak_threshold"])
        cp.num_features = int(m["num_features"])
        cp.strong_threshold = float(m["strong_threshold"])
    if "DepthNormal" in mods:
        m = mods["DepthNormal"]
        dp.distance_threshold = float(m["distance_threshold"])
        dp.difference_threshold = float(m["difference_threshold"])
        dp.num_features = int(m["num_features"])
        dp.extract_threshold = int(m["extract_threshold"])
    params = DetectorParams(
        t_pyramid=tuple(doc["T"]),
        use_color_gradient="ColorGradient" in mods,
        use_depth_normal="DepthNormal" in mods,
        color=cp,
        depth=dp,
    )
    cls = doc["classes"][0]
    mod_names = list(cls.get("modalities", [m["type"] for m in doc["modalities"]]))
    n_mod = max(len(mod_names), 1)
    templates: list[TemplateFeatures] = []
    for pyr in cls["template_pyramids"]:
        grad: list[np.ndarray] = [None] * params.pyramid_levels  # type: ignore
        norm: list[np.ndarray] = [None] * params.pyramid_levels  # type: ignore
        size = [(0, 0)] * params.pyramid_levels
        for j, e in enumerate(pyr["templates"]):
            l = int(e["pyramid_level"])
            # File rows are [x, y, label]; the rows held here are (y, x, ori).
            fl = np.array(e["features"], np.int32).reshape(-1, 3)[:, [1, 0, 2]]
            size[l] = (int(e["height"]), int(e["width"]))
            # Entries carry no modality name: the pyramid is the flat list
            # tp[level * num_modalities + modality_index].
            if mod_names[j % n_mod] == "ColorGradient":
                grad[l] = fl
            else:
                norm[l] = fl
        templates.append(
            TemplateFeatures(
                grad=[g for g in grad if g is not None] if params.use_color_gradient else [],
                norm=[n for n in norm if n is not None] if params.use_depth_normal else [],
                size=size,
                rect0=(0, 0, size[0][1], size[0][0]),
            )
        )
    return TemplateBank(cls["class_id"], params, templates, f_cap=f_cap)
