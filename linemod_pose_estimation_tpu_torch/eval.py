"""Accuracy evaluation harness — the port of
``linemod_pose_estimation_tpu/eval.py``: render scenes at known poses, run
the matcher or the full pipeline, report pixel / degree / centimetre error
distributions.

- ground truth: re-render trained views, report the match's pixel error
  against the template's own level-0 bbox origin, the rotation geodesic
  (degrees) and translation (cm) of the recovered pose, and found rates;
- head to head against the genuine cv::linemod engine
  (``evaluate_vs_opencv``, ``evaluate_bank_ab``): the trained bank goes
  to the oracle (``utils/oracle.py``) through its YAML file, both engines
  match the same frames, and the score / position deltas and hit
  agreement are reported.

Renderers, detectors and pipelines are the port's, on their own device;
frames cross to the host as numpy.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass

import numpy as np
import torch


def _stats(v: list[float]) -> dict:
    if not v:
        return {"n": 0}
    a = np.asarray(v, np.float64)
    return {
        "n": int(a.size),
        "mean": float(a.mean()),
        "p50": float(np.percentile(a, 50)),
        "p90": float(np.percentile(a, 90)),
        "max": float(a.max()),
    }


@dataclass
class EvalCase:
    view_id: int
    found: bool
    px_err: float | None = None  # best-scoring match (argmax pick)
    px_err_tie: float | None = None  # nearest among max-score ties: the
    #   orientation-spreading plateau admits several 100% positions, as in
    #   OpenCV; this measures whether the true one is among them
    deg_err: float | None = None
    cm_err: float | None = None
    score: float | None = None


def _host(out):
    """A render's (rgb, mask, depth_mm f32, rect) as numpy."""
    return (out.rgb.cpu().numpy(), out.mask.cpu().numpy(),
            out.depth_mm.cpu().numpy().astype(np.float32), out.rect.cpu().numpy())


def _scene_depth(depth_mm: np.ndarray, bg_mm: float = 1500.0) -> np.ndarray:
    """Rendered depth with the empty background pushed to a far plane (the
    bin-picking regime; zero-depth pixels would quantize DepthNormal as
    missing data everywhere)."""
    return np.where(depth_mm > 0, depth_mm, np.float32(bg_mm))


def evaluate_match_px(detector, renderer, meta, view_ids, threshold=85.0,
                      class_id: str | None = None,
                      use_depth: bool = False) -> list[EvalCase]:
    """Match-level positional accuracy: re-render each trained view, match,
    and measure the pixel error of the best match against the template's
    own level-0 bbox origin (what cv::linemod's Match.x/y carries).
    `use_depth=True` matches ColorGradient + DepthNormal."""
    cid = class_id or detector.class_ids[0]
    cases: list[EvalCase] = []
    for vid in view_ids:
        rgb, _, dep, _ = _host(renderer.render(meta.R[vid], meta.T[vid]))
        res = detector.match(rgb, threshold, depth_mm=_scene_depth(dep) if use_depth else None,
                             class_ids=[cid])[cid]
        if len(res) == 0:
            cases.append(EvalCase(view_id=vid, found=False))
            continue
        best = int(np.argmax(res.similarity))
        top = float(res.similarity[best])

        def _px(i: int) -> float:
            rx, ry = detector.template_rect0(cid, int(res.template_id[i]))[:2]
            return float(np.hypot(float(res.x[i]) - rx, float(res.y[i]) - ry))

        ties = [i for i in range(len(res)) if res.similarity[i] >= top - 1e-6]
        cases.append(EvalCase(view_id=vid, found=True, px_err=_px(best),
                              px_err_tie=min(_px(i) for i in ties), score=top))
    return cases


def evaluate_pose(pipeline, renderer, meta, view_ids, threshold=85.0,
                  use_depth: bool = False) -> list[EvalCase]:
    """Pipeline-level 6D accuracy: the full cascade on a rendered scene
    with its organized cloud; rotation geodesic (degrees) and translation
    error (cm) against the rendering pose.  `use_depth=True` feeds the
    frame's depth to the matcher."""
    from .utils import geometry as geo
    from .utils import pointcloud as pcu

    cases: list[EvalCase] = []
    for vid in view_ids:
        out = renderer.render(meta.R[vid], meta.T[vid])
        rgb, _, dep, _ = _host(out)
        cloud = pcu.depth_to_cloud(pcu.true_div(out.depth_mm, 1000.0), renderer.K)
        dets = pipeline.detect(rgb, cloud, threshold,
                               depth_mm=_scene_depth(dep) if use_depth else None)
        if not dets:
            cases.append(EvalCase(view_id=vid, found=False))
            continue
        d = dets[0]
        R_gt = meta.R[vid]
        t_gt = R_gt @ meta.T[vid]
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
        deg = float(geo.rotation_geodesic_deg(f32(R_gt), f32(d.pose[:3, :3])))
        cm = float(np.linalg.norm(d.pose[:3, 3] - t_gt)) * 100.0
        cases.append(EvalCase(view_id=vid, found=True, deg_err=deg, cm_err=cm, score=d.score))
    return cases


def _oracle_of(detector, cid: str):
    """The genuine engine holding `detector`'s bank of `cid` (through its
    YAML file)."""
    from .utils import oracle as ORC

    fd, path = tempfile.mkstemp(suffix=".yml")
    os.close(fd)
    try:
        detector.write(path, cid)
        return ORC.LinemodOracle.read(path)
    finally:
        os.unlink(path)


def evaluate_vs_opencv(detector, renderer, meta, view_ids, threshold=85.0,
                       class_id: str | None = None,
                       use_depth: bool = False) -> dict:
    """Head to head against the genuine cv::linemod engine on rendered
    objects: per view |score delta| and |position delta| distributions and
    the hit/miss agreement.  Needs the oracle (``utils.oracle``; frame
    sides divisible by 5 and 16, cv::linemod's pyramid constraint)."""
    from .utils import oracle as ORC

    if not ORC.available():
        return {"available": False}
    cid = class_id or detector.class_ids[0]
    orc = _oracle_of(detector, cid)
    score_d, px_d, agree, tmpl_mismatch = [], [], 0, 0
    for vid in view_ids:
        rgb, _, dep, _ = _host(renderer.render(meta.R[vid], meta.T[vid]))
        dep = _scene_depth(dep) if use_depth else None
        xyt, sim = orc.match(rgb, threshold, depth_mm=dep)
        ours = detector.match(rgb, threshold, depth_mm=dep, class_ids=[cid])[cid]
        if (len(sim) == 0) != (len(ours) == 0):
            continue  # disagreement on hit/miss, counted by `agree`
        agree += 1
        if len(sim) == 0:
            continue
        ob = int(np.argmax(sim))
        ub = int(np.argmax(ours.similarity))
        score_d.append(abs(float(sim[ob]) - float(ours.similarity[ub])))
        # Position deltas only on the SAME template: pair our best match
        # with the oracle's best match of that template id.
        same = np.flatnonzero(xyt[:, 2] == int(ours.template_id[ub]))
        if same.size:
            ob2 = int(same[np.argmax(sim[same])])
            px_d.append(float(np.hypot(float(xyt[ob2][0]) - float(ours.x[ub]),
                                       float(xyt[ob2][1]) - float(ours.y[ub]))))
        else:
            tmpl_mismatch += 1
    return {
        "available": True,
        "n": len(view_ids),
        "hit_miss_agreement": agree / max(len(view_ids), 1),
        "score_delta": _stats(score_d),
        "px_delta": _stats(px_d),
        "template_mismatches": tmpl_mismatch,
    }


def make_ab_scenes(renderer, meta, view_ids, W, H, rng,
                   n_shifted=40, n_cluttered=30, n_multi=20, n_occluded=15,
                   n_negative=15, with_depth: bool = False) -> list:
    """Scene corpus for the bank-level A/B: planted rendered views over
    low-texture backgrounds, in five categories — shifted (clean),
    cluttered (distractor boxes + texture patches), multi-instance (two
    plants), occluded (a bar across ~35% of the object), and object-free
    negatives.  Returns [(rgb, [(x, y) truths], category)], or with
    `with_depth` [(rgb, depth_mm, truths, category)]: the rendered object
    depth over a 1500 mm table plane, distractor boxes at their own depths,
    occluder bars in front of the object.  The same `rng` state gives the
    reference's scenes."""
    BG_MM = 1500.0
    views = {}
    for vid in view_ids:
        rgb, mask, dep, rect = _host(renderer.render(meta.R[vid], meta.T[vid]))
        mask = mask > 0
        x, y, w, h = (int(v) for v in rect)
        views[vid] = (rgb[y:y + h, x:x + w], mask[y:y + h, x:x + w], x, y,
                      dep[y:y + h, x:x + w])

    yy, xx = np.mgrid[0:H, 0:W]

    def background(clutter: bool):
        base = (40 + 60 * yy / H + 30 * np.sin(xx / 190.0)).astype(np.uint8)
        fr = np.stack(
            [base, (base * 0.92).astype(np.uint8),
             np.clip(base * 1.08, 0, 255).astype(np.uint8)], -1,
        )
        dp = np.full((H, W), BG_MM, np.float32)
        for _ in range(6 if clutter else 0):
            y0 = int(rng.integers(0, H - 90)); x0 = int(rng.integers(0, W - 130))
            fr[y0:y0 + 90, x0:x0 + 130] = rng.integers(50, 180, size=3)
            dp[y0:y0 + 90, x0:x0 + 130] = float(rng.uniform(1200, 1800))
        if clutter:  # high-frequency texture patches (strong random gradients)
            for _ in range(3):
                y0 = int(rng.integers(0, H - 64)); x0 = int(rng.integers(0, W - 64))
                fr[y0:y0 + 64, x0:x0 + 64] = rng.integers(0, 255, size=(64, 64, 3),
                                                          dtype=np.uint8)
        return fr, dp

    def plant(fr, dp, vid, occlude=False):
        sub_rgb, sub_mask, x, y, sub_dep = views[vid]
        h, w = sub_mask.shape
        dy = int(rng.integers(-y, H - (y + h)))
        dx = int(rng.integers(-x, W - (x + w)))
        m = sub_mask
        if occlude:
            m = sub_mask.copy()
            bar = max(1, int(0.35 * h))
            b0 = int(rng.integers(0, h - bar))
            m[b0:b0 + bar] = False
            fr[y + dy + b0:y + dy + b0 + bar, x + dx:x + dx + w] = rng.integers(40, 200, size=3)
            # The occluder sits IN FRONT of the object.
            dp[y + dy + b0:y + dy + b0 + bar, x + dx:x + dx + w] = float(rng.uniform(600, 900))
        fr[y + dy:y + dy + h, x + dx:x + dx + w][m] = sub_rgb[m]
        dp[y + dy:y + dy + h, x + dx:x + dx + w][m] = sub_dep[m]
        return (x + dx, y + dy)

    vlist = list(views.keys())
    pick = lambda: vlist[int(rng.integers(len(vlist)))]
    raw = []
    for _ in range(n_shifted):
        fr, dp = background(False)
        raw.append((fr, dp, [plant(fr, dp, pick())], "shifted"))
    for _ in range(n_cluttered):
        fr, dp = background(True)
        raw.append((fr, dp, [plant(fr, dp, pick())], "cluttered"))
    for _ in range(n_multi):
        fr, dp = background(True)
        raw.append((fr, dp, [plant(fr, dp, pick()) for _ in range(2)], "multi"))
    for _ in range(n_occluded):
        fr, dp = background(False)
        raw.append((fr, dp, [plant(fr, dp, pick(), occlude=True)], "occluded"))
    for _ in range(n_negative):
        fr, dp = background(True)
        raw.append((fr, dp, [], "negative"))
    if with_depth:
        return raw
    return [(fr, truths, cat) for fr, _, truths, cat in raw]


def evaluate_bank_ab(detector, scenes, threshold=92.0,
                     class_id: str | None = None, hit_radius: int = 8) -> dict:
    """Bank-level A/B against the genuine cv::linemod engine: both engines
    carry the same templates (the bank bridged through its YAML file) and
    match the same scenes.  Per scene, whether each engine finds each
    planted object (an above-threshold match within `hit_radius` px of the
    planted bbox origin) and, where both engines' best matches share a
    template, the score / position deltas.

    `scenes`: [(rgb, planted, category)] or, with depth fed to both
    engines, [(rgb, depth_mm, planted, category)] (make_ab_scenes), with
    planted = [(x, y)] truth bbox origins (empty for negatives)."""
    from .utils import oracle as ORC

    if not ORC.available():
        return {"available": False}
    cid = class_id or detector.class_ids[0]
    orc = _oracle_of(detector, cid)

    cats: dict[str, dict] = {}
    score_d, px_d, tmpl_mismatch = [], [], 0
    agree_scene = 0
    for sc in scenes:
        rgb, dep, planted, cat = sc if len(sc) == 4 else (sc[0], None, sc[1], sc[2])
        c = cats.setdefault(
            cat, {"scenes": 0, "objects": 0, "ours_hits": 0, "oracle_hits": 0,
                  "object_agreement": 0, "ours_fp": 0, "oracle_fp": 0},
        )
        c["scenes"] += 1
        xyt, sim = orc.match(rgb, threshold, depth_mm=dep)
        ours = detector.match(rgb, threshold, depth_mm=dep, class_ids=[cid])[cid]
        n_ours = len(ours)
        if (n_ours > 0) == (len(sim) > 0):
            agree_scene += 1
        if not planted:
            c["ours_fp"] += int(n_ours > 0)
            c["oracle_fp"] += int(len(sim) > 0)
            continue
        for (tx, ty) in planted:
            c["objects"] += 1
            o_hit = bool(len(sim) and np.any((np.abs(xyt[:, 0] - tx) <= hit_radius)
                                             & (np.abs(xyt[:, 1] - ty) <= hit_radius)))
            u_hit = bool(n_ours and np.any((np.abs(ours.x - tx) <= hit_radius)
                                           & (np.abs(ours.y - ty) <= hit_radius)))
            c["ours_hits"] += int(u_hit)
            c["oracle_hits"] += int(o_hit)
            c["object_agreement"] += int(u_hit == o_hit)
        if len(sim) and n_ours:
            ub = int(np.argmax(ours.similarity))
            same = np.flatnonzero(xyt[:, 2] == int(ours.template_id[ub]))
            score_d.append(abs(float(sim.max()) - float(ours.similarity[ub])))
            if same.size:
                ob = int(same[np.argmax(sim[same])])
                px_d.append(float(np.hypot(float(xyt[ob][0]) - float(ours.x[ub]),
                                           float(xyt[ob][1]) - float(ours.y[ub]))))
            else:
                tmpl_mismatch += 1

    n_scenes = sum(c["scenes"] for c in cats.values())
    n_obj = sum(c["objects"] for c in cats.values())
    return {
        "available": True,
        "n_scenes": n_scenes,
        "n_objects": n_obj,
        "scene_hit_miss_agreement": agree_scene / max(n_scenes, 1),
        "object_agreement": sum(c["object_agreement"] for c in cats.values()) / max(n_obj, 1),
        "score_delta": _stats(score_d),
        "px_delta": _stats(px_d),
        "template_mismatches": tmpl_mismatch,
        "by_category": cats,
    }


def summarize(match_cases: list[EvalCase], pose_cases: list[EvalCase]) -> dict:
    rate = lambda cs: sum(c.found for c in cs) / len(cs) if cs else 0.0
    vals = lambda cs, k: [getattr(c, k) for c in cs if getattr(c, k) is not None]
    return {
        "match": {
            "n": len(match_cases),
            "found_rate": rate(match_cases),
            "px_err": _stats(vals(match_cases, "px_err")),
            "px_err_tie": _stats(vals(match_cases, "px_err_tie")),
            "score": _stats(vals(match_cases, "score")),
        },
        "pose": {
            "n": len(pose_cases),
            "found_rate": rate(pose_cases),
            "deg_err": _stats(vals(pose_cases, "deg_err")),
            "cm_err": _stats(vals(pose_cases, "cm_err")),
        },
    }


def write_report(path: str, summary: dict) -> None:
    with open(path, "w") as f:
        json.dump(summary, f, indent=2)
