"""The port's spans and counters (``utils/tracing.py``) on the CPU.

With no profiler running, a pooled batch step and a two-chunk training
enter no ``record_function`` while their counters count; under
``torch.profiler`` the exported trace holds each ``lpe.*`` span nested in
its parent; a batch forced into each pool overflow moves exactly its own
counter, in agreement with the step's PooledStats, beside the coarse
pool's fill, which rides on the coarse flag's one transfer (three flag
reads a step, as before); a batch of raw mono frames conditioned on the
device counts its frames under its own span; and the extraction's
candidate counter equals the rows that enter the scattered selection.

The batch steps run on 240x320 crops of the committed scenes with a
64-template subset of the committed RGB-D bank (its templates do not fit
160x120 frames), the conditioned steps on the same crops in mono, widened
to 376 columns, with the subset of the colour-only bank; the trainer
renders the cuboid stand-in at 160x120.
"""

import json

import numpy as np
import pytest
import torch

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from linemod_pose_estimation_tpu_torch.api.service import FrameConditioning
from linemod_pose_estimation_tpu_torch.models import templates as TT
from linemod_pose_estimation_tpu_torch.models import trainer as TTR
from linemod_pose_estimation_tpu_torch.models.detector import Detector
from linemod_pose_estimation_tpu_torch.models.serving import (BatchedMatcher,
                                                              MultiClassBatchedMatcher)
from linemod_pose_estimation_tpu_torch.models.templates import DetectorParams, TemplateBank
from linemod_pose_estimation_tpu_torch.utils import scenes as S
from linemod_pose_estimation_tpu_torch.utils import tracing
from linemod_pose_estimation_tpu_torch.utils.stl import save_binary_stl
from linemod_pose_estimation_tpu_torch.utils.viewsphere import ViewSphereParams

BANK = "data/boxNew_rgbd_templates.yml.gz"
RGB_BANK = "data/boxNew_full_templates.yml.gz"
THR = 70.0
VIEWS = 8  # the small sphere's views: two chunks of 4

# span -> the span it nests in
BATCH_PARENT = {
    "lpe.entry.h2d": "lpe.batch",
    "lpe.preprocess": "lpe.batch",
    "lpe.preprocess.depth_normal": "lpe.preprocess",
    "lpe.pool": "lpe.batch",
    "lpe.pool.coarse": "lpe.pool",
    "lpe.sync": "lpe.pool",
    "lpe.pool.fine": "lpe.pool",
    "lpe.pool.exact": "lpe.pool",
    "lpe.pool.select": "lpe.pool.exact",
    "lpe.pool.fallback": "lpe.pool",
    "lpe.pool.fallback.select": "lpe.pool.fallback",
    "lpe.walk": "lpe.batch",
}
TRAIN_PARENT = {
    "lpe.trainer.dispatch": "lpe.train",
    "lpe.trainer.wait": "lpe.train",
    "lpe.trainer.extract": "lpe.train",
    "lpe.extract.grad": "lpe.trainer.extract",
    "lpe.extract.norm": "lpe.trainer.extract",
}
# the merged matcher's own steps around its walk
MULTICLASS_PARENT = {"lpe.merge": "lpe.batch", "lpe.split": "lpe.batch"}
# raw camera frames conditioned on the device
CONDITION_PARENT = {"lpe.entry.condition": "lpe.batch"}
PARENT = {**BATCH_PARENT, **MULTICLASS_PARENT, **CONDITION_PARENT, **TRAIN_PARENT}
# the pool's tiers and flag reads, which follow one another
POOL_PARTS = ("lpe.pool.coarse", "lpe.sync", "lpe.pool.fine", "lpe.pool.exact",
              "lpe.pool.fallback")


@pytest.fixture(autouse=True)
def fresh_counters():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture(scope="module")
def sub_detector():
    det = Detector.read(BANK, device="cpu")
    cid = det.class_ids[0]
    bank = det.bank(cid)
    sub = Detector(bank.params, device="cpu")
    sub.attach_bank(TemplateBank(cid, bank.params,
                                 [bank.templates[i] for i in S.CROP_BANK_SUBSET]))
    return sub, cid


@pytest.fixture(scope="module")
def crops():
    return S.golden_crops()


@pytest.fixture(scope="module")
def rgb_sub_detector():
    det = Detector.read(RGB_BANK, device="cpu")
    cid = det.class_ids[0]
    bank = det.bank(cid)
    sub = Detector(bank.params, device="cpu")
    sub.attach_bank(TemplateBank(cid, bank.params,
                                 [bank.templates[i] for i in S.CROP_BANK_SUBSET]))
    return sub, cid


def wide_mono(crops) -> np.ndarray:
    """The crops in mono (BT.601 luma), 28 columns of zeros either side."""
    c = crops[0].astype(np.int32)
    m = (4899 * c[..., 0] + 9617 * c[..., 1] + 1868 * c[..., 2] + 8192) >> 14
    return np.pad(m.astype(np.uint8), ((0, 0), (0, 0), (28, 28)))


@pytest.fixture(scope="module")
def stl(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh") / "cuboid.stl")
    save_binary_stl(path, S.cuboid_mesh().triangles)
    return path


def pooled(sub_detector, crops, **kw):
    sub, cid = sub_detector
    return BatchedMatcher(sub, cid, THR, crops[0].shape[0], top_k=64, prune=True,
                          prune_mode="pooled", device="cpu", **kw)


def train_config():
    return TTR.TrainerConfig(
        view_sphere=ViewSphereParams(n_points=4, angle_step=180, radius_min=0.5,
                                     radius_max=0.5),
        width=160, height=120, focal_length_x=535.566011 / 4,
        focal_length_y=537.168115 / 4, render_batch=4,
        detector=DetectorParams(use_depth_normal=True))


def run_steps(kind, sub_detector, crops, stl, rgb_sub_detector=None):
    """One step of `kind`: a pooled batch, a pooled batch that falls back
    (select range of 1 row) and a two-class pooled batch, a pooled batch of
    conditioned raw mono frames, or a training of two chunks."""
    if kind == "conditioned":
        sub, cid = rgb_sub_detector
        BatchedMatcher(sub, cid, THR, crops[0].shape[0], top_k=64, prune=True,
                       prune_mode="pooled", device="cpu",
                       conditioning=FrameConditioning(28, 320, 240)).match_batch(
                           wide_mono(crops))
    elif kind == "match_batch":
        for kw in ({}, dict(sel_row_cap=1)):
            pooled(sub_detector, crops, **kw).match_batch(*crops)
    elif kind == "multiclass":
        sub, cid = sub_detector
        sub.attach_bank(TemplateBank("second", sub.params, sub.bank(cid).templates))
        MultiClassBatchedMatcher(sub, [cid, "second"], [THR, THR + 2], crops[0].shape[0],
                                 top_k=64, prune_mode="pooled",
                                 device="cpu").match_batch(*crops)
    else:
        TTR.train_from_stl(stl, train_config(), device="cpu")


def test_span_without_a_profiler_is_one_shared_no_op(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = tracing.span("lpe.a"), tracing.span("lpe.b")
    assert a is b
    sums = {"s": 0.0}
    with a, tracing.timed("lpe.c", sums, "s"):
        pass
    assert sums["s"] > 0.0


def test_counters_count_reset_and_launches():
    tracing.count("batch")
    tracing.count("batch", 2)
    tracing.count("launch.walk_scores")
    assert tracing.counters == {"batch": 3, "launch.walk_scores": 1}
    assert tracing.launches() == {k: int(k == "walk_scores") for k in tracing.KERNELS}
    tracing.reset()
    assert tracing.counters == {} and set(tracing.launches().values()) == {0}


@pytest.mark.parametrize("kind", ["match_batch", "conditioned", "train"])
def test_untraced_steps_enter_no_record_function(kind, sub_detector, crops, stl,
                                                 rgb_sub_detector, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    run_steps(kind, sub_detector, crops, stl, rgb_sub_detector)
    B = crops[0].shape[0]
    if kind != "train":
        # the coarse pool's default 64 slots a frame, a step; no device, no sync
        steps = 2 if kind == "match_batch" else 1
        assert tracing.counters.pop("pool.coarse_slots") == steps * 64 * B
        assert tracing.counters.pop("pool.coarse_total") > 0
        # the fine pool's default 32 slots a frame, a step whose fine stage ran
        assert tracing.counters.pop("pool.fine_slots") == steps * 32 * B
        assert tracing.counters.pop("pool.fine_total") > 0
    if kind == "match_batch":
        # two pooled steps, the second falling back
        assert tracing.counters == {"batch": 2, "pool.select_overflow": 1}
    elif kind == "conditioned":
        assert tracing.counters == {"batch": 1, "condition.frames": B}
    else:
        assert tracing.counters["extract.views"] == VIEWS
        assert tracing.counters["extract.candidates"] > 0


@pytest.mark.parametrize("kind", ["match_batch", "multiclass", "conditioned", "train"])
def test_traced_spans_nest_in_their_parents(kind, sub_detector, crops, stl, rgb_sub_detector,
                                            tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_steps(kind, sub_detector, crops, stl, rgb_sub_detector)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    assert all(n.startswith("lpe.") for n in spans)
    if kind == "train":
        assert set(spans) == set(TRAIN_PARENT) | {"lpe.train"}
        assert len(spans["lpe.trainer.wait"]) == 2
        # one span a level (2) a view, each modality
        assert len(spans["lpe.extract.grad"]) == len(spans["lpe.extract.norm"]) == 2 * VIEWS
    else:
        want = set(BATCH_PARENT) | {"lpe.batch"}
        if kind != "match_batch":
            want -= {"lpe.pool.fallback", "lpe.pool.fallback.select"}  # no fallback
        if kind == "multiclass":
            want |= set(MULTICLASS_PARENT)
        if kind == "conditioned":  # colour alone: no DepthNormal
            want = (want - {"lpe.preprocess.depth_normal"}) | set(CONDITION_PARENT)
        assert set(spans) == want
        steps = 2 if kind == "match_batch" else 1
        assert len(spans["lpe.batch"]) == len(spans["lpe.pool"]) == steps
        # three host transfers a step: the coarse flag with the pool's total,
        # the fine flag, the fallback flag
        assert len(spans["lpe.sync"]) == 3 * steps
        parts = sorted(iv for n in POOL_PARTS for iv in spans.get(n, []))
        assert all(a[1] <= b[0] for a, b in zip(parts, parts[1:]))  # no overlap
    for child, ivs in spans.items():
        if child in PARENT:
            outer = spans[PARENT[child]]
            for a, b in ivs:
                assert any(p0 <= a and b <= p1 for p0, p1 in outer), (child, a, b)


# pooled matcher keywords -> the counters one batch moves
OVERFLOWS = {
    "none": ({}, {}),
    "coarse": (dict(pool_coarse=1), {"pool.coarse_overflow": 1}),
    "fine": (dict(pool_fine=1), {"pool.fine_overflow": 1}),
    "select": (dict(sel_row_cap=1), {"pool.select_overflow": 1}),
}


@pytest.mark.parametrize("case", list(OVERFLOWS))
def test_each_overflow_moves_its_own_counter(case, sub_detector, crops):
    kw, moved = OVERFLOWS[case]
    m = pooled(sub_detector, crops, **kw)
    m.match_batch(*crops)
    st = m.last_pool
    fine = {} if case == "coarse" else {"pool.fine_total": int(st.fine_total),
                                        "pool.fine_slots": min(m.pool_fine, m.pool_coarse)}
    assert tracing.counters == {"batch": 1, "pool.coarse_total": int(st.coarse_total),
                                "pool.coarse_slots": m.pool_coarse, **fine, **moved}
    c = lambda name: tracing.counters.get(name, 0)
    assert c("pool.coarse_overflow") == int(st.coarse_overflow)
    assert c("pool.fine_overflow") == int(st.fine_overflow)
    assert c("pool.select_overflow") == int(bool(st.fallback) and not bool(st.coarse_overflow))
    assert bool(st.fallback) == (case in ("coarse", "select"))


def test_extract_candidates_counts_the_selections_rows(stl, monkeypatch):
    seen = []
    select = TT._select_scattered

    def spy(candidates, scores, num):
        seen.append(candidates.shape[0])
        return select(candidates, scores, num)

    monkeypatch.setattr(TT, "_select_scattered", spy)
    st = {}
    _, bank = TTR.train_from_stl(stl, train_config(), device="cpu", stats=st)
    # two modalities at two levels a view, each one selection
    assert len(seen) == 4 * VIEWS and bank.num_templates == VIEWS
    assert tracing.counters["extract.candidates"] == sum(seen)
    assert tracing.counters["extract.views"] == VIEWS
    assert set(st) >= {"dispatch_s", "wait_s", "extract_s", "wall_s"}
    assert st["wall_s"] >= st["dispatch_s"] + st["wait_s"] + st["extract_s"]
