"""The merged two-object matcher, MultiClassBatchedMatcher(prune_mode="pooled"),
against the benchmark's plain multi-class reference
(benchmark/reference/multiclass.py: each class's bank matched alone at its
own threshold), per class and frame as multisets of valid matches, at the
two-object service's thresholds (92, 94).

Two classes of different templates (seeded draws from the committed RGB-D
bank, each holding some of the planted templates, of different sizes so
that ids re-base), the same slice under two ids (every candidate ties
across the classes), and a coarse pool of one slot (the exhaustive
fallback).  The frames are the committed cascade frames (templates 0,
1400 and 2000 planted) with seeded noise of sigma 16 on their colour:
the planted templates match at 97-98, and templates 1383 and 1983 at
92.86 and 92.26, between the two thresholds, so the second class's own
gate shows.  Also: the
matcher's counters, its spans off with no profiler, and its per-class
masks and gates built once, not per batch.
"""

import numpy as np
import pytest
import torch

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from benchmark.reference import bank as RB
from benchmark.reference import matcher as RM
from benchmark.reference.multiclass import MultiClassReference
from linemod_pose_estimation_tpu_torch.models.detector import Detector
from linemod_pose_estimation_tpu_torch.models.serving import MultiClassBatchedMatcher
from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank
from linemod_pose_estimation_tpu_torch.ops import match as M
from linemod_pose_estimation_tpu_torch.utils import tracing

BANK = "data/boxNew_rgbd_templates.yml.gz"
GOLDEN = "tests/data/torch_cascade_golden.npz"
THRS = [92.0, 94.0]
TOP_K = 128
B = 3  # the three planted cascade frames


def _draw(planted, n, seed):
    rest = np.random.default_rng(seed).choice(2652, size=n, replace=False)
    return sorted(set(planted) | set(rest.tolist()))


# case -> the bank template ids of each class
CLASSES = {
    "different": (_draw([0, 1383, 1400], 22, 1), _draw([1383, 1400, 1983, 2000], 30, 2)),
    "identical": (_draw([0, 1383, 1400, 1983, 2000], 21, 3),) * 2,
}


@pytest.fixture(autouse=True)
def fresh_counters():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture(scope="module")
def banks():
    det = Detector.read(BANK, device="cpu")
    return det.bank(det.class_ids[0]), RB.read_templates(BANK)


@pytest.fixture(scope="module")
def frames():
    with np.load(GOLDEN) as g:
        rgb, dep = g["rgb"][:B], g["depth_mm"][:B]
    noisy = rgb + np.random.default_rng(0).normal(0.0, 16.0, rgb.shape)
    return np.clip(np.rint(noisy), 0, 255).astype(np.uint8), dep


def _sub_ref(full: RB.Bank, ids) -> RB.Bank:
    return RB.Bank(full.class_id, full.T, full.modalities,
                   [[lv[i] for i in ids] for lv in full.levels],
                   [s[ids] for s in full.sizes], full.weak_threshold,
                   full.distance_threshold, full.difference_threshold)


def _matcher(banks, case, **kw):
    bank, _ = banks
    det = Detector(bank.params, device="cpu")
    for cid, ids in zip(("a", "b"), CLASSES[case]):
        det.attach_bank(TemplateBank(cid, bank.params, [bank.templates[i] for i in ids]))
    pools = dict(pool_coarse=56 * B, pool_fine=36 * B)
    pools.update(kw)
    return MultiClassBatchedMatcher(det, ["a", "b"], THRS, B, top_k=TOP_K, fine_g=4,
                                    prune_mode="pooled", sel_row_cap=128, device="cpu",
                                    **pools)


def _reference(banks, case, frames):
    _, full = banks
    subs = {}
    refs = [subs.setdefault(tuple(ids), _sub_ref(full, list(ids))) for ids in CLASSES[case]]
    return MultiClassReference(refs, THRS, TOP_K, device="cpu").match(*frames)


@pytest.mark.parametrize("case,pool_coarse", [("different", None), ("identical", None),
                                              ("different", 1)],
                         ids=["different", "identical", "coarse_overflow"])
def test_merged_matcher_equals_the_reference_per_class(banks, frames, case, pool_coarse):
    kw = {} if pool_coarse is None else dict(pool_coarse=pool_coarse)
    m = _matcher(banks, case, **kw)
    got = m.match_batch(*frames)
    assert bool(m.last_pool.fallback) == (pool_coarse is not None)
    assert tracing.counters.get("pool.coarse_overflow", 0) == int(pool_coarse is not None)
    want = _reference(banks, case, frames)
    sets = {}
    for c, cid in enumerate(("a", "b")):
        host = {k: getattr(got[cid], k).numpy() for k in M.Matches._fields}
        sets[cid] = [RM.valid_set({k: v[b] for k, v in host.items()}) for b in range(B)]
        assert sets[cid] == [RM.valid_set(w[c]) for w in want], (case, cid)
        assert sum(map(len, sets[cid])) > 0, f"class {cid} matched nothing: an empty comparison"
    if case == "identical":  # one bank at two thresholds: the second's matches are the first's at 94
        gated = [[r for r in a if np.int32(r[3]).view(np.float32) >= THRS[1]] for a in sets["a"]]
        assert sets["b"] == gated
        assert sum(map(len, sets["b"])) < sum(map(len, sets["a"]))


def test_counters_count_and_spans_stay_off(banks, frames, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    m = _matcher(banks, "different")
    for _ in range(2):
        m.match_batch(*frames)
    assert tracing.counters["multiclass.batch"] == 2
    assert tracing.counters["multiclass.classes"] == 4  # two classes a step
    assert tracing.counters["batch"] == 2
    assert "sync" not in tracing.counters  # host tensors: nothing waits for a card


def test_class_masks_and_gates_are_built_once(banks, frames, monkeypatch):
    built = []
    columns = M._class_columns

    def spy(*a):
        built.append(1)
        return columns(*a)

    monkeypatch.setattr(M, "_class_columns", spy)
    m = _matcher(banks, "different")
    first = m.match_batch(*frames)
    second = m.match_batch(*frames)
    assert len(built) == 1 and len(m._columns) == 1
    assert m._gates.dtype == torch.float32 and m._gates.tolist() == THRS
    for cid in ("a", "b"):
        for x, y in zip(first[cid], second[cid]):
            assert torch.equal(x, y)
