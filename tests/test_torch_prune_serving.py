"""PyTorch port vs the JAX reference: BatchedMatcher(prune=True) in its
`positions` (the default) and `two_axis` modes, MultiClassBatchedMatcher
in its default `positions` mode, and match_batch_list, on CPU where the
port takes the kernels' plain versions.

A 64-template subset of the committed RGB-D bank over 240x320 crops of
the committed scenes; the caps are set so that every branch runs (no
overflow, fine overflow, coarse overflow).

Tolerance: exact equality of every output — Matches slots (sub-threshold
filler included, similarities as f32 bits), `last_prune` and `last_fine`
field for field.  The valid matches of every mode also equal the port's
own `prune=False` and `pooled` results as sets.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from linemod_pose_estimation_tpu.models.detector import Detector as JDetector
from linemod_pose_estimation_tpu.models.serving import BatchedMatcher as JMatcher
from linemod_pose_estimation_tpu.models.serving import MultiClassBatchedMatcher as JMulti
from linemod_pose_estimation_tpu.models.templates import TemplateBank as JBank
from linemod_pose_estimation_tpu_torch import convert
from linemod_pose_estimation_tpu_torch.models.serving import (BatchedMatcher,
                                                              MultiClassBatchedMatcher)
from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank
from linemod_pose_estimation_tpu_torch.utils import scenes as S

BANK = "data/boxNew_rgbd_templates.yml.gz"
THR = 70.0
TOP_K = 64  # <= prune_pos_cap * N at cap 1 (N = 64): one shape per branch


def _eq(got, want, what=""):
    assert len(got) == len(want)
    for name, a, b in zip(want._fields, got, want):
        a, b = a.numpy(), np.asarray(b)
        if b.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}{name}")


def _valid_sets(m):
    return [{(int(t), int(x), int(y), float(s)) for t, x, y, s, ok in
             zip(m.template_id[b], m.x[b], m.y[b], m.similarity[b], m.valid[b]) if ok}
            for b in range(m.valid.shape[0])]


@pytest.fixture(scope="module")
def detectors():
    jd = JDetector.read(BANK)
    cid = jd.class_ids[0]
    jb = jd.bank(cid)
    jsub = JDetector(jb.params)
    jsub.attach_bank(JBank(cid, jb.params, [jb.templates[i] for i in S.CROP_BANK_SUBSET]))
    return jsub, convert.detector_from_reference(jsub.bank(cid), device="cpu"), cid


@pytest.fixture(scope="module")
def baseline(detectors):
    """The port's own exhaustive and pooled valid matches on the crops."""
    _, td, cid = detectors
    rgbs, deps = S.golden_crops()
    B = rgbs.shape[0]
    ex = BatchedMatcher(td, cid, THR, B, top_k=TOP_K, device="cpu").match_batch(rgbs, deps)
    po = BatchedMatcher(td, cid, THR, B, top_k=TOP_K, prune=True, prune_mode="pooled",
                        device="cpu").match_batch(rgbs, deps)
    sets = _valid_sets(ex)
    assert sets == _valid_sets(po) and all(0 < len(s) < TOP_K for s in sets)
    return sets


# keyword arguments -> (coarse overflow, fine overflow or None without a fine stage)
POSITIONS = {
    "defaults": ({}, False, False),
    "fine_overflow": (dict(fine_pos_cap=1), False, True),
    "coarse_overflow_cap_1": (dict(prune_pos_cap=1), True, False),
    "coarse_overflow_cap_2": (dict(prune_pos_cap=2), True, False),
    "no_fine_stage": (dict(fine_g=None), False, None),
    "no_fine_stage_overflow": (dict(fine_g=None, prune_pos_cap=2), True, None),
    "fine_g_not_dividing_T1": (dict(fine_g=3), False, None),
}


@pytest.mark.parametrize("case", list(POSITIONS))
def test_batched_matcher_positions(detectors, baseline, case):
    kw, coarse_of, fine_of = POSITIONS[case]
    jd, td, cid = detectors
    rgbs, deps = S.golden_crops()
    B = rgbs.shape[0]
    jm = JMatcher(jd, cid, THR, B, top_k=TOP_K, prune=True, **kw)
    want = jm.match_batch(jnp.asarray(rgbs), jnp.asarray(deps))
    tm = BatchedMatcher(td, cid, THR, B, top_k=TOP_K, prune=True, device="cpu", **kw)
    assert tm.prune_mode == "positions"
    got = tm.match_batch(rgbs, deps)
    _eq(got, want)
    _eq(tm.last_prune, jm.last_prune, "last_prune.")
    assert bool(tm.last_prune.overflow) == coarse_of
    if fine_of is None:
        assert tm.last_fine is None and jm.last_fine is None and tm.fine_g is None
    else:
        _eq(tm.last_fine, jm.last_fine, "last_fine.")
        assert bool(tm.last_fine.overflow) == fine_of
        assert tm.fine_pos_cap == jm.fine_pos_cap
    assert tm.last_pool is None
    assert _valid_sets(got) == baseline


def test_batched_matcher_positions_single_frame(detectors, baseline):
    jd, td, cid = detectors
    rgbs, deps = S.golden_crops()
    jm = JMatcher(jd, cid, THR, 1, top_k=TOP_K, prune=True, prune_pos_cap=8)
    want = jm.match_batch(jnp.asarray(rgbs[:1]), jnp.asarray(deps[:1]))
    tm = BatchedMatcher(td, cid, THR, 1, top_k=TOP_K, prune=True, prune_pos_cap=8,
                        device="cpu")
    got = tm.match_batch(rgbs[:1], deps[:1])
    _eq(got, want)
    _eq(tm.last_prune, jm.last_prune, "last_prune.")
    _eq(tm.last_fine, jm.last_fine, "last_fine.")
    assert _valid_sets(got) == baseline[:1]


# keyword arguments -> overflow flag
TWO_AXIS = {
    "defaults": ({}, False),
    "template_overflow": (dict(prune_cap=3), True),
    "position_overflow": (dict(prune_pos_cap=2), True),
}


@pytest.mark.parametrize("case", list(TWO_AXIS))
def test_batched_matcher_two_axis(detectors, baseline, case):
    kw, overflow = TWO_AXIS[case]
    jd, td, cid = detectors
    rgbs, deps = S.golden_crops()
    B = rgbs.shape[0]
    jm = JMatcher(jd, cid, THR, B, top_k=TOP_K, prune=True, prune_mode="two_axis", **kw)
    want = jm.match_batch(jnp.asarray(rgbs), jnp.asarray(deps))
    tm = BatchedMatcher(td, cid, THR, B, top_k=TOP_K, prune=True, prune_mode="two_axis",
                        device="cpu", **kw)
    got = tm.match_batch(rgbs, deps)
    _eq(got, want)
    _eq(tm.last_prune, jm.last_prune, "last_prune.")
    assert tm.prune_cap == jm.prune_cap == min(kw.get("prune_cap", 1024), 64)
    assert bool(tm.last_prune.overflow) == overflow
    if overflow:  # no fallback: a subset of the exact matches, and the flag
        assert all(g <= w for g, w in zip(_valid_sets(got), baseline))
    else:
        assert _valid_sets(got) == baseline


def test_match_batch_list(detectors):
    jd, td, cid = detectors
    rgbs, deps = S.golden_crops()
    tm = BatchedMatcher(td, cid, THR, 2, top_k=TOP_K, prune=True, device="cpu")
    whole = tm.match_batch(rgbs, deps)
    frames = tm.match_batch_list(rgbs, deps)
    want = JMatcher(jd, cid, THR, 2, top_k=TOP_K, prune=True).match_batch_list(
        jnp.asarray(rgbs), jnp.asarray(deps))
    assert len(frames) == len(want) == 2
    for b, (f, w) in enumerate(zip(frames, want)):
        _eq(f, w, f"frame {b} ")
        assert f.valid.shape == (TOP_K,)
        assert all(bool((a == c[b]).all()) for a, c in zip(f, whole))


def test_constructor_rules(detectors):
    jd, td, cid = detectors
    for kw in (dict(fine_pos_cap=0), dict(fine_pos_cap=-4)):
        for cls, det, extra in ((BatchedMatcher, td, dict(device="cpu")),
                                (JMatcher, jd, {})):
            with pytest.raises(ValueError, match="fine_pos_cap must be positive"):
                cls(det, cid, THR, 2, prune=True, **kw, **extra)
    with pytest.raises(ValueError, match="prune_mode"):
        BatchedMatcher(td, cid, THR, 2, prune=True, prune_mode="rows", device="cpu")
    m = BatchedMatcher(td, cid, THR, 2, prune=True, prune_pos_cap=9, dot_m_chunk=4096,
                       device="cpu")
    assert (m.fine_pos_cap, m.prune_cap) == (4, 64)
    assert BatchedMatcher(td, cid, THR, 2, prune=True, prune_pos_cap=1,
                          device="cpu").fine_pos_cap == 1


# ---------------------------------------------------------------------------
# MultiClassBatchedMatcher, default mode
# ---------------------------------------------------------------------------

CLASS_A = S.CROP_MATCHING[::2] + list(range(1, 2652, 211))
CLASS_B = S.CROP_MATCHING[1::2] + list(range(60, 2652, 173))
MC_THRS = [70.0, 72.0]


@pytest.fixture(scope="module")
def two_class_detectors():
    jb = JDetector.read(BANK)
    full = jb.bank(jb.class_ids[0])
    jd, td = JDetector(full.params), None
    for cid, ids in (("a", CLASS_A), ("b", CLASS_B)):
        sub = JBank(cid, full.params, [full.templates[i] for i in ids])
        jd.attach_bank(sub)
        if td is None:
            td = convert.detector_from_reference(sub, device="cpu")
        else:
            td.attach_bank(TemplateBank(cid, td.params,
                                        convert.templates_from_reference(sub.templates)))
    return jd, td


# caps of 2, not 1: the merged bank has 43 templates, and top_k <= cap * N
MULTI = {
    "defaults": ({}, False),
    "fine_overflow": (dict(fine_pos_cap=2), False),
    "coarse_overflow": (dict(prune_pos_cap=2, fine_pos_cap=2), True),
    "no_fine_stage": (dict(fine_g=None), False),
}


@pytest.mark.parametrize("case", list(MULTI))
def test_multiclass_matcher_positions(two_class_detectors, case):
    kw, overflow = MULTI[case]
    jd, td = two_class_detectors
    rgbs, deps = S.golden_crops()
    B = rgbs.shape[0]
    jm = JMulti(jd, ["a", "b"], MC_THRS, B, top_k=TOP_K, **kw)
    want = jm.match_batch(jnp.asarray(rgbs), jnp.asarray(deps))
    tm = MultiClassBatchedMatcher(td, ["a", "b"], MC_THRS, B, top_k=TOP_K, device="cpu",
                                  **kw)
    assert tm.prune_mode == "positions"
    got = tm.match_batch(rgbs, deps)
    assert list(got) == ["a", "b"]
    for cid in ("a", "b"):
        _eq(got[cid], want[cid], f"{cid}.")
    _eq(tm.last_prune, jm.last_prune, "last_prune.")
    assert bool(tm.last_prune.overflow) == overflow and tm.last_pool is None
    # the same valid matches as the pooled mode and as one matcher a class
    pooled = MultiClassBatchedMatcher(td, ["a", "b"], MC_THRS, B, top_k=TOP_K,
                                      prune_mode="pooled", device="cpu"
                                      ).match_batch(rgbs, deps)
    for cid, thr in zip(("a", "b"), MC_THRS):
        single = BatchedMatcher(td, cid, thr, B, top_k=TOP_K, prune=True, device="cpu",
                                **kw).match_batch(rgbs, deps)
        sets = _valid_sets(got[cid])
        assert sets == _valid_sets(pooled[cid]) == _valid_sets(single)
        assert sum(len(s) for s in sets) > 0


# ---------------------------------------------------------------------------
# The committed golden (tools/make_torch_prune_golden.py).
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_prune_golden_on_cpu():
    """Full width on the cascade golden frames and the untiled 2652-
    template bank at threshold 91: Matches, PrunePlan and FinePlan of the
    positions mode at its defaults and with the fine and the coarse
    overflow forced, of two_axis, and of the default-mode two-object
    matcher equal the JAX reference's."""
    from linemod_pose_estimation_tpu_torch.models.detector import Detector

    with np.load("tests/data/torch_prune_golden.npz") as z:
        gold = {k: z[k] for k in z.files}
    with np.load("tests/data/torch_cascade_golden.npz") as z:
        rgbs, deps = z["rgb"], z["depth_mm"]

    def same(record, prefix):
        for name, a in convert.record_to_numpy(record, prefix).items():
            np.testing.assert_array_equal(a, gold[name], err_msg=name)

    det = Detector.read(BANK, device="cpu")
    cid, B = det.class_ids[0], rgbs.shape[0]
    bank = det.bank(cid)
    thr, top_k = float(gold["threshold"]), int(gold["top_k"])
    settings = {"pos": {}, "fof": dict(fine_pos_cap=int(gold["fine_overflow_cap"])),
                "cof": dict(prune_pos_cap=int(gold["coarse_overflow_cap"])),
                "two": dict(prune_mode="two_axis")}
    for key, kw in settings.items():
        m = BatchedMatcher(det, cid, thr, B, top_k=top_k, prune=True, device="cpu", **kw)
        out = m.match_batch(rgbs, deps)
        same(out, f"{key}_m_")
        same(m.last_prune, f"{key}_pp_")
        if key != "two":
            same(m.last_fine, f"{key}_fp_")
        assert int(out.valid.sum()) == 13
    cid2 = cid + "_second"
    det.attach_bank(TemplateBank(cid2, bank.params, bank.templates, f_cap=bank.f_cap))
    mc = MultiClassBatchedMatcher(det, [cid, cid2],
                                  [float(t) for t in gold["two_object_thresholds"]], B,
                                  top_k=top_k, device="cpu")
    out = mc.match_batch(rgbs, deps)
    for i, c in enumerate((cid, cid2)):
        same(out[c], f"mc{i}_m_")
    same(mc.last_prune, "mc_pp_")
