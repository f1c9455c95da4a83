"""PyTorch port vs the JAX reference: the exhaustive batched mode
(BatchedMatcher(prune=False), the reference class's default: one int8
GEMM over every position, a per-frame top-k, the walk), the K5 chain on
its candidates (refine_candidates_pallas_batched), the single-frame
position-major GEMM (coarse_scores_gemm_flat) and the serving fn
(Detector.make_matcher_fn), on CPU where the port takes the kernels'
plain versions.  The reference's approx_max_k select equals its exact
top_k on the CPU, so the port's exact top-k is held to both.

Tolerance: exact equality of every output, sub-threshold filler slots
included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from linemod_pose_estimation_tpu.models.detector import Detector as JDetector
from linemod_pose_estimation_tpu.models.serving import BatchedMatcher as JMatcher
from linemod_pose_estimation_tpu.models.templates import TemplateBank as JBank
from linemod_pose_estimation_tpu.ops import match as JM
from linemod_pose_estimation_tpu_torch import convert
from linemod_pose_estimation_tpu_torch.models.detector import Detector
from linemod_pose_estimation_tpu_torch.models.serving import BatchedMatcher
from linemod_pose_estimation_tpu_torch.ops import match as TM
from linemod_pose_estimation_tpu_torch.utils import scenes as S

BANK = "data/boxNew_rgbd_templates.yml.gz"
THR = 70.0



@pytest.fixture(scope="module")
def detectors():
    jd = JDetector.read(BANK)
    cid = jd.class_ids[0]
    jb = jd.bank(cid)
    jsub = JDetector(jb.params)
    jsub.attach_bank(JBank(cid, jb.params, [jb.templates[i] for i in S.CROP_BANK_SUBSET]))
    return jsub, convert.detector_from_reference(jsub.bank(cid), device="cpu"), cid


def _assert_equal(got, want):
    for name, a, b in zip(want._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_exhaustive_batched_matcher_and_k5_chain(detectors):
    """match_batch of the default mode, its candidates, and the K5 chain
    (the reference's profiling chain: exhaustive select, then
    refine_candidates_pallas_batched) on those candidates."""
    jd, td, cid = detectors
    rgbs, deps = S.golden_crops()
    B = rgbs.shape[0]
    jm = JMatcher(jd, cid, THR, B, top_k=64)
    want = jm.match_batch(jnp.asarray(rgbs), jnp.asarray(deps))
    tm = BatchedMatcher(td, cid, THR, B, top_k=64, device="cpu")
    R0, cands, n_valid = tm.candidates(rgbs, deps)
    assert n_valid is None and tm.last_pool is None
    got = tm.refine(R0, cands)
    _assert_equal(got, want)
    assert int(got.valid.sum()) > 0
    _assert_equal(tm.match_batch(rgbs, deps), want)

    # the reference's candidates, from its own stages
    jR0, jR1 = JM.preprocess_frames_batched(jnp.asarray(rgbs), jnp.asarray(deps),
                                            use_depth=True)
    raw = JM.coarse_scores_gemm_flat_batched(jR1, jm.W1, 8, jm.Kc1)
    Hc, Wc = jR1.shape[2] // 8, jR1.shape[3] // 8
    vpos = JM.position_validity_flat(jm.feats1.size, 8, Hc, Wc)
    jc = [JM.select_candidates_flat(raw[b], jm.feats1.count, vpos, THR - 5.0, 64, Wc)
          for b in range(B)]
    jcand = JM.CoarseMatches(*(jnp.stack(a) for a in zip(*jc)))
    _assert_equal(cands, jcand)
    np.testing.assert_array_equal(R0.numpy(), np.asarray(jR0))

    want5 = JM.refine_candidates_pallas_batched(jR0, jm.feats0, jcand, 8, THR, jm.E0,
                                                fine_T=5, interpret=True)
    got5 = TM.refine_candidates_pallas_batched(R0, tm.feats0, cands, 8, THR, tm.E0, fine_T=5)
    _assert_equal(got5, want5)
    assert int(got5.valid.sum()) > 0


def test_other_prune_modes_are_not_ported(detectors):
    """Every prune mode of the reference builds (tests/test_torch_prune_
    serving.py holds each to it); what is not a mode of the reference,
    and `pooled` without `prune`, raises."""
    _, td, cid = detectors
    for mode in ("positions", "two_axis"):
        m = BatchedMatcher(td, cid, THR, 2, prune=True, prune_mode=mode, device="cpu")
        assert m.prune_mode == mode and m.last_prune is None
    with pytest.raises(ValueError, match="prune_mode='rows'"):
        BatchedMatcher(td, cid, THR, 2, prune=True, prune_mode="rows", device="cpu")
    with pytest.raises(ValueError, match="requires prune=True"):
        BatchedMatcher(td, cid, THR, 2, prune_mode="pooled", device="cpu")


def test_coarse_scores_gemm_flat(detectors):
    jd, td, cid = detectors
    rgbs, deps = S.golden_crops((4,))
    jb, tb = jd.bank(cid), td.bank(cid)
    pyr = JM.preprocess_frame(jnp.asarray(rgbs[0]), jnp.asarray(deps[0]), use_depth=True)
    _, R1 = JM.stack_modalities(pyr, True)
    Kc = jb.max_cell_extent(1)
    want = JM.coarse_scores_gemm_flat(R1, jb.gemm_weights(1), 8, Kc)
    W = TM.MatmulWeight.from_kn(TM.build_gemm_weights(tb.merged_features(1), 16, 8, Kc))
    got = TM.coarse_scores_gemm_flat(torch.from_numpy(np.array(R1)), W, 8, Kc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.max()) > 0


@pytest.mark.parametrize("approx_select,with_depth", [(True, True), (False, False)])
def test_make_matcher_fn(detectors, approx_select, with_depth):
    jd, td, cid = detectors
    rgbs, deps = S.golden_crops((4,))
    dep = deps[0] if with_depth else None
    want = jd.make_matcher_fn(cid, THR, top_k=128, approx_select=approx_select)(
        rgbs[0], None if dep is None else jnp.asarray(dep))
    got = td.make_matcher_fn(cid, THR, top_k=128, approx_select=approx_select)(rgbs[0], dep)
    _assert_equal(got, want)
    assert int(got.valid.sum()) > 0 or not with_depth


# ---------------------------------------------------------------------------
# The committed golden (tools/make_torch_window_golden.py).
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_window_golden_on_cpu():
    """Full width on the cascade golden frames and the untiled 2652-
    template bank at threshold 91: the exhaustive match_batch, the K5
    chain on its candidates, and make_matcher_fn on frame 0 equal the
    JAX reference's."""
    with np.load("tests/data/torch_window_golden.npz") as z:
        gold = {k: z[k] for k in z.files}
    with np.load("tests/data/torch_cascade_golden.npz") as z:
        rgbs, deps = z["rgb"], z["depth_mm"]
    td = Detector.read(BANK, device="cpu")
    cid = td.class_ids[0]
    thr = float(gold["threshold"])
    m = BatchedMatcher(td, cid, thr, rgbs.shape[0], top_k=int(gold["top_k"]),
                       device="cpu")
    R0, cands, _ = m.candidates(rgbs, deps)
    got = {"x_": m.refine(R0, cands),
           "k5_": TM.refine_candidates_pallas_batched(R0, m.feats0, cands, m.T1, thr,
                                                      m.E0, fine_T=m.T0),
           "fn_": td.make_matcher_fn(cid, thr)(rgbs[0], deps[0])}
    for prefix, mm in got.items():
        for name, a in mm._asdict().items():
            np.testing.assert_array_equal(a.numpy(), gold[prefix + name],
                                          err_msg=prefix + name)
    assert int(got["k5_"].valid.sum()) > 0
