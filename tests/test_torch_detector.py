"""PyTorch port vs the JAX reference: the single-frame match engine —
``ops/match.py::preprocess_frame`` (K1 and K2 at B=1; the B=1 K2 is the
port of the reference's single-frame kernel K2b), ``select_candidates``,
``refine_candidates_opencv`` (K3 at B=1) and ``Detector.match_raw`` /
``match`` — on CPU, where the port takes the kernels' plain versions.

Tolerance: exact equality of every output (response maps, candidate ids,
cells and order including sub-threshold filler slots, f32 similarities,
Matches).  The frames are crops of the committed cascade golden frames
(the cuboid rendered at bank poses over a 1500 mm background).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from linemod_pose_estimation_tpu.models.detector import Detector as JDetector
from linemod_pose_estimation_tpu.models.templates import TemplateBank as JBank
from linemod_pose_estimation_tpu.ops import match as JM
from linemod_pose_estimation_tpu.ops import pallas_kernels as PK
from linemod_pose_estimation_tpu_torch import convert
from linemod_pose_estimation_tpu_torch.ops import cuda_kernels as CK
from linemod_pose_estimation_tpu_torch.ops import features as TF
from linemod_pose_estimation_tpu_torch.ops import match as TM

BANK = "data/boxNew_rgbd_templates.yml.gz"
GOLDEN = "tests/data/torch_cascade_golden.npz"
t = lambda a: torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def frames():
    """(rgb, depth) 240x320 crops around the object of golden frames 0
    and 2, and of the background-only frame."""
    with np.load(GOLDEN) as z:
        rgb, dep = z["rgb"], z["depth_mm"]
    out = []
    for f, (y, x) in ((0, (130, 180)), (2, (100, 160)), (3, (0, 0))):
        out.append((rgb[f, y:y + 240, x:x + 320].copy(), dep[f, y:y + 240, x:x + 320].copy()))
    return out


@pytest.mark.parametrize("frame,use_depth", [(0, True), (1, False)])
def test_preprocess_frame(frames, frame, use_depth):
    rgb, dep = frames[frame]
    want = JM.preprocess_frame(jnp.asarray(rgb), jnp.asarray(dep), use_depth=use_depth)
    got = TM.preprocess_frame(t(rgb), t(dep), use_depth=use_depth)
    for name, a, b in zip(want._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert int(got.grad_r0.amax()) == 4  # the object's edges respond


@pytest.mark.parametrize("T", [5, 8])
def test_single_frame_spread_response_vs_tpu_kernel(frames, T):
    """The B=1 K2 call's plain version against the reference's
    single-frame kernel K2b itself, run in interpret mode."""
    rgb, dep = frames[0]
    quant = TF.quantize_depth_normal(t(dep)[None])[0] if T == 8 else \
        TF.quantize_color_gradient(t(rgb)[None], 10.0)[0][0]
    want = PK.spread_response(jnp.asarray(quant.numpy()), T, interpret=True)
    got = CK.spread_response(quant[None].contiguous(), T)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(3))
def test_select_candidates_template_major_ties(seed):
    """Many equal scores: the reference flattens (N, Hc, Wc) template-
    major, so among ties the lower template id comes first.  A position-
    major flatten would order them differently."""
    rng = np.random.default_rng(seed)
    N, Hc, Wc = 40, 6, 9
    tf = np.full(N, 32, np.int32)
    raw = rng.integers(0, 100, (N, Hc, Wc)).astype(np.int32)
    raw[:20] = 120  # 1080 entries tied at similarity 93.75
    vpos = rng.random((N, Hc, Wc)) < 0.9
    want = JM.select_candidates(jnp.asarray(raw), jnp.asarray(tf), jnp.asarray(vpos), 70.0, 64)
    got = TM.select_candidates(t(raw), t(tf), t(vpos), 70.0, 64)
    for name, a, b in zip(want._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    # ties exist, and position-major selection would reorder them
    flat = TM.select_candidates_flat(t(raw).reshape(N, -1).t()[None], t(tf),
                                     t(vpos).reshape(N, -1).t(), 70.0, 64, Wc)
    assert not torch.equal(flat.template_id[0], got.template_id)


def _subset_banks(frames_idx_tids):
    jd = JDetector.read(BANK)
    cid = jd.class_ids[0]
    jb = jd.bank(cid)
    sub = sorted(set(frames_idx_tids) | set(range(0, 2652, 97)))
    jsub = JDetector(jb.params)
    jsub.attach_bank(JBank(cid, jb.params, [jb.templates[i] for i in sub]))
    return jsub, convert.detector_from_reference(jsub.bank(cid), device="cpu"), cid


@pytest.fixture(scope="module")
def detectors():
    with np.load(GOLDEN) as z:
        tids = z["m_template_id"][z["m_valid"]]
    return _subset_banks(tids.tolist())


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_match_raw_and_match(frames, detectors, frame):
    """Detector.match_raw on a bank subset (the golden frames' matching
    templates plus a stride sample): every Matches slot equal; on frame 0
    also the host view, Detector.match."""
    jd, td, cid = detectors
    rgb, dep = frames[frame]
    want = jd.match_raw(rgb, 80.0, depth_mm=dep, top_k=128)[cid]
    got = td.match_raw(rgb, 80.0, depth_mm=dep, top_k=128)[cid]
    for name, a, b in zip(want._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert (int(got.valid.sum()) > 0) == (frame < 2)
    if frame == 0:
        mj, mt = jd.match(rgb, 80.0, depth_mm=dep, top_k=128)[cid], \
            td.match(rgb, 80.0, depth_mm=dep, top_k=128)[cid]
        for name in ("x", "y", "template_id", "similarity"):
            np.testing.assert_array_equal(getattr(mt, name), np.asarray(getattr(mj, name)))


def test_refine_candidates_opencv(frames, detectors):
    """The single-frame walk on candidates from the reference's select,
    carried across, including invalid filler slots."""
    jd, td, cid = detectors
    rgb, dep = frames[0]
    jb = jd.bank(cid)
    pyr = JM.preprocess_frame(jnp.asarray(rgb), jnp.asarray(dep), use_depth=True)
    R0, R1 = JM.stack_modalities(pyr, True)
    f1, f0 = jb.merged_features(1), jb.merged_features(0)
    raw = JM.coarse_scores(R1, f1, 8, jb.max_cell_extent(1))
    vpos = JM.position_validity(f1.size, 8, *raw.shape[1:])
    cand = JM.select_candidates(raw, f1.count, vpos, 75.0, 64)
    want = JM.refine_candidates_opencv(R0, f0, cand, 8, 80.0, E0=jb.extent(0), fine_T=5)
    tb = td.bank(cid)
    got = TM.refine_candidates_opencv(
        t(np.asarray(R0)), tb.merged_features(0),
        convert.coarse_matches_from_numpy(*(np.asarray(a) for a in cand), device="cpu"), 8, 80.0,
        E0=tb.extent(0), fine_T=5)
    for name, a, b in zip(want._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
