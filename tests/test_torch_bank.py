"""PyTorch port vs the JAX reference: bank loading and bank arrays on the
real dual-modality bank (data/boxNew_rgbd_templates.yml.gz), on CPU.

Tolerance: exact equality (every bank array is integer or bool).
"""

import numpy as np
import pytest
import torch

from linemod_pose_estimation_tpu.models.detector import Detector as JDetector
from linemod_pose_estimation_tpu.models.templates import TemplateBank as JBank
from linemod_pose_estimation_tpu.ops import match as JM
from linemod_pose_estimation_tpu_torch import convert
from linemod_pose_estimation_tpu_torch.models.detector import Detector
from linemod_pose_estimation_tpu_torch.models.templates import DEAD_SIZE, TemplateBank
from linemod_pose_estimation_tpu_torch.ops import match as TM

BANK = "data/boxNew_rgbd_templates.yml.gz"
C, T1, G, GROUP = 16, 8, 4, 16


@pytest.fixture(scope="module")
def banks():
    jd = JDetector.read(BANK)
    td = Detector.read(BANK)
    cid = jd.class_ids[0]
    assert td.class_ids == [cid]
    return jd.bank(cid), td.bank(cid)


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_bank_params_and_extents(banks):
    jb, tb = banks
    assert tb.num_templates == jb.num_templates == 2652
    assert tb.params.t_pyramid == jb.params.t_pyramid == (5, 8)
    assert tb.params.use_depth_normal and tb.params.use_color_gradient
    for level in (0, 1):
        assert tb.max_cell_extent(level) == jb.max_cell_extent(level)
        assert tb.extent(level) == jb.extent(level)
    assert (tb.max_cell_extent(1), tb.extent(0)) == (12, 192)


@pytest.mark.parametrize("level", [0, 1])
def test_merged_features_equal(banks, level):
    """Modality merge + live-slot compaction: every field equal, and live
    is the prefix f < nf on every template."""
    jb, tb = banks
    port, ref = tb.merged_features(level), jb.merged_features(level)
    for a, b in zip(port, ref):
        _eq(a, b)
    F = port.oris.shape[1]
    assert F == 128
    assert torch.equal(port.live, torch.arange(F)[None, :] < port.count[:, None])


def _slice64(jb, tb):
    idx = list(range(0, 2652, 41))[:64]
    ref = JBank(jb.class_id, jb.params, [jb.templates[i] for i in idx])
    port = TemplateBank(tb.class_id, tb.params, [tb.templates[i] for i in idx])
    return ref.merged_features(1), port.merged_features(1), tb.max_cell_extent(1)


def test_weight_builders_equal(banks):
    """build_gemm/cell/cell_fine/group weights on a 64-template slice."""
    jb, tb = banks
    jf, tf, Kc = _slice64(jb, tb)
    _eq(TM.build_gemm_weights(tf, C, T1, Kc), JM.build_gemm_weights(jf, C, T1, Kc))
    Wc = TM.build_cell_weights(tf, C, T1, Kc)
    _eq(Wc, JM.build_cell_weights(jf, C, T1, Kc))
    _eq(TM.build_cell_weights_fine(tf, C, T1, Kc, G),
        JM.build_cell_weights_fine(jf, C, T1, Kc, G))
    wg, cnt = TM.build_group_bound(tf, C, T1, Kc, GROUP, W_cell=Wc)
    jwg, jcnt = JM.build_group_bound(jf, C, T1, Kc, GROUP)
    _eq(wg, jwg)
    _eq(cnt, jcnt)


def test_convert_carries_the_reference_bank(banks):
    """level_features_from_numpy / bank_from_numpy give exactly the arrays
    the port builds itself (padded GEMM operands included)."""
    jb, tb = banks
    jf, tf, Kc = _slice64(jb, tb)
    lf = convert.level_features_from_numpy(*(np.asarray(a) for a in jf))
    for a, b in zip(lf, tf):
        assert torch.equal(a, b)
    jwg, jcnt = JM.build_group_bound(jf, C, T1, Kc, GROUP)
    carried = convert.bank_from_numpy(
        JM.build_gemm_weights(jf, C, T1, Kc), JM.build_cell_weights(jf, C, T1, Kc),
        JM.build_cell_weights_fine(jf, C, T1, Kc, G), jwg, jcnt)
    built = TM.build_bank_weights(tf, C, T1, Kc, G, GROUP)
    assert [w.n for w in carried[:4]] == [64, 64, 64, 4]
    for a, b in zip(carried[:4], built[:4]):
        assert a.n == b.n and a.nk.shape[0] % 8 == 0
        assert torch.equal(a.nk, b.nk)
    assert torch.equal(carried.group_counts, built.group_counts)


def test_tiled_bank_matches_array_tiling(banks):
    """bank.tile(reps, pad_to): the templates' arrays repeated, then dead
    rows (no features, count 0, size DEAD_SIZE); extents unchanged."""
    _, tb = banks
    small = TemplateBank(tb.class_id, tb.params, tb.templates[:10])
    tiled = small.tile(3, 40)
    assert tiled.num_templates == 40
    assert tiled.max_cell_extent(1) == small.max_cell_extent(1)
    assert tiled.extent(0) == small.extent(0)
    for level in (0, 1):
        s, t = small.merged_features(level), tiled.merged_features(level)
        for a, b in zip(s, t):
            assert torch.equal(b[:30], torch.cat([a] * 3))
        assert not t.live[30:].any() and not t.count[30:].any()
        assert (t.size[30:] == DEAD_SIZE).all()
