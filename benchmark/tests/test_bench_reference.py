"""The plain reference against the program's CPU path (the kernels' plain
versions): the matcher on 240x320 crops over a 64-template slice of the
bank, tiled and with the top-k full; one detect at full size; the trainer
at 160x120.  And the control: the reference in bfloat16 differs."""

import numpy as np
import pytest
import torch

from benchmark.reference import bank as RB
from benchmark.reference import matcher as RM

BANK = "benchmark/data/boxNew_rgbd_templates.yml.gz"
PARAMS = "benchmark/data/boxNew_rgbd_params.yml.gz"


@pytest.fixture(scope="module")
def banks():
    from linemod_pose_estimation_tpu_torch.models.detector import Detector
    from linemod_pose_estimation_tpu_torch.utils import scenes as S

    ref = RB.read_templates(BANK)
    det = Detector.read(BANK, device="cpu")
    sub = S.CROP_BANK_SUBSET
    ref_sub = RB.Bank(ref.class_id, ref.T, ref.modalities,
                      [[lv[i] for i in sub] for lv in ref.levels],
                      [s[sub] for s in ref.sizes], ref.weak_threshold,
                      ref.distance_threshold, ref.difference_threshold)
    return ref, ref_sub, det, sub


def test_bank_reader_equals_the_programs(banks):
    from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank

    ref, _, det, _ = banks
    bank = det.bank(det.class_ids[0])
    assert ref.num_templates == bank.num_templates == 2652
    for lv in range(2):
        mf = bank.merged_features(lv)
        for n in range(0, 2652, 13):
            k = int(mf.count[n])
            rows = np.concatenate([mf.offsets[n, :k].numpy(), mf.oris[n, :k, None].numpy()], 1)
            assert np.array_equal(rows, ref.levels[lv][n])
        assert np.array_equal(mf.size.numpy(), ref.sizes[lv])
    meta, glob = TemplateBank.read_params_yaml(PARAMS)
    p = RB.read_params(PARAMS)
    for k in ("R", "T", "K", "D", "Ori_dist", "Rect"):
        assert np.array_equal(getattr(meta, k), getattr(p, k))
    assert p.globals["focal_length_x"] == glob.focal_length_x


@pytest.mark.parametrize("reps", [1, 2])
def test_matcher_equals_the_pooled_and_exhaustive_paths(banks, reps):
    from linemod_pose_estimation_tpu_torch.models.detector import Detector
    from linemod_pose_estimation_tpu_torch.models.serving import BatchedMatcher
    from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank
    from linemod_pose_estimation_tpu_torch.utils import scenes as S

    _, ref_sub, det, sub = banks
    cid = det.class_ids[0]
    bank = det.bank(cid)
    d = Detector(bank.params, device="cpu")
    d.attach_bank(TemplateBank(cid, bank.params, [bank.templates[i] for i in sub])
                  .tile(reps, 64 * reps + 8))
    rgbs, deps = S.golden_crops()
    want = RM.ReferenceMatcher(ref_sub, 70.0, 32, reps=reps, device="cpu").match(rgbs, deps)
    for kw in (dict(prune=True, prune_mode="pooled"), {}):
        got = BatchedMatcher(d, cid, 70.0, len(rgbs), top_k=32, device="cpu",
                             **kw).match_batch(rgbs, deps)
        for f in range(len(rgbs)):
            g = RM.valid_set({k: getattr(got, k)[f].numpy() for k in got._fields})
            assert g == RM.valid_set(want[f])
    counts = [int(w["valid"].sum()) for w in want]
    assert min(counts) > 0 and max(len(w["valid"]) for w in want) == 32  # top-k full


def test_matcher_template_order_equals_match_raw(banks):
    from linemod_pose_estimation_tpu_torch.models.detector import Detector
    from linemod_pose_estimation_tpu_torch.models.templates import TemplateBank
    from linemod_pose_estimation_tpu_torch.utils import scenes as S

    _, ref_sub, det, sub = banks
    cid = det.class_ids[0]
    bank = det.bank(cid)
    d = Detector(bank.params, device="cpu")
    d.attach_bank(TemplateBank(cid, bank.params, [bank.templates[i] for i in sub]))
    rgbs, deps = S.golden_crops()
    for f in range(len(rgbs)):
        got = d.match_raw(rgbs[f], 70.0, depth_mm=deps[f], top_k=16)[cid]
        want = RM.ReferenceMatcher(ref_sub, 70.0, 16, order="template",
                                   device="cpu").match(rgbs[f:f + 1], deps[f:f + 1])[0]
        n = len(want["valid"])
        for k in want:
            assert np.array_equal(getattr(got, k).numpy()[:n], want[k])
        assert not got.valid.numpy()[n:].any()


def test_control_in_bfloat16_differs(banks):
    """The control: the reference with its float chains in bfloat16 puts
    other matches on these frames; at the cells' sizes it differs on 35-76
    of 96 frames (PERF.md)."""
    from linemod_pose_estimation_tpu_torch.utils import scenes as S

    _, ref_sub, _, _ = banks
    rgbs, deps = S.golden_crops()
    f32 = RM.ReferenceMatcher(ref_sub, 70.0, 32, device="cpu").match(rgbs, deps)
    low = RM.ReferenceMatcher(ref_sub, 70.0, 32, device="cpu",
                              dtype=torch.bfloat16).match(rgbs, deps)
    assert any(RM.valid_set(a) != RM.valid_set(b) for a, b in zip(f32, low))


def test_detect_equals_the_pipeline():
    from linemod_pose_estimation_tpu_torch.models.cascade import CascadeParams
    from linemod_pose_estimation_tpu_torch.models.pipeline import DetectionPipeline
    from linemod_pose_estimation_tpu_torch.utils.stl import Mesh

    from benchmark.harness import detect as HD
    from benchmark.harness import scenes
    from benchmark.reference import detect as RD

    with np.load("tests/data/torch_cascade_golden.npz") as z:
        rgb, dep = z["rgb"][0], z["depth_mm"][0]
    p = RB.read_params(PARAMS)
    tris = scenes.cuboid_triangles()
    cloud = scenes.depth_to_cloud(dep, p.globals["focal_length_x"], p.globals["focal_length_y"])
    pipe = DetectionPipeline.from_files(BANK, PARAMS, Mesh(tris, np.zeros((len(tris), 3))),
                                        CascadeParams(), device="cpu")
    got = pipe.detect(rgb, cloud, 91.0, depth_mm=dep)
    _, want = RD.ReferenceDetect(RB.read_templates(BANK), p, tris, 91.0,
                                 device="cpu").detect(rgb, dep, cloud)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert g.rect == w["rect"] and HD.pose_gap(g.pose, w["pose"]) == (0.0, 0.0)


def test_trainer_equals_train_from_stl(tmp_path):
    from linemod_pose_estimation_tpu_torch.models.templates import DetectorParams
    from linemod_pose_estimation_tpu_torch.models.trainer import TrainerConfig, train_from_stl

    from benchmark.harness import scenes
    from benchmark.harness import train as HT
    from benchmark.reference import trainer as RT

    tris = scenes.cuboid_triangles()
    stl = str(tmp_path / "c.stl")
    scenes.write_binary_stl(stl, tris)
    base = TrainerConfig()
    cfg = TrainerConfig(detector=DetectorParams(use_depth_normal=True), width=160, height=120,
                        focal_length_x=base.focal_length_x / 4,
                        focal_length_y=base.focal_length_y / 4)
    _, bank = train_from_stl(stl, cfg, max_views=24, device="cpu")
    ids = list(range(24))
    want = RT.train_views(tris, ids, 24, device="cpu", width=160, height=120,
                          fx=cfg.focal_length_x, fy=cfg.focal_length_y)
    assert sum(w is not None for w in want.values()) == len(bank.templates) > 0
    cell = HT.Cell.__new__(HT.Cell)
    cell.banks, cell.views, cell.check_views, cell.seed = [bank], 24, 24, 1
    assert HT.Cell.compare(cell.answers(), {0: want}) == {"views_wrong": {"value": 0,
                                                                          "limit": 0}}
