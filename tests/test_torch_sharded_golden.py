"""The port's data=2 x bank=2 detect step at full width against the JAX
reference's (tests/data/torch_sharded_golden.npz, written by
tools/make_torch_sharded_golden.py), on CPU in 4 gloo ranks: the four
640x480 RGB-D frames of tests/data/torch_cascade_golden.npz over the
2652-template RGB-D bank at threshold 91, in the pooled mode (with the
group tier of 16, which the reference's step drops) and the positions
mode.

Tolerance: exact equality of every Matches field and of the metrics.
"""

import pickle

import numpy as np
import pytest

import _torch_sharded_ranks as RK
import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from linemod_pose_estimation_tpu_torch.models.detector import Detector
from linemod_pose_estimation_tpu_torch.parallel import mesh as PM

BANK = "data/boxNew_rgbd_templates.yml.gz"
FRAMES = "tests/data/torch_cascade_golden.npz"
GOLDEN = "tests/data/torch_sharded_golden.npz"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_sharded_golden")
    gold = dict(np.load(GOLDEN))
    det = Detector.read(BANK, device="cpu")
    bank = det.bank(det.class_ids[0])
    T0, T1 = det.params.t_pyramid
    Kc1 = bank.max_cell_extent(1)
    fields = lambda lv: tuple(a.numpy() for a in bank.merged_features(lv))
    kw = dict(T1=T1, Kc1=Kc1, top_k=int(gold["top_k"]), threshold=float(gold["threshold"]),
              T0=T0, E0=bank.extent(0), use_depth=True, prune=True)
    steps = {"pool": dict(prune_mode="pooled", pool_coarse=int(gold["pool_coarse"]),
                          pool_fine=int(gold["pool_fine"]),
                          sel_row_cap=int(gold["sel_row_cap"]), **kw),
             "pos": dict(prune_mode="positions", **kw)}
    with np.load(FRAMES) as z:
        frames, depths = z["rgb"], z["depth_mm"]
    PM.spawn(RK.run_golden, 4, "gloo", str(d / "rendezvous"),
             args=(fields(1), fields(0), frames, depths,
                   dict(C=8 * bank.num_modalities, T1=T1, Kc1=Kc1, fine_g=4,
                        group_bound=16), steps, str(d)), timeout_s=300.0)

    def load(name):
        out = []
        for r in range(4):
            with open(d / f"{name}_{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out

    return load, gold


@pytest.mark.parametrize("key", ["pool", "pos"])
def test_sharded_step_equals_golden(runs, key):
    load, gold = runs
    got = load(key)
    for r, g in enumerate(got):
        d = r // 2
        for name, a in g["matches"].items():
            np.testing.assert_array_equal(a, gold[f"{key}_m_{name}"][2 * d:2 * d + 2],
                                          err_msg=f"rank {r} {name}")
        for k, v in g["metrics"].items():
            assert v == gold[f"{key}_{k}"], (r, k)
    assert int(gold[f"{key}_num_matches"]) == 13
    if key == "pool":
        assert all(g["grouped_calls"] == 1 for g in got)
        assert not any(bool(g["pool"]["fallback"]) for g in got)
