"""The port's trainer (``models/trainer.py``: train_from_stl,
train_and_write) against the JAX reference's, live on the CPU, on the
cuboid stand-in for the boxNew STL written as a binary STL (both trainers
take the same path), at 160x120 with the focal lengths / 4, render_batch 4,
in both modes; and, marked slow, at full width against
``tests/data/torch_trainer_golden.npz`` (tools/make_torch_trainer_golden.py).

Tolerances:
- the templates YAML is byte-identical, in both modes (every feature,
  size, the template order);
- params: R, T, K, Ori_dist and Rect equal; D within 1e-6 m.  D reads the
  render's centre depth, and the port's plain rasterizer's depth differs
  from the JAX CPU render's by up to 1e-3 mm (XLA contracts the CPU
  products into FMAs).  The templates are equal even so: no DepthNormal
  bin flips on these views (a flip would need a depth to cross an integer
  millimetre between the two renders).
"""

import gzip
import os

import numpy as np
import pytest

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from linemod_pose_estimation_tpu.models import templates as JT
from linemod_pose_estimation_tpu.models import trainer as JTR
from linemod_pose_estimation_tpu.utils import viewsphere as JV
from linemod_pose_estimation_tpu_torch.models import templates as TT
from linemod_pose_estimation_tpu_torch.models import trainer as TTR
from linemod_pose_estimation_tpu_torch.models.renderer import Renderer
from linemod_pose_estimation_tpu_torch.utils import viewsphere as TV
from linemod_pose_estimation_tpu_torch.utils.scenes import cuboid_mesh
from linemod_pose_estimation_tpu_torch.utils.stl import save_binary_stl

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_trainer_golden.npz")
D_TOL = 1e-6  # m

# name: (view sphere, offset of the mesh in metres)
CONFIGS = {
    # the reference test's small sphere: 4 points x 2 angles at 0.5 m
    "small": (dict(n_points=4, angle_step=180, radius_min=0.5, radius_max=0.5), None),
    # 0.25 m: rects of 78-99 px, past the reference's crop (120 - 24 = 96)
    # for half of them: its full-frame branch
    "close": (dict(n_points=4, angle_step=180, radius_min=0.25, radius_max=0.25), None),
    # the mesh 0.4 m off the origin the cameras look at: views 2 and 6
    # render nothing, the others sit on the frame's edges (4 templates kept
    # RGB-only, 2 with DepthNormal)
    "offset": (dict(n_points=4, angle_step=180, radius_min=0.5, radius_max=0.5),
               (0.15, 0.37, 0.0)),
}


def small_configs(sphere: dict, use_depth: bool):
    kw = dict(width=160, height=120, focal_length_x=535.566011 / 4,
              focal_length_y=537.168115 / 4, render_batch=4)
    return (JTR.TrainerConfig(view_sphere=JV.ViewSphereParams(**sphere),
                              detector=JT.DetectorParams(use_depth_normal=use_depth), **kw),
            TTR.TrainerConfig(view_sphere=TV.ViewSphereParams(**sphere),
                              detector=TT.DetectorParams(use_depth_normal=use_depth), **kw))


@pytest.fixture(scope="module")
def stls(tmp_path_factory):
    d = tmp_path_factory.mktemp("stl")
    out = {}
    for name, (_, offset) in CONFIGS.items():
        tris = cuboid_mesh().triangles
        if offset is not None:
            tris = tris + np.asarray(offset, np.float32)
        out[name] = str(d / f"{name}.stl")
        save_binary_stl(out[name], tris)
    return out


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def assert_params_match(port_yml, ref_yml):
    pm, pg = TT.TemplateBank.read_params_yaml(port_yml)
    rm, rg = TT.TemplateBank.read_params_yaml(ref_yml)
    for k in ("R", "T", "K", "Ori_dist", "Rect"):
        np.testing.assert_array_equal(getattr(pm, k), getattr(rm, k), err_msg=k)
    np.testing.assert_allclose(pm.D, rm.D, rtol=0, atol=D_TOL)
    assert pg == rg


@pytest.mark.parametrize("use_depth", [False, True], ids=["rgb", "rgbd"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_and_write_matches_the_reference(stls, tmp_path, name, use_depth):
    jc, tc = small_configs(CONFIGS[name][0], use_depth)
    files = {k: str(tmp_path / f"{k}.yml") for k in ("jt", "jp", "tt", "tp")}
    _, jbank = JTR.train_and_write(stls[name], files["jt"], files["jp"], config=jc)
    det, bank = TTR.train_and_write(stls[name], files["tt"], files["tp"], config=tc,
                                    device="cpu")
    assert bank.num_templates == jbank.num_templates
    assert read_bytes(files["tt"]) == read_bytes(files["jt"])
    assert_params_match(files["tp"], files["jp"])
    assert det.num_templates("obj") == bank.num_templates and det.bank("obj") is bank
    if name == "offset":
        assert 0 < bank.num_templates <= 6  # the two empty views are skipped
    else:
        assert bank.num_templates >= 4


def test_train_from_stl_stats_and_progress(stls, capsys):
    _, tc = small_configs(CONFIGS["offset"][0], False)
    stats = {}
    _, bank = TTR.train_from_stl(stls["offset"], tc, max_views=6, progress=True,
                                 device="cpu", stats=stats)
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"trained {stats['templates'] if i else '%d'} / {n} views"
                     .replace("%d", lines[0].split()[1]) for i, n in enumerate((4, 6))]
    assert stats["views"] == 6 and stats["chunks"] == 2
    assert stats["templates"] == bank.num_templates
    assert stats["wall_s"] >= stats["dispatch_s"] + stats["extract_s"]
    assert "busy_share" not in stats  # a device number: not measured on the CPU


def test_trained_bank_detects_its_own_view(stls):
    """tests/test_trainer.py's check, on the port: re-render trained view 0
    and match it with the written-and-read bank: template 0 at >= 95."""
    _, tc = small_configs(CONFIGS["small"][0], False)
    det, bank = TTR.train_from_stl(stls["small"], tc, device="cpu")
    r = Renderer(stls["small"], 160, 120, tc.focal_length_x, tc.focal_length_y, device="cpu")
    out = r.render(bank.metadata.R[0], bank.metadata.T[0])
    res = det.match(out.rgb.numpy(), threshold=88.0)["obj"]
    assert len(res) >= 1 and res.similarity.max() >= 95.0
    assert 0 in set(res.template_id.tolist())


def test_trainer_and_renderer_default_to_the_card(stls):
    import inspect

    import torch

    for fn in (TTR.train_from_stl, TTR.train_and_write):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TTR.train_from_stl(stls["small"], small_configs(CONFIGS["small"][0], False)[1])


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["rgb", "rgbd"])
def test_full_width_matches_the_golden(stls, tmp_path, mode):
    """The reference's TrainerConfig() (640x480, the launch-scale sphere)
    over the golden's first 32 views."""
    with np.load(GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    cfg = TTR.TrainerConfig(detector=TT.DetectorParams(use_depth_normal=mode == "rgbd"))
    tt, tp = str(tmp_path / "t.yml"), str(tmp_path / "p.yml")
    _, bank = TTR.train_and_write(stls["small"], tt, tp, cfg, max_views=int(g["views"]),
                                  device="cpu")
    assert read_bytes(tt) == gzip.decompress(g[f"{mode}_templates_yml_gz"].tobytes())
    gp = str(tmp_path / "golden_p.yml")
    with open(gp, "wb") as f:
        f.write(gzip.decompress(g[f"{mode}_params_yml_gz"].tobytes()))
    assert_params_match(tp, gp)
    np.testing.assert_array_equal(bank.metadata.Rect, g["rects"][g[f"{mode}_kept"]])
