"""The port's CLI, ``python -m linemod_pose_estimation_tpu_torch detect|serve
... --device cpu``, as subprocesses on files the port writes (the 160x120
fixture's bank and params by Detector.write / write_params_yaml, the
cuboid as a binary STL, two replay frames: the fixture scene and an empty
one), against the JAX reference's DetectionPipeline and PoseService on the
same files.

Tolerances: detection rects equal, scores within 1e-4, poses and the
base-frame transform within the CPU detect tolerance of 0.25 degrees /
0.5 mm; the identity transform on a miss and on an unknown object id,
exactly.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from linemod_pose_estimation_tpu.api import nodes as JN
from linemod_pose_estimation_tpu.api import service as JSV
from linemod_pose_estimation_tpu.models import cascade as JC
from linemod_pose_estimation_tpu.models.pipeline import DetectionPipeline as JPipe
from linemod_pose_estimation_tpu_torch.api import nodes as TN
from linemod_pose_estimation_tpu_torch.api import transforms as TTR
from linemod_pose_estimation_tpu_torch.utils.scenes import cuboid_mesh
from linemod_pose_estimation_tpu_torch.utils.stl import load_stl, save_binary_stl
from test_torch_cascade import DEG_TOL, MM_TOL, _pose_err, meta, pipelines  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THRESHOLD = 85.0
# The fixture's CascadeParams as CLI flags.
FAST = ["--threshold", str(THRESHOLD), "--icp-max-iter", "40", "--max-clusters", "2",
        "--model-cap", "512", "--scene-cap", "512", "--cluster-filter-thresh", "0",
        "--device", "cpu"]
JPARAMS = dict(icp_max_iter=40, max_clusters=2, model_cap=512, scene_cap=512,
               cluster_filter_thresh=0)


def run_cli(args, input_text=None, timeout=300):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", "linemod_pose_estimation_tpu_torch", *args],
                          capture_output=True, text=True, timeout=timeout,
                          input=input_text, cwd=ROOT, env=env)


@pytest.fixture(scope="module")
def files(pipelines, tmp_path_factory):  # noqa: F811
    jpipe, tpipe, _, rgb, cloud = pipelines
    d = tmp_path_factory.mktemp("cli")
    tpl, prm, stl = str(d / "templates.yml"), str(d / "params.yml"), str(d / "cuboid.stl")
    bank = tpipe.detector.bank(tpipe.class_id)
    bank.metadata, bank.globals = tpipe.metadata, tpipe.globals
    tpipe.detector.write(tpl)
    bank.write_params_yaml(prm)
    save_binary_stl(stl, cuboid_mesh().triangles)
    frames = d / "frames"
    frames.mkdir()
    TN.save_replay_frame(str(frames / "f0.npz"), rgb, cloud)
    H, W = rgb.shape[:2]
    TN.save_replay_frame(str(frames / "f1.npz"), np.zeros((H, W, 3), np.uint8),
                         np.full((H, W, 3), np.nan, np.float32))
    ref = JPipe.from_files(tpl, prm, stl, JC.CascadeParams(**JPARAMS))
    return dict(tpl=tpl, prm=prm, stl=stl, frames=str(frames), ref=ref)


def test_binary_stl_round_trip(tmp_path):
    tris = cuboid_mesh().triangles
    save_binary_stl(str(tmp_path / "m.stl"), tris)
    back = load_stl(str(tmp_path / "m.stl"))
    np.testing.assert_array_equal(back.triangles, tris)
    assert os.path.getsize(tmp_path / "m.stl") == 84 + 50 * len(tris)


def test_cli_detect_against_reference(files):
    r = run_cli(["detect", files["tpl"], files["prm"], files["stl"], files["frames"], *FAST])
    assert r.returncode == 0, r.stderr[-3000:]
    recs = [json.loads(line) for line in r.stdout.strip().splitlines()]
    assert [rec["frame"] for rec in recs] == [0, 1]
    src = JN.ReplayFrameSource(files["frames"])
    for rec in recs:
        f = src()
        want = files["ref"].detect(f.rgb, f.cloud, THRESHOLD)
        got = rec["detections"]
        assert [tuple(d["rect"]) for d in got] == [d.rect for d in want]
        for a, b in zip(got, want):
            assert abs(a["score"] - b.score) <= 1e-4
            deg, mm = _pose_err(np.array(a["pose"]), b.pose)
            assert deg <= DEG_TOL and mm <= MM_TOL, (deg, mm)
    assert len(recs[0]["detections"]) >= 1 and recs[1]["detections"] == []
    one = run_cli(["detect", files["tpl"], files["prm"], files["stl"], files["frames"],
                   "--count", "1", *FAST])
    assert one.returncode == 0 and len(one.stdout.strip().splitlines()) == 1


def test_cli_serve_against_reference(files):
    spec = f"0:{files['tpl']}:{files['prm']}:{files['stl']}:{THRESHOLD}"
    r = run_cli(["serve", files["frames"], "--object", spec, *FAST],
                input_text='0\n7\nnot-a-request\n{"object_id": 0}\nquit\n0\n')
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [json.loads(line) for line in r.stdout.strip().splitlines()]
    assert lines[0] == {"serving": [0]}
    hit, unknown, bad, miss = lines[1:]
    identity = {"translation": [0.0, 0.0, 0.0], "rotation_xyzw": [0.0, 0.0, 0.0, 1.0]}
    assert unknown == {"object_id": 7, **identity}
    assert "error" in bad
    assert miss == {"object_id": 0, **identity}  # the second frame is empty
    svc = JSV.PoseService(JN.ReplayFrameSource(files["frames"]))
    svc.register_object(0, JSV.ObjectConfig(pipeline=files["ref"], threshold=THRESHOLD))
    want = svc.linemod_object_pose(0)
    assert hit["object_id"] == 0 and hit["translation"] != identity["translation"]
    deg, mm = _pose_err(TTR.make_affine(*hit["translation"], hit["rotation_xyzw"][3],
                                        *hit["rotation_xyzw"][:3]),
                        TTR.make_affine(*want.translation, want.rotation[3],
                                        *want.rotation[:3]))
    assert deg <= DEG_TOL and mm <= MM_TOL, (deg, mm)


def test_cli_rejects_a_bad_object_spec(files):
    r = run_cli(["serve", files["frames"], "--object", "0:only-two", "--device", "cpu"],
                input_text="quit\n")
    assert r.returncode == 2 and "bad --object spec" in r.stderr
