"""The traffic generator: the same seed gives the same pools, other seeds
other pools of the same sizes, and the frozen copies agree with the
program's own helpers."""

import numpy as np
import torch

from benchmark.harness import common, scenes


def _views(k=3):
    """Small stand-in views: a bright square with a depth step."""
    out = []
    for i in range(k):
        rgb = np.zeros((480, 640, 3), np.uint8)
        dep = np.zeros((480, 640), np.float32)
        mask = np.zeros((480, 640), bool)
        mask[200:260, 300:380] = True
        rgb[mask] = 120 + 40 * i
        dep[mask] = 600.0 + i
        out.append((rgb, dep, mask, [300, 200, 80, 60]))
    return out


def test_pool_is_a_function_of_the_seed():
    big = 2**31 + 12345  # the driver's seeds pass 32 signed bits
    a = scenes.scene_pool(4, 2, common.rng(big, 2), _views())
    b = scenes.scene_pool(4, 2, common.rng(big, 2), _views())
    c = scenes.scene_pool(4, 2, common.rng(big + 1, 2), _views())
    assert all(np.array_equal(x, y) for x, y in zip(a[:2], b[:2])) and a[2] == b[2]
    assert not np.array_equal(a[0], c[0])
    assert a[0].shape == c[0].shape == (4, 480, 640, 3) and a[1].dtype == np.float32
    assert len(a[2][0]) == 2
    t = common.seeded_templates(big, 2652, 16)
    assert np.array_equal(t, common.seeded_templates(big, 2652, 16)) and len(set(t)) == 16
    assert not np.array_equal(t, common.seeded_templates(big + 1, 2652, 16))
    assert not np.array_equal(common.rng(big, 1).integers(1 << 30, size=4),
                              common.rng(big, 2).integers(1 << 30, size=4))


def test_frozen_copies_match_the_program():
    from linemod_pose_estimation_tpu_torch.utils import scenes as PS

    assert np.array_equal(scenes.cuboid_triangles(), PS.cuboid_mesh().triangles)
    rng = np.random.default_rng(0)
    d = rng.uniform(400, 1600, size=(48, 64)).astype(np.float32)
    d[3, 5] = 0.0
    got = scenes.depth_to_cloud(d, 535.566011, 537.168115)
    want = PS.replay_clouds([d], 535.566011, 537.168115)[0]
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0, equal_nan=True)
    assert np.isnan(got[3, 5]).all()


def test_stl_round_trip_and_rotations(tmp_path):
    from linemod_pose_estimation_tpu_torch.utils.stl import load_stl

    rots = [scenes.cube_rotation(k) for k in range(24)]
    assert len({r.tobytes() for r in rots}) == 24
    assert all(np.isclose(np.linalg.det(r), 1.0) for r in rots)
    tris = (scenes.cuboid_triangles().astype(np.float64) @ rots[5].T).astype(np.float32)
    path = tmp_path / "m.stl"
    scenes.write_binary_stl(str(path), tris)
    assert np.array_equal(load_stl(str(path)).triangles, tris)


def test_rendered_views_are_planted_whole():
    from benchmark.reference import bank as RB

    p = RB.read_params(str(common.params_path({"params": "data/boxNew_rgbd_params.yml.gz"})))
    g = p.globals
    # One pose at a quarter of the frame: the plain scan on the host.
    v = scenes.render_views(scenes.cuboid_triangles(), p.R[:1], p.T[:1],
                            g["focal_length_x"] / 4, g["focal_length_y"] / 4, W=160, H=120,
                            device="cpu")
    rgb, dep, mask, (x, y, w, h) = v[0]
    assert mask.any() and (dep[mask] > 0).all() and (dep[~mask] == 0).all()
    assert mask[y:y + h, x:x + w].sum() == mask.sum()
    fr, dp = scenes.background(120, 160, np.random.default_rng(1))
    ox, oy = scenes.plant(fr, dp, v[0], np.random.default_rng(2))
    assert (dp[oy:oy + h, ox:ox + w][mask[y:y + h, x:x + w]] == dep[mask]).all()
    assert torch.get_num_threads() >= 1
