"""PyTorch port vs the JAX reference: the rasterizer (models/renderer.py
with ops/raster.py, the plain version of kernel K4) on CPU.

Same numpy triangles (the cuboid stand-in for the boxNew mesh: 368
triangles here, one case at the full 1952) and poses go to both
packages.  Tolerances: the mask and the rect are equal; depth
agrees within 1e-3 mm (the reference's CPU XLA contracts products into
FMAs, the port's plain version does not, so depths differ by a few f32
ulps at ~0.5 m, ~3e-4 mm); the flat-shaded rgb is equal.  The reference
renders through ``models.renderer.render`` directly (never
``Renderer.render``, whose test-suite disk cache writes files).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from linemod_pose_estimation_tpu.models import renderer as JR
from linemod_pose_estimation_tpu.models.templates import TemplateBank as JBank
from linemod_pose_estimation_tpu.ops.pallas_raster import raster_zbuffer_pallas
from linemod_pose_estimation_tpu_torch import convert
from linemod_pose_estimation_tpu_torch.models import renderer as TR
from linemod_pose_estimation_tpu_torch.ops import raster as RA
from linemod_pose_estimation_tpu_torch.utils.geometry import quat_to_matrix
from linemod_pose_estimation_tpu_torch.utils.scenes import cuboid_mesh

PARAMS = "data/boxNew_rgbd_params.yml.gz"
DEPTH_TOL_MM = 1e-3


@pytest.fixture(scope="module")
def scene():
    meta, glob = JBank.read_params_yaml(PARAMS)
    tris = JR._pad_triangles(cuboid_mesh(subdiv=8).triangles, 64)
    return meta, glob, tris


def _K(glob, W, H):
    return np.array([[glob.focal_length_x / 4, 0, W / 2], [0, glob.focal_length_y / 4, H / 2],
                     [0, 0, 1]], np.float32)


def _both(tris, R, T, K, W, H):
    j = JR.render(jnp.asarray(tris), jnp.asarray(R), jnp.asarray(T), jnp.asarray(K), W, H)
    t = TR.render(convert.triangles_from_numpy(tris, device="cpu"), torch.from_numpy(R),
                  torch.from_numpy(T), torch.from_numpy(K), W, H)
    return j, t


def _assert_close(j, t):
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_array_equal(t.rect.numpy(), np.asarray(j.rect))
    np.testing.assert_allclose(t.depth_mm.numpy(), np.asarray(j.depth_mm),
                               atol=DEPTH_TOL_MM, rtol=0)
    np.testing.assert_array_equal(t.rgb.numpy(), np.asarray(j.rgb))


@pytest.mark.parametrize("wh", [(128, 128), (160, 120)])
@pytest.mark.parametrize("tid", [0, 2651])
def test_render_matches_reference(scene, wh, tid):
    meta, glob, tris = scene
    W, H = wh
    R, T = meta.R[tid].astype(np.float32), meta.T[tid].astype(np.float32)
    j, t = _both(tris, R, T, _K(glob, W, H), W, H)
    assert int((t.mask > 0).sum()) > 500  # the object is on screen
    _assert_close(j, t)


def test_render_full_mesh(scene):
    """The cascade's triangle load: the default cuboid, 1984 padded
    triangles."""
    meta, glob, _ = scene
    tris = JR._pad_triangles(cuboid_mesh().triangles, 64)
    assert tris.shape[0] == 1984
    R, T = meta.R[1400].astype(np.float32), meta.T[1400].astype(np.float32)
    j, t = _both(tris, R, T, _K(glob, 128, 128), 128, 128)
    _assert_close(j, t)


@pytest.mark.parametrize("seed", [0, 1])
def test_render_seeded_poses(scene, seed):
    """Random orientations at random in-view offsets (partly clipped by
    the frame edge on seed 1)."""
    _, glob, tris = scene
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    R = quat_to_matrix(torch.tensor(q, dtype=torch.float32)).numpy()
    off = rng.uniform(-0.05, 0.05, size=2) * (1 + 3 * seed)
    T = (R.T @ np.array([off[0], off[1], rng.uniform(0.4, 0.8)])).astype(np.float32)
    j, t = _both(tris, R, T, _K(glob, 160, 120), 160, 120)
    assert int((t.mask > 0).sum()) > 100
    _assert_close(j, t)


@pytest.mark.parametrize("wh", [(128, 128), (160, 120)])
def test_render_matches_pallas_interpret(scene, wh):
    """The port's plain z-buffer against the TPU kernel itself, run in
    interpret mode as tests/test_pallas_raster.py runs it: equal mask,
    depth within 1e-3 mm."""
    meta, glob, tris = scene
    W, H = wh
    K = _K(glob, W, H)
    R, T = meta.R[700].astype(np.float32), meta.T[700].astype(np.float32)
    zb, sb = raster_zbuffer_pallas(jnp.asarray(tris), jnp.asarray(R), jnp.asarray(T),
                                   jnp.asarray(K), W, H, interpret=True)
    j = JR._postprocess(zb, sb, W, H)
    t = TR.render(torch.from_numpy(tris), torch.from_numpy(R), torch.from_numpy(T),
                  torch.from_numpy(K), W, H)
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_array_equal(t.rect.numpy(), np.asarray(j.rect))
    np.testing.assert_allclose(t.depth_mm.numpy(), np.asarray(j.depth_mm),
                               atol=DEPTH_TOL_MM, rtol=0)


@pytest.mark.parametrize("case", ["off_axis", "behind"])
def test_render_empty_view(scene, case):
    """Object off-screen or behind the camera: no coverage, rect zeros."""
    _, glob, tris = scene
    R = np.eye(3, dtype=np.float32)
    T = np.array([10.0, 0.0, 0.5] if case == "off_axis" else [0.0, 0.0, -0.5], np.float32)
    j, t = _both(tris, R, T, _K(glob, 128, 128), 128, 128)
    assert int(t.mask.sum()) == 0 and t.rect.tolist() == [0, 0, 0, 0]
    _assert_close(j, t)


@pytest.mark.parametrize("seed", range(3))
def test_postprocess_rect(seed):
    """_postprocess on seeded z/shade buffers (holes, edge-touching
    blobs, an empty buffer): depth, mask, rgb and rect equal."""
    rng = np.random.default_rng(seed)
    H, W = 40, 56
    z = np.full((H, W), np.inf, np.float32)
    if seed < 2:
        y0, x0 = rng.integers(0, H - 5), rng.integers(0, W - 5)
        z[y0:y0 + rng.integers(3, H - y0), x0:x0 + rng.integers(3, W - x0)] = \
            rng.uniform(0.3, 0.9)
        z[rng.random((H, W)) < 0.1] = np.inf
    s = rng.random((H, W)).astype(np.float32)
    j = JR._postprocess(jnp.asarray(z), jnp.asarray(s), W, H)
    t = TR._postprocess(torch.from_numpy(z), torch.from_numpy(s))
    for name, a, b in zip(j._fields, j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


@pytest.mark.parametrize("rows", [30, None])
def test_zbuffer_ties_keep_the_first_row(scene, rows):
    """A coefficient table with every row appended again, the copy's shade
    1 - shade: every covered pixel ties exactly on depth, and the plain
    z-buffer keeps the first row's shade on every one (within one 64-row
    chunk with 30 rows, across chunks with all 1984 — what K4 is held to
    on the card)."""
    meta, glob, _ = scene
    tris = JR._pad_triangles(cuboid_mesh().triangles, 64)[:rows]
    K = torch.from_numpy(_K(glob, 128, 128))[None]
    R = torch.tensor(meta.R[[1400]], dtype=torch.float32)
    T = torch.tensor(meta.T[[1400]], dtype=torch.float32)
    if rows is not None:  # the first rows sit on one face: centre it
        c = tris.reshape(-1, 3).mean(0)
        T = T - torch.tensor(c, dtype=torch.float32)
    coefs = RA.triangle_coefficients(torch.from_numpy(tris), R, T, K)
    dup = coefs.clone()
    dup[..., RA.COEFS.index("shade")] = 1.0 - dup[..., RA.COEFS.index("shade")]
    z1, s1 = RA.raster_zbuffer_plain(coefs, 128, 128)
    z2, s2 = RA.raster_zbuffer_plain(torch.cat([coefs, dup], dim=1), 128, 128)
    hit = torch.isfinite(z1)
    assert int(hit.sum()) > 20 and bool((s1[hit] != 1.0 - s1[hit]).all())
    assert torch.equal(z2, z1) and torch.equal(s2, s1)


def test_render_batch_equals_single(scene):
    """P poses in one call give each pose's single render, bit for bit."""
    meta, glob, tris = scene
    ids = [0, 700, 2000]
    K = _K(glob, 128, 128)
    r = TR.Renderer(cuboid_mesh(subdiv=8), 128, 128, float(K[0, 0]), float(K[1, 1]),
                    device="cpu")
    batch = r.render_batch(meta.R[ids], meta.T[ids])
    for i, tid in enumerate(ids):
        one = r.render(meta.R[tid], meta.T[tid])
        for name, a, b in zip(one._fields, one, batch):
            assert torch.equal(a, b[i]), name
