"""PyTorch port vs the JAX reference: the row-sharded matcher (a frame's
rows over one mesh dim, halos pulled from the neighbouring stripes) and
the ring step (bank shards rotating around the ranks), on CPU.

The port runs in 4 gloo ranks (parallel.mesh.spawn, rank bodies in
tests/_torch_sharded_ranks.py), once for the module; the reference runs
on 4 of the conftest's 8 virtual devices.  The row-sharded cases are
tests/test_sharded.py's slow one cut to 320 x 128: 2 stripes of 160
rows (the "bank" dim of a data=2 x bank=2 mesh, replicated over "data")
and 4 stripes of 80 (a 1 x 4 mesh), where the upward halo of 90 rows
takes two hops; plants mid-stripe, across stripe seams and at the top
and bottom of the frame.  The ring is the reference's test: three
shifted templates padded to one a rank over a 4-rank ring, four frames.

Tolerance: exact equality (integer and bool fields bit for bit, the
similarity exactly: both compute 100 * raw / (4 * cnt) in f32).
"""

import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import _torch_sharded_ranks as RK
import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from linemod_pose_estimation_tpu.models.detector import Detector
from linemod_pose_estimation_tpu.models.templates import DetectorParams
from linemod_pose_estimation_tpu.ops import match as JM
from linemod_pose_estimation_tpu.parallel import sharded_match as JSM
from linemod_pose_estimation_tpu_torch.parallel import mesh as PM

sys.path.insert(0, "tests")
from test_match import make_object_patch, plant  # noqa: E402

WORLD = 4
H0, W0 = 320, 128
PLANTS = [(150, 40), (60, 30), (75, 50), (230, 20), (0, 40), (270, 60)]
STRIPES = {2: (2, 2), 4: (1, 4)}  # stripes -> the (data, bank) mesh, rows over "bank"


def row_bank():
    rng = np.random.default_rng(0)
    patch, mask = make_object_patch(rng)
    det = Detector(DetectorParams(), engine="gather")
    assert det.add_template(plant((H0, W0, 3), patch, (150, 40)),
                            plant((H0, W0), mask, (150, 40)), "obj") == 0
    return det, patch


def ring_bank():
    rng = np.random.default_rng(0)
    patch, mask = make_object_patch(rng)
    det = Detector(DetectorParams(), engine="gather")
    for shift in (0, 4, 9):
        assert det.add_template(plant((128, 128, 3), patch, (30, 40 + shift)),
                                plant((128, 128), mask, (30, 40 + shift)), "obj") >= 0
    frames = np.stack([plant((128, 128, 3), patch, (30, 40)),
                       plant((128, 128, 3), patch, (38, 34)),
                       plant((128, 128, 3), patch, (10, 80)),
                       np.zeros((128, 128, 3), np.uint8)])
    return det, frames


def fields(bank, level):
    return tuple(np.asarray(a) for a in bank.merged_features(level))


def bank_args(det):
    bank = det.bank("obj")
    T0, T1 = det.params.t_pyramid
    return dict(feats1=fields(bank, 1), feats0=fields(bank, 0), C=8, T1=T1,
                Kc1=bank.max_cell_extent(1)), dict(T0=T0, E0=bank.extent(0))


def responses(det, scene):
    T0, T1 = det.params.t_pyramid
    pyr = JM.preprocess_frame(jnp.asarray(scene), None, T0=T0, T1=T1)
    return np.asarray(pyr.grad_r1), np.asarray(pyr.grad_r0)


def build_cases():
    cases = []
    det, patch = row_bank()
    bkw, wkw = bank_args(det)
    for n, shape in STRIPES.items():
        for py, px in PLANTS:
            R1, R0 = responses(det, plant((H0, W0, 3), patch, (py, px)))
            cases.append((f"row{n}_{py}_{px}", "row", shape, dict(
                axis="bank", R1=R1, R0=R0, **bkw,
                mkw=dict(top_k=8, threshold=90.0, **wkw))))
    # Stripes off the grids: 84 level-0 rows (not a multiple of T0 = 5), and
    # 40 level-0 / 20 level-1 rows (20 is not a multiple of T1 = 8).
    for name, h0, h1 in (("row_bad_T0", 168, 84), ("row_bad_T1", 80, 40)):
        cases.append((name, "row_error", (2, 2), dict(
            axis="bank", R1=np.zeros((8, h1, W0 // 2), np.uint8),
            R0=np.zeros((8, h0, W0), np.uint8), **bkw,
            mkw=dict(top_k=8, threshold=90.0, **wkw))))
    det, frames = ring_bank()
    bkw, wkw = bank_args(det)
    cases.append(("ring", "ring", (1, 4), dict(
        axis="bank", rgbs=frames, depths=np.zeros((4, 128, 128), np.float32), **bkw,
        skw=dict(top_k=8, threshold=90.0, **wkw))))
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_sharded_ring")
    PM.spawn(RK.run_cases, WORLD, "gloo", str(d / "rendezvous"),
             args=(build_cases(), str(d)), timeout_s=120.0)

    def load(name):
        out = []
        for r in range(WORLD):
            with open(d / f"{name}_{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out

    return load


def jmesh(shape):
    return Mesh(np.asarray(jax.devices()[:WORLD]).reshape(shape), ("data", "bank"))


@pytest.mark.parametrize("n", list(STRIPES))
def test_row_sharded_matcher_equals_single_device(runs, n):
    """Every rank's Matches equal the reference's row-sharded matcher on
    the same stripes and mesh shape, and its best match is the
    single-device engine's."""
    det, patch = row_bank()
    bank = det.bank("obj")
    T0, T1 = det.params.t_pyramid
    mesh = jmesh(STRIPES[n])
    rep = lambda a: jax.device_put(a, NamedSharding(mesh, P()))
    rows = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(mesh, P(None, "bank")))
    matcher = JSM.make_row_sharded_matcher(mesh, "bank", T1, bank.max_cell_extent(1),
                                           top_k=8, threshold=90.0, T0=T0,
                                           E0=bank.extent(0))
    for py, px in PLANTS:
        scene = plant((H0, W0, 3), patch, (py, px))
        R1, R0 = responses(det, scene)
        want = matcher(rows(R1), rows(R0), rep(bank.gemm_weights(1)),
                       jax.tree.map(rep, bank.merged_features(1)),
                       jax.tree.map(rep, bank.merged_features(0)))
        for r, got in enumerate(runs(f"row{n}_{py}_{px}")):
            for name in got:
                np.testing.assert_array_equal(got[name], np.asarray(getattr(want, name)),
                                              err_msg=f"{(py, px)} rank {r} {name}")
        ref = det.match(scene, 90.0)["obj"]
        assert len(ref) > 0, (py, px)
        rbest = int(np.argmax(ref.similarity))
        g = runs(f"row{n}_{py}_{px}")[0]
        assert g["valid"].any(), (py, px)
        b = int(np.argmax(np.where(g["valid"], g["similarity"], -1.0)))
        assert g["similarity"][b] >= float(ref.similarity[rbest]) - 1e-4, (py, px)
        assert (int(g["x"][b]), int(g["y"][b])) == (int(ref.x[rbest]),
                                                    int(ref.y[rbest])), (py, px)


@pytest.mark.parametrize("name,grid", [("row_bad_T0", "multiples of T0"),
                                       ("row_bad_T1", "multiples of T1 at level 1")])
def test_row_stripes_off_the_grid_raise(runs, name, grid):
    for r in runs(name):
        assert r["error"] is not None and grid in r["error"], r["error"]


def test_ring_detect_equals_single_device(runs):
    """Frames stay put and bank shards rotate: after 4 hops every rank's
    Matches equal the reference's ring step, and its valid set is the
    single-device engine's."""
    det, frames = ring_bank()
    bank = det.bank("obj")
    T0, T1 = det.params.t_pyramid
    Kc1 = bank.max_cell_extent(1)
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("ring",))
    ring = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("ring")))
    rb = JSM.make_ring_bank(mesh, "ring", bank.merged_features(1), bank.merged_features(0),
                            C=8, T1=T1, Kc1=Kc1)
    step = JSM.make_ring_detect_step(mesh, "ring", T1, Kc1, top_k=8, threshold=90.0,
                                     T0=T0, E0=bank.extent(0))
    want = step(ring(frames), ring(np.zeros((4, 128, 128), np.float32)), rb)
    got = runs("ring")
    for r, g in enumerate(got):
        for name, a in g["matches"].items():
            np.testing.assert_array_equal(a[0], np.asarray(getattr(want, name))[r],
                                          err_msg=f"rank {r} {name}")
        # Three hops, each the shard's GEMM weights (1 template padded to 8
        # rows) and both levels' features.
        assert g["collectives"]["ppermute"] > 0
    for b in range(4):
        m = got[b]["matches"]
        ref = det.match(frames[b], 90.0)["obj"]
        have = {(int(t), int(x), int(y), round(float(s), 3)) for t, x, y, s, v in zip(
            m["template_id"][0], m["x"][0], m["y"][0], m["similarity"][0], m["valid"][0]) if v}
        want_set = {(int(ref.template_id[i]), int(ref.x[i]), int(ref.y[i]),
                     round(float(ref.similarity[i]), 3)) for i in range(len(ref))}
        assert have == want_set, f"frame {b}: {have} != {want_set}"
