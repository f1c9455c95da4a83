"""PyTorch port vs the JAX reference: the multi-device layer
(parallel/mesh.py, parallel/sharded_match.py, put_global_batch) on CPU.

The port runs in 4 gloo ranks (parallel.mesh.spawn; the rank bodies are
tests/_torch_sharded_ranks.py), once for the whole module; the reference
runs its shard_map functions on 4 of the conftest's 8 virtual devices
laid out as the same mesh (data=2 x bank=2).  Each case mirrors one of
tests/test_sharded.py at its sizes (seeded random banks and frames, the
planted-disk bank at 128 x 128), plus what the port adds: a shard's
weights against the rows of the whole bank's, the merge's tie order, the
group tier in the pooled step, the bank-derived fine width, make_mesh on
a world that does not factor.

Tolerance: exact equality.  Integer and bool fields bit for bit; the
similarity exactly (both packages compute 100 * raw / (4 * cnt) in f32).
"""

import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import _torch_sharded_ranks as RK
import _xdist_threads  # noqa: F401  (PyTorch threads per xdist worker)

from linemod_pose_estimation_tpu.ops import match as JM
from linemod_pose_estimation_tpu.parallel import mesh as JPM
from linemod_pose_estimation_tpu.parallel import sharded_match as JSM
from linemod_pose_estimation_tpu_torch import convert
from linemod_pose_estimation_tpu_torch.ops import match as TM
from linemod_pose_estimation_tpu_torch.parallel import mesh as PM
from linemod_pose_estimation_tpu_torch.parallel import sharded_match as SM

sys.path.insert(0, "tests")
from test_match import make_object_patch, plant  # noqa: E402

WORLD = 4
MESH = (2, 2)  # (data, bank): rank r at (r // 2, r % 2)
T0, T1, E1 = 5, 8, 16
KC1 = (E1 - 1) // T1 + 1


def random_fields(rng, n, fmax=16, extent=32):
    """tests/test_sharded.py's random_bank, as numpy LevelFeatures fields."""
    offs = rng.integers(0, extent, size=(n, fmax, 2)).astype(np.int32)
    oris = rng.integers(0, 8, size=(n, fmax)).astype(np.int32)
    cnt = rng.integers(fmax // 2, fmax + 1, size=(n,)).astype(np.int32)
    live = np.arange(fmax)[None, :] < cnt[:, None]
    size = np.full((n, 2), extent, np.int32)
    return (offs, oris, live, cnt, size)


def jfeats(fields):
    return JM.LevelFeatures(*map(jnp.asarray, fields))


def random_responses(rng, b, h, w):
    return rng.choice([0, 3, 4], size=(b, 8, h, w), p=[0.5, 0.25, 0.25]).astype(np.uint8)


def step_inputs(seed):
    """test_sharded_detect_step_runs' bank and frames."""
    rng = np.random.default_rng(seed)
    f1 = random_fields(rng, 16, extent=E1)
    f0 = random_fields(rng, 16, extent=2 * E1)
    rgbs = rng.integers(0, 255, size=(2, 64, 64, 3), dtype=np.uint8)
    return f1, f0, rgbs, np.zeros((2, 64, 64), np.float32)


def planted_inputs():
    """test_sharded_detect_equals_single_device's bank (the reference's
    gather Detector on a planted disk) and its two frames."""
    from linemod_pose_estimation_tpu.models.detector import Detector
    from linemod_pose_estimation_tpu.models.templates import DetectorParams

    rng = np.random.default_rng(0)
    patch, mask = make_object_patch(rng)
    src = plant((128, 128, 3), patch, (30, 50))
    det = Detector(DetectorParams(), engine="gather")
    assert det.add_template(src, plant((128, 128), mask, (30, 50)), "obj") == 0
    bank = det.bank("obj")
    frames = np.stack([src, plant((128, 128, 3), patch, (38, 34))])
    f1 = tuple(np.asarray(a) for a in bank.merged_features(1))
    f0 = tuple(np.asarray(a) for a in bank.merged_features(0))
    return det, f1, f0, frames, bank.max_cell_extent(1), bank.extent(0)


STEP_MODES = {
    "pooled": dict(prune=True, prune_mode="pooled"),
    "positions": dict(prune=True, prune_mode="positions"),
    "positions_nofine": dict(prune=True, prune_mode="positions", fine_g=None),
    "two_axis": dict(prune=True, prune_mode="two_axis"),
    "exhaustive": dict(prune=False),
    "pooled_fallback": dict(prune=True, prune_mode="pooled", pool_coarse=2),
}


def step_kw(mode, **kw):
    return dict(T1=T1, Kc1=KC1, top_k=8, threshold=0.0, T0=T0, E0=2 * E1,
                **STEP_MODES[mode], **kw)


def build_cases():
    cases = []
    rng = np.random.default_rng(0)
    feats = random_fields(rng, 24)
    R = random_responses(rng, 2, 64, 96)
    cases.append(("coarse", "coarse", MESH, dict(R=R, feats=feats, T=8, ext=5, top_k=16,
                                                   threshold=0.0)))
    f1, f0, rgbs, deps = step_inputs(1)
    for mode in STEP_MODES:
        fine = STEP_MODES[mode].get("fine_g", 4)
        cases.append((f"step_{mode}", "step", MESH, dict(
            rgbs=rgbs, depths=deps, feats1=f1, feats0=f0,
            bank_kw=dict(C=8, T1=T1, Kc1=KC1, fine_g=fine),
            step_kw={k: v for k, v in step_kw(mode).items()})))
    # fine_g coupling: both off runs; bank off + step on fails.
    cases.append(("fine_off", "step", MESH, dict(
        rgbs=rgbs, depths=deps, feats1=f1, feats0=f0,
        bank_kw=dict(C=8, T1=T1, Kc1=KC1, fine_g=None), step_kw=step_kw("positions_nofine"))))
    cases.append(("fine_mismatch", "step_error", MESH, dict(
        rgbs=rgbs, depths=deps, feats1=f1, feats0=f0,
        bank_kw=dict(C=8, T1=T1, Kc1=KC1, fine_g=None), step_kw=step_kw("positions"))))
    cases.append(("fine_g2_vs_4", "step_error", MESH, dict(
        rgbs=rgbs, depths=deps, feats1=f1, feats0=f0,
        bank_kw=dict(C=16, T1=T1, Kc1=KC1, fine_g=2), step_kw=step_kw("pooled"))))
    cases.append(("channels", "step_error", MESH, dict(
        rgbs=rgbs, depths=deps, feats1=f1, feats0=f0,
        bank_kw=dict(C=16, T1=T1, Kc1=KC1, fine_g=4), step_kw=step_kw("pooled"))))
    # The group tier: pooled with and without it, on the planted bank.
    _, pf1, pf0, frames, kc1, e0 = planted_inputs()
    pdeps = np.zeros((2, 128, 128), np.float32)
    pkw = dict(T1=T1, Kc1=kc1, top_k=8, threshold=90.0, T0=T0, E0=e0)
    for name, mode, group in (("planted_positions", "positions", None),
                              ("planted_pooled", "pooled", None),
                              ("planted_pooled_group", "pooled", 2)):
        extra = dict(prune=True, prune_mode=mode)
        if mode == "pooled":
            extra.update(pool_coarse=256, pool_fine=128)
        cases.append((name, "step", MESH, dict(
            rgbs=frames, depths=pdeps, feats1=pf1, feats0=pf0, put=True,
            bank_kw=dict(C=8, T1=T1, Kc1=kc1, fine_g=4, group_bound=group),
            step_kw=dict(**pkw, **extra))))
    # The reference's own ShardedBank, carried across by convert.
    for mode in ("positions", "pooled"):
        cases.append((f"ref_bank_{mode}", "step", MESH, dict(
            rgbs=rgbs, depths=deps, feats1=None, feats0=None, bank_kw=None,
            ref_bank=ref_bank_fields(f1, f0, 4), step_kw=step_kw(mode))))
    # Group tier on the random bank too (16 templates, groups of 4).
    cases.append(("step_pooled_group", "step", MESH, dict(
        rgbs=rgbs, depths=deps, feats1=f1, feats0=f0,
        bank_kw=dict(C=8, T1=T1, Kc1=KC1, fine_g=4, group_bound=4),
        step_kw=step_kw("pooled"))))
    # A shard's weights: 11 templates padded to 12, with the group tier.
    wf1 = random_fields(np.random.default_rng(3), 11, extent=E1)
    wf0 = random_fields(np.random.default_rng(4), 11, extent=2 * E1)
    cases.append(("weights", "weights", MESH, dict(
        feats1=wf1, feats0=wf0, bank_kw=dict(C=8, T1=T1, Kc1=KC1, fine_g=4,
                                             group_bound=4))))
    cases.append(("merge", "merge", MESH, dict(per_shard=merge_inputs(), top_k=6,
                                                 threshold=50.0)))
    prng = np.random.default_rng(5)
    cases.append(("put", "put", MESH, dict(
        rgbs=prng.integers(0, 255, size=(4, 8, 8, 3), dtype=np.uint8),
        depths=prng.random((4, 8, 8)).astype(np.float32))))
    cases.append(("mesh_3x1", "mesh_error", None, dict(mesh_shape=(3,))))
    cases.append(("mesh_3x2", "mesh_error", None, dict(mesh_shape=(3, 2))))
    return cases


def ref_bank_fields(f1, f0, fine_g):
    """The reference's ShardedBank on the 2x2 mesh, as numpy fields."""
    jmesh = JPM.make_mesh(*MESH, devices=jax.devices()[:WORLD])
    sb = JSM.make_sharded_bank(jmesh, jfeats(f1), jfeats(f0), C=8, T1=T1, Kc1=KC1,
                               fine_g=fine_g)
    tup = lambda f: tuple(np.asarray(a) for a in f)
    return dict(W1_rows=np.asarray(sb.W1_rows), W_cell=np.asarray(sb.W_cell),
                W_fine=np.asarray(sb.W_fine), feats1=tup(sb.feats1), feats0=tup(sb.feats0),
                C=8, fine_g=fine_g)


def merge_inputs():
    """Two shards' (1, 4) Matches with tied similarities across and within
    shards, and a valid-below-threshold and an invalid slot."""
    sim = [np.array([[90.0, 80.0, 80.0, 40.0]], np.float32),
           np.array([[90.0, 95.0, 80.0, 99.0]], np.float32)]
    valid = [np.array([[True, True, True, True]]), np.array([[True, True, True, False]])]
    return [dict(template_id=np.array([[10 * c + i for i in range(4)]], np.int32),
                 x=np.array([[100 * c + i for i in range(4)]], np.int32),
                 y=np.array([[7, 8, 9, 10]], np.int32), similarity=sim[c], valid=valid[c])
            for c in range(2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_sharded")
    PM.spawn(RK.run_cases, WORLD, "gloo", str(d / "rendezvous"),
             args=(build_cases(), str(d)), timeout_s=120.0)

    def load(name):
        out = []
        for r in range(WORLD):
            with open(d / f"{name}_{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out

    return load


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return JPM.make_mesh(*MESH, devices=jax.devices()[:WORLD])


def put_data(mesh, a):
    return jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("data")))


def assert_rank_rows_equal(per_rank, want, key=None):
    """Each rank's (B_local, K) record against rows of the reference's
    global (B, K) record: rank r holds the frames of data row r // 2."""
    for r, got in enumerate(per_rank):
        got = got if key is None else got[key]
        d = r // MESH[1]
        for name in got:
            w = np.asarray(getattr(want, name))
            b = w.shape[0] // MESH[0]
            np.testing.assert_array_equal(got[name], w[d * b:(d + 1) * b],
                                          err_msg=f"rank {r} field {name}")


def jax_step(jmesh, f1, f0, rgbs, deps, bank_kw, skw):
    sb = JSM.make_sharded_bank(jmesh, jfeats(f1), jfeats(f0), **bank_kw)
    step = JSM.make_sharded_detect_step(jmesh, **skw)
    return step(put_data(jmesh, rgbs), put_data(jmesh, deps), sb)


def assert_metrics_equal(per_rank, jmet):
    for r, got in enumerate(per_rank):
        for k, v in jmet.items():
            assert got["metrics"][k] == np.asarray(v), (r, k, got["metrics"][k], v)


def test_sharded_matches_single_device_result(runs, jmesh):
    rng = np.random.default_rng(0)
    feats = random_fields(rng, 24)
    R = random_responses(rng, 2, 64, 96)
    jf = JSM.pad_bank_features(jfeats(feats), MESH[1])
    want = JSM.make_sharded_coarse_matcher(jmesh, 8, 5, top_k=16, threshold=0.0)(
        jnp.asarray(R), jf)
    got = runs("coarse")
    assert_rank_rows_equal(got, want)
    # The single-device engine: the same best (id, cell) per frame.
    tf = convert.level_features_from_numpy(*feats, device="cpu")
    for fi in range(2):
        raw = TM.coarse_scores(RK.torch.from_numpy(R[fi]), tf, 8, 5)
        Hc, Wc = raw.shape[1:]
        ref = TM.select_candidates(raw, tf.count, TM.position_validity(tf.size, 8, Hc, Wc),
                                   0.0, 16)
        g = got[2 * fi]
        np.testing.assert_array_equal(np.sort(g["similarity"][0]),
                                      np.sort(ref.similarity.numpy()))
        gb, rb = int(np.argmax(g["similarity"][0])), int(np.argmax(ref.similarity.numpy()))
        assert (g["template_id"][0][gb], g["cell_y"][0][gb], g["cell_x"][0][gb]) == (
            int(ref.template_id[rb]), int(ref.cell_y[rb]), int(ref.cell_x[rb]))


@pytest.mark.parametrize("mode", list(STEP_MODES))
def test_sharded_detect_step_runs(runs, jmesh, mode):
    """Every mode of the production step equals the reference's step on
    the same raw frames and bank: Matches and the three metrics."""
    f1, f0, rgbs, deps = step_inputs(1)
    fine = STEP_MODES[mode].get("fine_g", 4)
    mat, met = jax_step(jmesh, f1, f0, rgbs, deps, dict(C=8, T1=T1, Kc1=KC1, fine_g=fine),
                        step_kw(mode))
    got = runs(f"step_{mode}")
    assert got[0]["matches"]["template_id"].shape == (1, 8)
    assert_rank_rows_equal(got, mat, "matches")
    assert_metrics_equal(got, met)
    assert int(got[0]["metrics"]["num_matches"]) >= 0
    assert -1.0 <= float(got[0]["metrics"]["best_similarity"]) <= 100.0


def test_sharded_bank_fine_g_coupling(runs, jmesh):
    """fine_g disabled on both sides runs coarse-only, equal to the
    reference; a bank without the fine stage under a step with it fails
    before any work, naming fine_g and the bank's C."""
    f1, f0, rgbs, deps = step_inputs(1)
    mat, met = jax_step(jmesh, f1, f0, rgbs, deps, dict(C=8, T1=T1, Kc1=KC1, fine_g=None),
                        step_kw("positions_nofine"))
    assert_rank_rows_equal(runs("fine_off"), mat, "matches")
    for r in runs("fine_mismatch"):
        assert r["error"] is not None and "fine_g" in r["error"] and "C=8" in r["error"]


def test_fine_width_reads_the_banks_channels(runs):
    """The fine-width check takes C from the bank (the reference derives it
    from use_depth): a C=16 bank built with g=2 against a g=4 step names
    C=16 and the bank's fine_g; a C=16 bank with g=4 passes the check and
    fails on the 8-channel frames, naming C=16."""
    for r in runs("fine_g2_vs_4"):
        assert "C=16" in r["error"] and "fine_g=2" in r["error"], r["error"]
    for r in runs("channels"):
        assert "C=16" in r["error"] and "give 8" in r["error"], r["error"]


def test_sharded_detect_equals_single_device(runs, jmesh):
    """The planted disk: the port's step (frames through put_global_batch)
    equals the reference's step, and finds the template where the
    reference's single-device engine does."""
    det, f1, f0, frames, kc1, e0 = planted_inputs()
    deps = np.zeros((2, 128, 128), np.float32)
    mat, met = jax_step(jmesh, f1, f0, frames, deps, dict(C=8, T1=T1, Kc1=kc1),
                        dict(T1=T1, Kc1=kc1, top_k=8, threshold=90.0, T0=T0, E0=e0))
    got = runs("planted_positions")
    assert_rank_rows_equal(got, mat, "matches")
    assert_metrics_equal(got, met)
    ref = det.match(frames[0], 90.0)["obj"]
    rbest = int(np.argmax(ref.similarity))
    g0 = got[0]["matches"]
    b0 = int(np.argmax(np.where(g0["valid"][0], g0["similarity"][0], -1.0)))
    assert g0["similarity"][0][b0] >= 99.0
    assert (g0["x"][0][b0], g0["y"][0][b0]) == (int(ref.x[rbest]), int(ref.y[rbest]))
    g1 = got[2]["matches"]
    b1 = int(np.argmax(np.where(g1["valid"][0], g1["similarity"][0], -1.0)))
    assert abs(int(g1["x"][0][b1]) - (int(ref.x[rbest]) - 16)) <= 2
    assert abs(int(g1["y"][0][b1]) - (int(ref.y[rbest]) + 8)) <= 2


def test_bank_padding_dead_templates():
    fields = random_fields(np.random.default_rng(0), 10)
    want = JSM.pad_bank_features(jfeats(fields), 4)
    got = SM.pad_bank_features(convert.level_features_from_numpy(*fields, device="cpu"), 4)
    assert got.oris.shape[0] == 12
    assert not bool(got.live[-1].any()) and int(got.count[-1]) == 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    same = SM.pad_bank_features(got, 4)
    assert same is got


def test_frame_batcher_and_global_put(runs):
    """FrameBatcher round-robins; put_global_batch makes each rank's frames
    its shard of the global batch over "data", replicated over "bank"."""
    from linemod_pose_estimation_tpu_torch.api.service import Frame
    from linemod_pose_estimation_tpu_torch.parallel.ingest import FrameBatcher

    frames = [Frame(rgb=np.full((8, 8, 3), i, np.uint8),
                    cloud=np.zeros((8, 8, 3), np.float32)) for i in range(3)]
    fb = FrameBatcher([lambda i=i: frames[i] for i in range(3)], batch=4)
    rgbs, _ = fb.next_batch()
    assert [int(r[0, 0, 0]) for r in rgbs] == [0, 1, 2, 0]
    assert int(fb.next_batch()[0][0, 0, 0, 0]) == 1
    prng = np.random.default_rng(5)
    rgbs = prng.integers(0, 255, size=(4, 8, 8, 3), dtype=np.uint8)
    deps = prng.random((4, 8, 8)).astype(np.float32)
    for r, got in enumerate(runs("put")):
        assert got["shape"] == (4, 8, 8, 3) and got["depth_shape"] == (4, 8, 8)
        assert got["placements"] == ["Shard(dim=0)", "Replicate()"]
        d = r // MESH[1]
        np.testing.assert_array_equal(got["local"], rgbs[2 * d:2 * d + 2])
        np.testing.assert_array_equal(got["full"], rgbs)
        np.testing.assert_array_equal(got["depth_full"], deps)
    assert PM.frame_sharding(None) == [PM.Shard(0), PM.Replicate()]
    assert PM.bank_sharding(None) == [PM.Replicate(), PM.Shard(0)]


def test_sharded_pooled_mode_equals_positions_mode(runs, jmesh):
    """The pooled step finds the positions step's valid matches, and equals
    the reference's pooled step."""
    det, f1, f0, frames, kc1, e0 = planted_inputs()
    deps = np.zeros((2, 128, 128), np.float32)
    mat, met = jax_step(jmesh, f1, f0, frames, deps, dict(C=8, T1=T1, Kc1=kc1),
                        dict(T1=T1, Kc1=kc1, top_k=8, threshold=90.0, T0=T0, E0=e0,
                             prune=True, prune_mode="pooled", pool_coarse=256,
                             pool_fine=128))
    pool, pos = runs("planted_pooled"), runs("planted_positions")
    assert_rank_rows_equal(pool, mat, "matches")
    assert_metrics_equal(pool, met)
    assert int(pool[0]["metrics"]["prune_fallback_shards"]) == 0

    def vset(m):
        return {(int(t), int(x), int(y), float(s)) for t, x, y, s, v in zip(
            m["template_id"][0], m["x"][0], m["y"][0], m["similarity"][0], m["valid"][0])
            if v}

    for r in range(WORLD):
        assert vset(pool[r]["matches"]) == vset(pos[r]["matches"]) != set()


@pytest.mark.parametrize("which", ["planted", "random"])
def test_pooled_group_tier_equals_without(runs, which):
    """The sharded pooled step with the bank's group tier (the reference's
    step drops it) gives the step's Matches and metrics without it, and
    the group pool ran on every rank."""
    on, off = ((runs("planted_pooled_group"), runs("planted_pooled")) if which == "planted"
               else (runs("step_pooled_group"), runs("step_pooled")))
    for a, b in zip(on, off):
        assert a["grouped_calls"] == 1 and b["grouped_calls"] == 0
        for k in b["matches"]:
            np.testing.assert_array_equal(a["matches"][k], b["matches"][k])
        for k in b["metrics"]:
            assert a["metrics"][k] == b["metrics"][k]
        for k in ("coarse_total", "coarse_m", "fine_total", "fine_m", "fallback"):
            np.testing.assert_array_equal(a["pool"][k], b["pool"][k])


def test_shard_weights_equal_rows_of_full_bank(runs):
    """Each shard's W1 rows, cell and fine weights are the whole (padded)
    bank's rows of its templates; its group tier is built over its own
    rows."""
    f1 = RK.feats_of(random_fields(np.random.default_rng(3), 11, extent=E1))
    full = TM.build_bank_weights(SM.pad_bank_features(f1, 2), 8, T1, KC1, 4, None)
    n_local = 6
    for r, got in enumerate(runs("weights")):
        c = r % MESH[1]
        assert got["shard"] == c and got["C"] == 8 and got["fine_g"] == 4
        rows = slice(c * n_local, (c + 1) * n_local)
        assert got["n"] == n_local
        np.testing.assert_array_equal(got["W_gemm"][:n_local], full.exact.dense.nk[rows].numpy())
        assert not got["W_gemm"][n_local:].any()  # padding to 8 rows is dead
        np.testing.assert_array_equal(got["W_cell"][:n_local], full.W_cell.nk[rows].numpy())
        np.testing.assert_array_equal(got["W_fine"][:n_local], full.W_fine.nk[rows].numpy())
        Wg, cnt = TM.build_group_bound(
            SM._shard_rows(SM.pad_bank_features(f1, 2), c, 2, "cpu"), 8, T1, KC1, 4)
        np.testing.assert_array_equal(got["W_group"][:Wg.shape[0]], Wg.numpy())
        np.testing.assert_array_equal(got["group_counts"], cnt.numpy())
        if c == 1:  # the padded template: dead
            assert got["feats1"]["count"][-1] == 0 and not got["feats1"]["live"][-1].any()


def test_merge_ties_go_to_lower_shard(runs):
    """The merge lays the shards out shard-major and keeps the top-k with
    ties to the lower flat index (the lower shard, then the lower slot),
    as lax.top_k over the reference's all_gather(axis=1)."""
    per = merge_inputs()
    sims = np.concatenate([p["similarity"] for p in per], 1)[0]
    valid = np.concatenate([p["valid"] for p in per], 1)[0]
    key = np.where(valid, sims, -1.0)
    order = sorted(range(8), key=lambda i: (-key[i], i))[:6]
    ids = np.concatenate([p["template_id"] for p in per], 1)[0]
    for got in runs("merge"):
        np.testing.assert_array_equal(got["template_id"][0], ids[order])
        np.testing.assert_array_equal(got["similarity"][0], key[order])
        np.testing.assert_array_equal(got["valid"][0], valid[order] & (key[order] >= 50.0))
    assert list(ids[order][:3]) == [11, 0, 10]  # 95, then the tie at 90: shard 0 first


def test_make_mesh_rejects_unfactored_world(runs):
    for name, msg in (("mesh_3x1", "mesh 3x1 != 4 devices"),
                      ("mesh_3x2", "mesh 3x2 != 4 devices")):
        for r in runs(name):
            assert r["error"] == msg


@pytest.mark.parametrize("mode", ["positions", "pooled"])
def test_step_on_the_references_bank(runs, jmesh, mode):
    """convert.sharded_bank_from_numpy gives each rank its shard of the
    reference's own ShardedBank; the port's step on it equals the
    reference's step."""
    f1, f0, rgbs, deps = step_inputs(1)
    mat, met = jax_step(jmesh, f1, f0, rgbs, deps, dict(C=8, T1=T1, Kc1=KC1),
                        step_kw(mode))
    got = runs(f"ref_bank_{mode}")
    assert_rank_rows_equal(got, mat, "matches")
    assert_metrics_equal(got, met)


def test_bank_converters_equal_the_ports_shards():
    """Both converters' shards of the reference's banks equal the shards
    the port builds from the same features."""
    f1, f0, _, _ = step_inputs(1)
    ref = ref_bank_fields(f1, f0, 4)
    t1, t0 = RK.feats_of(f1), RK.feats_of(f0)
    for r in range(2):
        got = convert.sharded_bank_from_numpy(**ref, rank=r, n_shards=2, device="cpu")
        s1, s0 = SM._shard_rows(t1, r, 2, "cpu"), SM._shard_rows(t0, r, 2, "cpu")
        want = TM.build_bank_weights(s1, 8, T1, KC1, 4)
        for name in ("exact", "W_cell", "W_fine"):
            a, b = getattr(got.weights, name), getattr(want, name)
            if name == "exact":
                a, b = a.dense, b.dense
            assert a.n == b.n and np.array_equal(a.nk.numpy(), b.nk.numpy()), name
        for a, b in zip((*got.feats1, *got.feats0), (*s1, *s0)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert (got.C, got.fine_g, got.group) == (8, 4, None)
    off = convert.sharded_bank_from_numpy(**ref_bank_fields(f1, f0, None), rank=0,
                                          n_shards=2, device="cpu")
    assert off.weights.W_fine is None and off.fine_g is None
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:WORLD]), ("ring",))
    rb = JSM.make_ring_bank(mesh, "ring", jfeats(f1), jfeats(f0), C=8, T1=T1, Kc1=KC1)
    tup = lambda f: tuple(np.asarray(a) for a in f)
    for r in range(WORLD):
        got = convert.ring_bank_from_numpy(np.asarray(rb.W1), tup(rb.feats1), tup(rb.feats0),
                                           rank=r, n_shards=WORLD, device="cpu")
        s1 = SM._shard_rows(t1, r, WORLD, "cpu")
        want = TM.exact_weights(s1, 8, T1, KC1)
        assert got.W1.n == want.n == 4 and torch_equal(got.W1.dense.nk, want.dense.nk)
        for a, b in zip(got.feats1, s1):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def torch_equal(a, b):
    return a.shape == b.shape and bool((a == b).all())
