"""Rank bodies for tests/test_torch_sharded*.py.

`run_cases` is what parallel.mesh.spawn starts in each gloo rank: it runs
the named cases in order on CPU tensors, or on cuda:0 for the card's tests
(every rank runs every case, so the collectives line up), and pickles each
case's result, as numpy, to out_dir/<case>_<rank>.pkl.  spawn imports this module in every rank, so
it imports neither jax nor a test module.  The inputs are whole-batch
numpy arrays; each rank takes its own frames, stripe or shard by its
mesh coordinate, as a shard_map body would see them.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from linemod_pose_estimation_tpu_torch import convert
from linemod_pose_estimation_tpu_torch.ops import match as M
from linemod_pose_estimation_tpu_torch.parallel import ingest
from linemod_pose_estimation_tpu_torch.parallel import mesh as PM
from linemod_pose_estimation_tpu_torch.parallel import sharded_match as SM

CPU = torch.device("cpu")


def feats_of(fields) -> M.LevelFeatures:
    return convert.level_features_from_numpy(*fields, device="cpu")


def record(rec) -> dict:
    return {k: v.cpu().numpy() for k, v in rec._asdict().items()}


def local_rows(a: np.ndarray, mesh, dim: str) -> np.ndarray:
    """This rank's block of a's leading axis along mesh dim `dim`."""
    n = SM._mesh_size(mesh, dim)
    b = a.shape[0] // n
    c = mesh.get_local_rank(dim)
    return a[c * b:(c + 1) * b]


def count_calls(mod, name: str):
    """Wrap mod.name with a call counter; returns the counter list."""
    orig, calls = getattr(mod, name), []

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    setattr(mod, name, spy)
    return calls, lambda: setattr(mod, name, orig)


def case_coarse(mesh, R, feats, T, ext, top_k, threshold):
    f = SM.pad_bank_features(feats_of(feats), SM._mesh_size(mesh, "bank"))
    shard = SM._shard_rows(f, mesh.get_local_rank("bank"), SM._mesh_size(mesh, "bank"), CPU)
    fn = SM.make_sharded_coarse_matcher(mesh, T, ext, top_k, threshold)
    return record(fn(torch.from_numpy(local_rows(R, mesh, "data")), shard))


def case_step(mesh, rgbs, depths, feats1, feats0, bank_kw, step_kw, put=False,
              ref_bank=None, device="cpu"):
    """The detect step on this rank's frames; the bank from features, or
    from the reference's ShardedBank fields (`ref_bank`) when given."""
    if ref_bank is None:
        bank = SM.make_sharded_bank(mesh, feats_of(feats1), feats_of(feats0),
                                    device=device, **bank_kw)
    else:
        bank = convert.sharded_bank_from_numpy(
            **ref_bank, rank=mesh.get_local_rank("bank"),
            n_shards=SM._mesh_size(mesh, "bank"), device="cpu")
    step = SM.make_sharded_detect_step(mesh, **step_kw)
    if put:
        rg, dp = ingest.put_global_batch(mesh, local_rows(rgbs, mesh, "data"),
                                         None if depths is None
                                         else local_rows(depths, mesh, "data"))
    else:
        rg = local_rows(rgbs, mesh, "data")
        dp = None if depths is None else local_rows(depths, mesh, "data")
    calls, restore = count_calls(M, "pool_plan_grouped")
    try:
        mat, met = step(rg, dp, bank)
    finally:
        restore()
    out = {"matches": record(mat), "metrics": {k: v.cpu().numpy() for k, v in met.items()},
           "grouped_calls": len(calls), "collectives": dict(step.last_collectives)}
    if step.last_pool is not None:
        out["pool"] = record(step.last_pool)
    return out


def case_step_error(mesh, **kw):
    try:
        case_step(mesh, **kw)
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


def case_weights(mesh, feats1, feats0, bank_kw):
    bank = SM.make_sharded_bank(mesh, feats_of(feats1), feats_of(feats0), device="cpu",
                                **bank_kw)
    w = bank.weights
    out = {"W_gemm": w.exact.dense.nk.numpy(), "n": w.exact.n, "W_cell": w.W_cell.nk.numpy(),
           "feats1": record(bank.feats1), "feats0": record(bank.feats0), "C": bank.C,
           "fine_g": bank.fine_g, "shard": mesh.get_local_rank("bank")}
    if w.W_fine is not None:
        out["W_fine"] = w.W_fine.nk.numpy()
    if w.W_group is not None:
        out["W_group"] = w.W_group.nk.numpy()
        out["group_counts"] = w.group_counts.numpy()
    return out


def case_merge(mesh, per_shard, top_k, threshold):
    """per_shard[c]: Matches fields (numpy) of bank coordinate c."""
    mine = per_shard[mesh.get_local_rank("bank")]
    rec = convert.matches_from_numpy(*(mine[k] for k in M.Matches._fields), device="cpu")
    return record(SM._merge_topk(rec, top_k, threshold, mesh, "bank"))


def case_put(mesh, rgbs, depths):
    from torch.distributed.tensor import DTensor

    rg, dp = ingest.put_global_batch(mesh, local_rows(rgbs, mesh, "data"),
                                     local_rows(depths, mesh, "data"))
    assert isinstance(rg, DTensor) and isinstance(dp, DTensor)
    return {"shape": tuple(rg.shape), "depth_shape": tuple(dp.shape),
            "placements": [repr(p) for p in rg.placements],
            "local": rg.to_local().numpy(), "full": rg.full_tensor().numpy(),
            "depth_full": dp.full_tensor().numpy()}


def case_row(mesh, axis, R1, R0, feats1, feats0, C, T1, Kc1, mkw, device="cpu"):
    f1 = feats_of(feats1).to(device)
    W1 = M.exact_weights(f1, C, T1, Kc1)
    fn = SM.make_row_sharded_matcher(mesh, axis, T1, Kc1, **mkw)
    stripe = lambda R: torch.from_numpy(local_rows(np.moveaxis(R, 1, 0), mesh, axis)
                                        ).movedim(0, 1).contiguous().to(device)
    return record(fn(stripe(R1), stripe(R0), W1, f1, feats_of(feats0).to(device)))


def case_row_error(mesh, **kw):
    try:
        case_row(mesh, **kw)
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


def case_ring(mesh, axis, rgbs, depths, feats1, feats0, C, T1, Kc1, skw, device="cpu"):
    bank = SM.make_ring_bank(mesh, axis, feats_of(feats1), feats_of(feats0), C, T1, Kc1,
                             device=device)
    step = SM.make_ring_detect_step(mesh, axis, T1, Kc1, **skw)
    dp = None if depths is None else local_rows(depths, mesh, axis)
    out = record(step(local_rows(rgbs, mesh, axis), dp, bank))
    return {"matches": out, "collectives": dict(step.last_collectives)}


def case_mesh_error(mesh_shape):
    try:
        PM.make_mesh(*mesh_shape, device_type="cpu")
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


CASES = {"coarse": case_coarse, "step": case_step, "step_error": case_step_error,
         "weights": case_weights, "merge": case_merge, "put": case_put, "row": case_row,
         "row_error": case_row_error, "ring": case_ring}


def run_cases(rank: int, world: int, cases, out_dir: str, device: str = "cpu") -> None:
    """cases: [(name, kind, mesh shape (data, bank) or None, kwargs)]; on
    `device` "cuda" every rank runs on cuda:0."""
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
    meshes = {}
    for name, kind, shape, kw in cases:
        if kind == "mesh_error":
            res = case_mesh_error(**kw)
        else:
            if shape not in meshes:
                meshes[shape] = PM.make_mesh(*shape, device_type=device)
            res = CASES[kind](meshes[shape], **kw)
        with open(os.path.join(out_dir, f"{name}_{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)


def run_golden(rank: int, world: int, feats1, feats0, frames, depths, bank_kw, steps,
               out_dir: str) -> None:
    """The port's 2x2 detect step on the golden frames, one result per
    entry of `steps` ({name: step kwargs})."""
    torch.set_num_threads(1)
    mesh = PM.make_mesh(2, 2, device_type="cpu")
    for name, skw in steps.items():
        res = case_step(mesh, frames, depths, feats1, feats0, bank_kw, skw, put=True)
        with open(os.path.join(out_dir, f"{name}_{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
