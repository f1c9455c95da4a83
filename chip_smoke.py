"""Smoke run of the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Drives Detector.read -> BatchedMatcher(prune_mode="pooled") -> Matches
on the committed RGB-D bank at full width (480x640 frames, 16 response
channels, Fmax 128), after building the hand-written CUDA kernels K1
(ColorGradient quantizer), K2 (spread + response) and K3 (local walk)
from csrc/.  Phases, one JSON line each:

  0. card label (nvidia-smi) and the kernel build;
  1. K1 and K2 against their plain PyTorch versions on the card, bitwise,
     at the main path's shapes (B=32 at 480x640 and 240x320), with CUDA
     event times of both;
  2a. the untiled 2652-template bank on the 8-frame golden batch: Matches,
      n_valid, PooledStats and R0/R1 hashes equal the JAX reference's
      (tests/data/torch_port_golden.npz);
  2b. B=32 over the bank tiled to 10,624 templates: the kernel path equals
      the plain path (every Matches field); launch counts of K1/K2/K3 in
      that run, PooledStats, found rate, batch time;
  2c. the same batch with pool_coarse forced tiny: the exhaustive fallback
      runs and the Matches equal 2b's;
  3. K3 against its plain version on 2b's candidate sets, bitwise.

Then a kernels summary line, the card line, and last
{"ok": true, "device": {...}}.  Any failed check raises, and the script
exits non-zero without printing the last line.  It needs CUDA: without a
card it exits 2 before doing anything.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
BANK = os.path.join(REPO, "data", "boxNew_rgbd_templates.yml.gz")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_golden.npz")
THRESHOLD = 91.0
B_MAIN = 32
TILE_TO = 10624  # the bank tiled up to >= 10,240 templates, padded to 128
KERNELS = {
    "quantize_cg": ("K1", "linemod_pose_estimation_tpu_torch/csrc/quantize_cg.cu",
                    "linemod_pose_estimation_tpu/ops/pallas_preprocess.py:195"),
    "spread_response": ("K2", "linemod_pose_estimation_tpu_torch/csrc/spread_response.cu",
                        "linemod_pose_estimation_tpu/ops/pallas_kernels.py:136"),
    "walk_scores": ("K3", "linemod_pose_estimation_tpu_torch/csrc/walk_scores.cu",
                    "linemod_pose_estimation_tpu/ops/pallas_kernels.py:403"),
}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` back-to-back calls (CUDA events,
    after one warm-up call)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def matches_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def valid_equal(a, b) -> bool:
    """Same valid mask, and every field equal on the valid slots."""
    v = a.valid
    return torch.equal(v, b.valid) and all(torch.equal(x[v], y[v]) for x, y in zip(a, b))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from linemod_pose_estimation_tpu_torch.models.detector import Detector
    from linemod_pose_estimation_tpu_torch.models.serving import (
        BatchedMatcher, slice_settings)
    from linemod_pose_estimation_tpu_torch.ops import _build
    from linemod_pose_estimation_tpu_torch.ops import cuda_kernels as CK
    from linemod_pose_estimation_tpu_torch.ops import cuda_preprocess as CP
    from linemod_pose_estimation_tpu_torch.ops import features as F
    from linemod_pose_estimation_tpu_torch.ops import match as M
    from linemod_pose_estimation_tpu_torch.utils import scenes as S

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.library()
    emit("build", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         build_s=time.perf_counter() - t0, nvcc_s=_build.last_build_seconds)
    perf = {k: {} for k in KERNELS}

    # -- phase 1: K1, K2 vs plain at the main path's shapes ------------------
    rgbs_np, deps_np, truths = S.bin_picking_batch(B_MAIN, seed=3)
    rgbs = torch.from_numpy(rgbs_np).to(dev)
    deps = torch.from_numpy(deps_np).to(dev)
    noise = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, size=rgbs_np.shape, dtype=np.uint8)).to(dev)
    level1 = lambda x: torch.stack(
        [F.pyr_down(x[..., c].float()) for c in range(3)], -1).contiguous()
    rgb1 = level1(rgbs)
    for name, x in (("level0_u8_480x640", rgbs), ("level1_f32_240x320", rgb1),
                    ("noise_level0", noise), ("noise_level1", level1(noise))):
        q = CP.quantize_color_gradient(x, 10.0)
        err = max_abs_err(q, CP.quantize_color_gradient_plain(x, 10.0))
        require(err == 0, f"K1 {name} differs from its plain version")
        perf["quantize_cg"][name] = dict(max_abs_err=err,
                                         set_frac=float((q > 0).float().mean()))
        if not name.startswith("noise"):  # time the scene batch
            perf["quantize_cg"][name].update(
                ms=cuda_ms(lambda: CP.quantize_color_gradient(x, 10.0), 20),
                plain_ms=cuda_ms(lambda: CP.quantize_color_gradient_plain(x, 10.0), 3))
    q0 = CP.quantize_color_gradient(rgbs, 10.0)
    q1 = CP.quantize_color_gradient(rgb1, 10.0)
    n0 = F.quantize_depth_normal(deps)
    for name, q, T in (("grad_T5_480x640", q0, 5), ("grad_T8_240x320", q1, 8),
                       ("norm_T5_480x640", n0, 5),
                       ("norm_T8_240x320", n0[:, ::2, ::2].contiguous(), 8)):
        got, ref = CK.spread_response(q, T), CK.spread_response_plain(q, T)
        err = max_abs_err(got, ref)
        require(err == 0, f"K2 {name} differs from its plain version")
        perf["spread_response"][name] = dict(
            ms=cuda_ms(lambda: CK.spread_response(q, T), 20),
            plain_ms=cuda_ms(lambda: CK.spread_response_plain(q, T), 3),
            max_abs_err=err)
    emit("kernels_vs_plain", K1=perf["quantize_cg"], K2=perf["spread_response"])

    # -- phase 2a: untiled bank, golden batch vs the JAX reference -----------
    det = Detector.read(BANK)
    cid = det.class_ids[0]
    with np.load(GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    g_rgbs, g_deps, _ = S.golden_batch(int(gold["seed"]))
    gB = g_rgbs.shape[0]
    gm = BatchedMatcher(det, cid, float(gold["threshold"]), gB, device=dev,
                        **slice_settings(gB))
    R0, cands, n_valid = gm.candidates(g_rgbs, g_deps)
    got = gm.refine(R0, cands, n_valid)
    R0g, R1g = M.preprocess_frames_batched(
        torch.from_numpy(g_rgbs).to(dev), torch.from_numpy(g_deps).to(dev),
        use_depth=True)
    require(torch.equal(R0g, R0), "preprocess is not deterministic")
    for b in range(gB):
        for R, key in ((R0g, "r0_sha256"), (R1g, "r1_sha256")):
            h = hashlib.sha256(R[b].cpu().numpy().tobytes()).hexdigest()
            require(h == str(gold[key][b]), f"{key} of frame {b} differs from the reference")
    for name in got._fields:
        require(np.array_equal(getattr(got, name).cpu().numpy(), gold[name]),
                f"golden Matches.{name} differs from the reference")
    require(np.array_equal(n_valid.cpu().numpy(), gold["n_valid"]), "golden n_valid differs")
    for name in gm.last_pool._fields:
        require(np.array_equal(getattr(gm.last_pool, name).cpu().numpy(),
                               gold["stats_" + name]), f"golden PooledStats.{name} differs")
    emit("golden_vs_reference", frames=gB, templates=det.bank(cid).num_templates,
         equal=True, n_valid=n_valid.tolist(), valid_matches=int(got.valid.sum()),
         fallback=bool(gm.last_pool.fallback))

    # -- phase 2b: B=32 over the tiled bank, kernels vs plain ---------------
    bank = det.bank(cid)
    reps = -(-10240 // bank.num_templates)
    det.attach_bank(bank.tile(reps, TILE_TO))
    kw = slice_settings(B_MAIN)
    t0 = time.perf_counter()
    main_m = BatchedMatcher(det, cid, THRESHOLD, B_MAIN, device=dev, **kw)
    plain_m = BatchedMatcher(det, cid, THRESHOLD, B_MAIN, device=dev, plain=True, **kw)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    main_m.match_batch(rgbs, deps)  # warm-up (cuBLASLt heuristics, caches)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    m_kern = main_m.match_batch(rgbs, deps)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    for k, n in launches.items():
        require(n > 0, f"kernel {k} was not launched on the main path")
    stats = main_m.last_pool
    require(not bool(stats.fallback), "the main-path batch fell back; it must "
            "exercise the pooled branch")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        main_m.match_batch(rgbs, deps)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    m_plain = plain_m.match_batch(rgbs, deps)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    require(matches_equal(m_kern, m_plain), "tiled batch: kernel path != plain path")
    found, total = S.found_rate(m_kern.valid.cpu(), m_kern.x.cpu(), m_kern.y.cpu(), truths)
    emit("tiled_batch", batch=B_MAIN, templates=det.bank(cid).num_templates,
         equal_kernel_vs_plain=True, launches=launches,
         stats={k: v.tolist() for k, v in stats._asdict().items()},
         found=f"{found}/{total}", valid_matches=int(m_kern.valid.sum()),
         batch_ms=batch_s * 1e3, batch_ms_repeats=[t * 1e3 for t in times],
         plain_batch_ms=plain_s * 1e3, setup_s=setup_s,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)

    # -- phase 2c: forced exhaustive fallback --------------------------------
    # Exactness holds for the VALID candidates and matches; the
    # sub-threshold filler slots come from different score sets.
    fb = BatchedMatcher(det, cid, THRESHOLD, B_MAIN, device=dev,
                        **{**kw, "pool_coarse": 8})
    t0 = time.perf_counter()
    R0, c_fb, nv_fb = fb.candidates(rgbs, deps)
    m_fb = fb.refine(R0, c_fb, nv_fb)
    torch.cuda.synchronize()
    fb_s = time.perf_counter() - t0
    require(bool(fb.last_pool.fallback), "forced tiny pool did not fall back")
    _, c_pool, nv_pool = main_m.candidates(rgbs, deps)
    require(torch.equal(nv_fb, nv_pool), "fallback n_valid != pooled n_valid")
    require(valid_equal(c_fb, c_pool), "fallback candidates != pooled candidates")
    require(valid_equal(m_fb, m_kern), "fallback matches != pooled matches")
    emit("forced_fallback", fallback=True, equal_valid_candidates=True,
         n_valid=nv_fb.tolist(), equal_valid_matches=True, batch_ms=fb_s * 1e3)

    # -- phase 3: K3 vs plain on the tiled batch's candidate sets ------------
    R0, cands, n_valid = main_m.candidates(rgbs, deps)
    for name, nv in (("valid_prefix", n_valid),
                     ("all_slots", torch.full_like(n_valid, cands.valid.shape[1]))):
        plan = M.walk_plan(R0.shape, main_m.feats0, cands, main_m.T1, main_m.E0,
                           main_m.T0, n_valid=nv)
        ops = plan.operands()
        got = CK.walk_scores(R0, *ops, main_m.T0)
        ref = CK.walk_scores_plain(R0, *ops, main_m.T0)
        err = max_abs_err(got, ref)
        require(err == 0, f"K3 {name} differs from its plain version")
        perf["walk_scores"][name] = dict(
            ms=cuda_ms(lambda: CK.walk_scores(R0, *ops, main_m.T0), 20),
            plain_ms=cuda_ms(lambda: CK.walk_scores_plain(R0, *ops, main_m.T0), 3),
            max_abs_err=err, slots_walked=int(plan.n_valid.sum()))
    emit("walk_vs_plain", K3=perf["walk_scores"])

    # -- summary -------------------------------------------------------------
    summary = []
    for key, (name, src, replaces) in KERNELS.items():
        shapes = perf[key]
        main_shapes = [s for s, v in shapes.items() if "ms" in v and s != "all_slots"]
        summary.append(dict(
            name=f"{name} {key}", route="cuda", source=src, replaces=replaces,
            launches=launches[key],
            max_abs_err=max(v["max_abs_err"] for v in shapes.values()),
            ms=sum(shapes[s]["ms"] for s in main_shapes),
            plain_ms=sum(shapes[s]["plain_ms"] for s in main_shapes),
            shapes=shapes))
    print(json.dumps({"kernels": summary}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
