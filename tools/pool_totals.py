"""The pooled matcher's survivor totals on a benchmark cell's own traffic, on
the card: how large the coarse and fine pools must be, and what a batch
costs at given pool sizes.

For each seed the cell is set up as the benchmark sets it up (its driver,
its scenes), with pools and select ranges that hold every level-1 position,
and each of its batches is matched once: the line gives per batch the true
coarse and fine totals and the largest per-frame counts.  Then, on the
first seed, each `--pools C/F[/S]` (slots a frame, and select rows;
`exhaustive` forces the fallback) is timed over the pool's batches by CUDA
events.

    python tools/pool_totals.py --workload ensenso-rgb-b32 --seeds 1,2,3 \
        [--pools 56/36,96/64,exhaustive] [--rounds 5]

prints one JSON line a seed, then one a pool setting.  The driver builds
its matcher from `serving.slice_settings` (the `batch` and `ensenso`
drivers) or from the configuration's `matcher` settings (the `twoclass`
driver); the tool overrides either.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--pools", default="")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    import torch

    from benchmark.run import load_cell
    from linemod_pose_estimation_tpu_torch.models import serving

    _, _, config, traffic = load_cell(args.workload)
    driver = importlib.import_module(f"benchmark.harness.{traffic['driver']}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    production = serving.slice_settings
    override: dict = {}

    def settings(batch, *a, **k):
        return {**production(batch, *a, **k), **override}

    def configured(B):
        """The configuration with the override's pools in its `matcher`
        settings (slots a frame), for a driver that reads them there."""
        if "matcher" not in config:
            return config
        mk = dict(config["matcher"])
        for key, name, per in (("pool_coarse", "pool_coarse_per_frame", B),
                               ("pool_fine", "pool_fine_per_frame", B),
                               ("sel_row_cap", "sel_row_cap", 1)):
            if key in override:
                mk[name] = max(1, override[key] // per)
        return {**config, "matcher": mk}

    serving.slice_settings = settings
    seeds = [int(s) for s in args.seeds.split(",")]
    first = None
    for seed in seeds:
        # Every level-1 position of the batch fits each pool and select range.
        B = int(traffic["batch"])
        P = production(B)["pool_group"] // B
        override.update(pool_coarse=B * P, pool_fine=B * P, sel_row_cap=P)
        torch.cuda.reset_peak_memory_stats(dev)
        run = driver.Cell(configured(B), traffic, seed, dev)
        rows = []
        for _ in range(len(run.batches)):
            run.step()
            st = run.matcher.last_pool
            host = {k: v.tolist() for k, v in st._asdict().items()}
            rows.append({"coarse_total": host["coarse_total"], "fine_total": host["fine_total"],
                         "coarse_m_max": max(host["coarse_m"]),
                         "fine_m_max": max(host["fine_m"]), "fallback": host["fallback"]})
        matched = sum(bool(m) for _, m in run.answers())
        print(json.dumps({"seed": seed, "batch": B, "positions_per_frame": P,
                          "batches": rows, "frames_matched": matched,
                          "frames": len(run.answers()),
                          "peak_bytes": torch.cuda.max_memory_allocated(dev)}), flush=True)
        if first is None:
            first = (seed, B)
        run.free()
        del run
        torch.cuda.empty_cache()

    for spec in filter(None, args.pools.split(",")):
        seed, B = first
        override.clear()
        if spec == "exhaustive":
            override.update(pool_coarse=8)
        else:
            c, f, *sel = (int(v) for v in spec.split("/"))
            override.update(pool_coarse=c * B, pool_fine=f * B)
            if sel:
                override.update(sel_row_cap=sel[0])
        run = driver.Cell(configured(B), traffic, seed, dev)
        ms, falls = [], 0
        for _ in range(args.rounds):
            for _ in range(len(run.batches)):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                run.step()
                b.record()
                b.synchronize()
                ms.append(a.elapsed_time(b))
                falls += bool(run.matcher.last_pool.fallback)
        ms.sort()
        print(json.dumps({"pools": spec, "seed": seed, "batches": len(ms),
                          "fallbacks": falls, "ms_median": ms[len(ms) // 2],
                          "ms_min": ms[0], "ms_max": ms[-1],
                          "gpu": torch.cuda.get_device_name(dev)}), flush=True)
        run.free()
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
