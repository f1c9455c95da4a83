"""The readings that a cell's limits are set from, on the card, in one
process: for each seed, the program's answers over `--steps` steps at the
cell's own load against the reference's (the lower reading), and with
`--control` also the control's (the reference computed in the next lower
precision, put in the program's place) against the reference (the upper
reading).  Not run by the benchmark's runs.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --steps 3 [--control 1]

prints one JSON line per seed: {"seed", "program": {number: value},
"control": {number: value}}.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(BENCH))

from benchmark.run import load_cell  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--control", type=int, default=1)
    args = ap.parse_args()
    _, cell, config, traffic = load_cell(args.workload)
    import torch

    import linemod_pose_estimation_tpu_torch  # noqa: F401

    driver = importlib.import_module(f"benchmark.harness.{traffic['driver']}")
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        run = driver.Cell(config, traffic, seed, dev)
        for _ in range(args.steps):
            run.step()
        answers = run.answers()
        run.free()
        torch.cuda.empty_cache()
        keys = {i for i, _ in answers}
        t0 = time.perf_counter()
        want = run.reference(keys)
        ref_s = time.perf_counter() - t0
        out = {"seed": seed, "answers": len(answers), "reference_s": ref_s,
               "program": {k: v["value"] for k, v in run.compare(answers, want).items()}}
        if args.control:
            low = run.reference(keys, lower=True)
            ctrl = [(i, low[i]) for i in sorted(keys)]
            out["control"] = {k: v["value"] for k, v in run.compare(ctrl, want).items()}
        print(json.dumps(out), flush=True)
        del run
    return 0


if __name__ == "__main__":
    sys.exit(main())
