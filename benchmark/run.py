"""The benchmark of the PyTorch/CUDA port, one cell per process:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's entry in BENCHMARK.json names its
configuration (`benchmark/configs/<config>.json`) and its traffic mix
(`benchmark/traffic/<traffic>.json`); the mix names the driver
(`benchmark/harness/<driver>.py`) that drives the program with it.  The run
sets up and warms up the cell (counted as `setup_s`), runs the closed loop
for `--seconds`, then checks what the window produced against the plain
reference (`benchmark/reference/`) and prints one JSON line: the cell's
end-to-end metrics with `--trace 0`, its per-layer metrics
(`benchmark/metrics/<metric>.py`, read from a torch.profiler trace of the
window's first `trace_steps` steps) with `--trace 1`.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "linemod_pose_estimation_tpu"}


def fail(msg: str, code: int = 2) -> None:
    print(f"benchmark: {msg}", file=sys.stderr)
    sys.exit(code)


def load_cell(name: str, root: str = ROOT, bench: str = BENCH) -> tuple[dict, dict, dict, dict]:
    """The manifest, the cell's entry, its configuration and its traffic
    mix, each found by name."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        fail(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    with open(os.path.join(bench, "configs", f"{cell['config']}.json")) as f:
        config = json.load(f)
    with open(os.path.join(bench, "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    return manifest, cell, config, traffic


def metrics_of(manifest: dict, cell: str, kind: str) -> list[dict]:
    """The cell's metrics of one kind: those that list it, or list no cell."""
    return [m for m in manifest[kind] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def read_metric(name: str, ctx, metrics_dir: str = os.path.join(BENCH, "metrics")
                ) -> float | None:
    """Run the metric's own reader, `<metrics_dir>/<name>.py`'s read(ctx)."""
    path = os.path.join(metrics_dir, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


class Context:
    """What a per-layer reader reads: the trace of the window's first
    steps, the launch records, the driver's counters, and how many steps
    and units of work the trace holds."""

    def __init__(self, trace, launches: dict, counters: dict, steps: int, units: int):
        self.trace, self.launches, self.counters = trace, launches, counters
        self.steps, self.units = steps, units


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest, cell, config, traffic = load_cell(args.workload)

    # Every cache the program or a library builds stays in the checkout.
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, ROOT)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        fail(f"the cell needs {cell['chips']} CUDA device(s); this host has "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", 3)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = execute(manifest, cell, config, traffic, args.seed, args.seconds, args.trace,
                     device)
    bad = forbidden_modules()
    if bad:
        fail(f"the run loaded {', '.join(bad)}", 4)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def execute(manifest: dict, cell: dict, config: dict, traffic: dict, seed: int,
            seconds: float, trace: int, device) -> dict:
    """One run of a cell on `device` after the look for a chip: set-up, the
    window, the reading of the metrics and the check; returns the result."""
    import torch

    import linemod_pose_estimation_tpu_torch  # noqa: F401  (TF32 off, as the port pins it)
    from benchmark.harness import spans
    from benchmark.harness import trace as TR

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    driver = importlib.import_module(f"benchmark.harness.{traffic['driver']}")
    run = driver.Cell(config, traffic, seed, device)
    sync()
    setup_s = time.perf_counter() - T_START

    # -- the measured window ---------------------------------------------------
    units = requests = traced = 0
    times_ms: list[float] = []
    capture, launches, traced_units = None, {}, 0
    patches = TR.Patches()
    try:
        if trace:
            run.trace_patches(patches, launches)
            with TR.Capture() as capture:
                # The window opens once the profiler runs (CUPTI's set-up
                # takes seconds); the trace is read after it closes.
                t0 = time.perf_counter()
                t_end = t0 + seconds
                while traced < int(traffic["trace_steps"]) and time.perf_counter() < t_end:
                    traced_units += run.step()
                    traced += 1
            patches.restore()
            units, requests = traced_units, traced
        else:
            t0 = time.perf_counter()
            t_end = t0 + seconds
        while True:
            now = time.perf_counter()
            if now >= t_end and requests > 0:
                break
            units += run.step()
            requests += 1
            times_ms.append((time.perf_counter() - now) * 1e3)
        sync()
    finally:
        patches.restore()
    elapsed = time.perf_counter() - t0

    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    metrics = {}
    if trace:
        reduced = capture.read()
        spans.k4_bounds(launches)
        ctx = Context(reduced, launches, run.counters(), traced, traced_units)
        for m in metrics_of(manifest, cell["name"], "per_layer"):
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = run.end_to_end(units, elapsed, times_ms)
        e2e["setup_s"] = setup_s
        for m in metrics_of(manifest, cell["name"], "end_to_end"):
            if m["name"] not in e2e:
                raise KeyError(f"the driver gives no {m['name']}")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    # -- correctness, once the program's state is freed --------------------------
    answers = run.answers()
    run.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    want = run.reference({i for i, _ in answers})
    checks = run.compare(answers, want)
    ok = lambda c: all(v["value"] <= v["limit"] for v in c.values())
    failed = sum(not ok(run.compare([a], want)) for a in answers)
    result = {"correct": ok(checks), "attempted": requests, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                         "count": int(cell["chips"]), "memory_peak_bytes": int(memory_peak)}}
    if cuda:
        result["device"]["power_limit"] = power_limit()
    if trace:
        result["device"].update(busy_s=reduced.busy_s, window_s=reduced.window_s)
        result["breakdown"] = reduced.breakdown()
    result["checks"] = checks
    return result


if __name__ == "__main__":
    sys.exit(main())
