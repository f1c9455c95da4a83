"""BENCHMARK.json against the benchmark's contract, and the harness finding
a cell, a configuration, a mix and a metric by name alone."""

import json
import os
import re
import shutil

import pytest

from benchmark import run as R

ROOT = R.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert manifest["paths"] == ["benchmark"]
    assert 1 <= manifest["run_seconds"] <= 51
    # A full check of 24 cells fits its 43,200 s.
    rs = manifest["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_keys(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"} and 0 < m["bound"] <= 0.25
        names.append(m["name"])
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES
        names.append(m["name"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for text in [c["why"] for c in manifest["configs"] + manifest["workloads"]] + \
            [c["source"] for c in manifest["configs"]] + \
            [m["layer"] for m in manifest["per_layer"]] + manifest["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_cell_reports_what_it_must(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    cells = {w["name"] for w in manifest["workloads"]}
    configs = {c["name"] for c in manifest["configs"]}
    assert {w["config"] for w in manifest["workloads"]} == configs
    for w in manifest["workloads"]:
        mine = [m["name"] for m in R.metrics_of(manifest, w["name"], "end_to_end")]
        assert "setup_s" in mine and len(mine) >= 2
        layer = R.metrics_of(manifest, w["name"], "per_layer")
        assert layer
        for m in layer:  # each moves an end-to-end metric that the cell reports
            assert m["moves"] in mine
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    for m in manifest["per_layer"]:
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
        assert os.path.exists(os.path.join(R.BENCH, "metrics", f"{m['name']}.py"))


def test_every_cell_resolves(manifest):
    for w in manifest["workloads"]:
        _, cell, config, traffic = R.load_cell(w["name"])
        assert cell == w
        assert os.path.exists(os.path.join(R.BENCH, "harness", f"{traffic['driver']}.py"))
        assert os.path.exists(os.path.join(R.BENCH, config["templates"]))


def test_a_cell_and_a_metric_are_added_as_files(tmp_path, manifest):
    """A new cell is a BENCHMARK.json entry and a traffic file; a new
    per-layer metric is one reader file.  No harness file changes."""
    bench = tmp_path / "benchmark"
    shutil.copytree(os.path.join(R.BENCH, "configs"), bench / "configs")
    shutil.copytree(os.path.join(R.BENCH, "traffic"), bench / "traffic")
    (bench / "traffic" / "planted-b16.json").write_text(json.dumps(
        {"driver": "batch", "batch": 16, "pool": 32, "objects": 2, "views": 8,
         "threshold": 91.0, "trace_steps": 10}))
    new = dict(manifest)
    new["workloads"] = manifest["workloads"] + [
        {"name": "batch16-two", "config": "boxnew-rgbd-x4", "traffic": "planted-b16",
         "chips": 1, "why": "B=16, two objects a frame"}]
    new["per_layer"] = manifest["per_layer"] + [
        {"name": "busy_s.batch", "unit": "s", "better": "higher", "source": "device_trace",
         "layer": "device", "moves": "frames_per_s", "workloads": ["batch16-two"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    metrics = tmp_path / "metrics"
    metrics.mkdir()
    (metrics / "busy_s.batch.py").write_text("def read(ctx):\n    return ctx.trace.busy_s\n")

    _, cell, config, traffic = R.load_cell("batch16-two", root=str(tmp_path), bench=str(bench))
    assert (cell["config"], traffic["batch"], config["tile"]) == ("boxnew-rgbd-x4", 16, [4, 10624])
    assert [m["name"] for m in R.metrics_of(new, "batch16-two", "per_layer")] == ["busy_s.batch"]
    assert "batch16-two" in [w["name"] for w in new["workloads"]]

    class Ctx:
        class trace:
            busy_s = 1.5

    assert R.read_metric("busy_s.batch", Ctx(), str(metrics)) == 1.5
