"""Every file the benchmark is driven by parses and names what exists;
BENCHMARK.json keeps to the benchmark contract's shape; a cell and a
metric added as new files only are picked up."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT
from lpqbench import endtoend, harness, loadgen, metrics

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_json_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"][0] == "python3" and len(bench["command"]) <= 32
    assert bench["paths"] == ["lpqbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    cells = [w["name"] for w in bench["workloads"]]
    mets = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for group in (names, cells, mets):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("lpqbench/") and (ROOT / c["file"]).is_file()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for cell in m["workloads"]:
            assert cell in cells
            moved = next(e for e in bench["end_to_end"]
                         if e["name"] == m["moves"])
            assert cell in moved.get("workloads", cells)
        if m["name"].split(".")[0].endswith("roofline"):
            assert m["unit"] == "%"
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_cell_loads_and_names_what_exists(bench):
    for w in bench["workloads"]:
        cell = harness.load_cell(bench, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.mix == loadgen.load_mix(w["traffic"])
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.end_to_end:
            assert endtoend.UNITS[m["name"]] == m["unit"]
        for m in cell.per_layer:
            assert callable(metrics.reader(m["name"]))
        assert cell.spec["check"]["limits"]
        assert (ROOT / "lpqbench" / "data"
                / f"{cell.config['data']['generator']}.py").is_file()


def test_configs_match_their_factory_strings(bench):
    """The reference reads a configuration's explicit fields; the program
    its factory string: they state the same index."""
    from repro_torch.knn.spec import parse_factory

    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        spec = parse_factory(cfg["factory"], metric=cfg["metric"])
        assert spec.kind == "flat" and spec.metric == cfg["metric"]
        assert spec.quant.bits == cfg["quant"]["bits"]
        assert spec.quant.scheme == cfg["quant"]["scheme"]
        assert spec.quant.sigmas == cfg["quant"].get("sigmas", 1.0)
        rr = cfg.get("rerank")
        assert spec.rerank_bits == (rr["bits"] if rr else None)
        if rr:
            assert rr["depth"] == 4 * cfg["k"]     # the Searcher's default


def test_traffic_mixes_are_data(bench, tmp_path, monkeypatch):
    for w in bench["workloads"]:
        assert (ROOT / "lpqbench" / "traffic" / f"{w['traffic']}.json").is_file()
    monkeypatch.setattr(loadgen, "TRAFFIC", tmp_path)
    (tmp_path / "bad.json").write_text(json.dumps({"loop": "sideways",
                                                   "sizes": [1]}))
    with pytest.raises(ValueError):
        loadgen.load_mix("bad")


DRIVER = """
import json, sys, time
sys.path[:0] = [{copy!r}, {src!r}]
import torch
from lpqbench import harness
from lpqbench.system import Program
bench = harness.load_benchmark()
cell = harness.load_cell(bench, "dummy.cell")
cell.config["rows"], cell.config["queries"] = 3000, 300
out = harness.run_cell(cell, 7, 0.5, False, torch.device("cpu"), Program,
                       time.perf_counter(), lambda m: None)
ctx = {{"config": cell.config, "window": {{"requests": []}}, "trace": None,
        "memory": {{}}}}
print(json.dumps({{"e2e": sorted(out["metrics"]), "correct": out["correct"],
                  "per_layer": [m["name"] for m in cell.per_layer],
                  "dummy": harness.metrics.reader("dummy_metric")(ctx)}}))
"""


def test_new_cell_and_metric_as_files_only(tmp_path):
    """A later change adds a cell (a workload file, a BENCHMARK.json
    entry) and a per-layer metric (a reader file) and edits no file."""
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "lpqbench", copy / "lpqbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dummy.cell", "config": "bigann-31m",
                               "traffic": "batch256", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "dummy_metric", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "Searcher", "moves": "p95_ms",
                               "workloads": ["dummy.cell"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = json.loads((ROOT / "lpqbench/workloads/bigann31m.online.json")
                      .read_text())
    spec.update(traffic="batch256", check={"requests": 2,
                                           "limits": {"rank_gap": 0.0}})
    spec.pop("rate")
    (copy / "lpqbench/workloads/dummy.cell.json").write_text(json.dumps(spec))
    (copy / "lpqbench/metrics/dummy_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    proc = subprocess.run(
        [sys.executable, "-c",
         DRIVER.format(copy=str(copy), src=str(ROOT / "src"))],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    assert got["e2e"] == ["p95_ms", "peak_mem_gib", "setup_s"]
    assert "dummy_metric" in got["per_layer"] and got["dummy"] == 42.0
