"""A whole run but the look for a card, at a size the CPU holds: the last
line's shape, the control coming out not ``correct``, the timed path
broken underneath coming out not ``correct``; and, on a machine with a
card, each cell for 2 s through the command itself."""

import json
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT, SEED
from lpqbench import control, harness
from lpqbench.system import Program

CPU = torch.device("cpu")


def _run(cell, seconds=0.5, seed=SEED):
    return harness.run_cell(cell, seed, seconds, False, CPU, Program,
                            time.perf_counter(), lambda m: None)


def test_last_line_schema_and_sound_run(tiny_cell):
    out = _run(tiny_cell)
    line = json.loads(json.dumps(out))
    assert list(line)[:4] == ["correct", "attempted", "failed", "metrics"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    want = {m["name"]: m["unit"] for m in tiny_cell.end_to_end}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == want
    assert all(isinstance(v["value"], float) for v in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == set(tiny_cell.spec["check"]["limits"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_control_is_not_correct(tiny_cell):
    out = control.control_run(tiny_cell, SEED, 1.0, CPU, lambda m: None)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def _alter_answer(orig):
    """The engine's answer with one slot of one query changed where it is
    produced: the best row of query 0 replaced by another row."""
    def wrapped(*a, **kw):
        s, i, *rest = orig(*a, **kw)
        i = i.clone()
        i[0, 0] = (i[0, 0] + 997) % 6000
        return (s, i, *rest)
    return wrapped


def _half_batch(orig):
    """Half of the batch left out: the engine answers the first half of
    the queries (every per-query argument cut alike) and its answers stand
    in for the rest."""
    def wrapped(q, *a, **kw):
        n, half = q.shape[0], max(1, q.shape[0] // 2)
        a = [x[:half] if torch.is_tensor(x) and x.shape[:1] == (n,) else x
             for x in a]
        s, i, *rest = orig(q[:half], *a, **kw)
        reps = -(-n // half)
        return (s.repeat(reps, 1)[:n], i.repeat(reps, 1)[:n], *rest)
    return wrapped


@pytest.mark.parametrize("fault", ["altered_answer", "half_batch"])
def test_broken_timed_path_is_not_correct(tiny_cell, fault, monkeypatch):
    from repro_torch import engine

    target = "rerank_among" if tiny_cell.config.get("rerank") else "topk"
    wrap = _alter_answer if fault == "altered_answer" else _half_batch
    monkeypatch.setattr(engine, target, wrap(getattr(engine, target)))
    out = _run(tiny_cell)
    assert out["correct"] is False, out["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["bigann31m.online", "t2i10m.batch256"])
def test_each_cell_two_seconds_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cells run on the card only")
    proc = subprocess.run(
        [sys.executable, "lpqbench/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
