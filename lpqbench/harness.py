"""One run of one cell: set-up, the measured window, the judge, the line.

    set-up   draw the corpus and the query pool on the device from the
             seed; build the index and plan one Searcher (``system``);
             drop the harness's corpus; read what the index holds; warm the
             buckets this cell's traffic hits, and nothing else
    window   drive ``Searcher.__call__`` with the cell's traffic for
             ``seconds`` (``loadgen``): an open loop sends each request
             when it is due and times it from then to its answer (a CUDA
             event, read against one recorded as the window opened); a
             closed loop sends the next request once the last is answered
    judge    once the window has closed and its peak memory has been read:
             the answers of a seeded sample of the requests, against the
             plain reference (``reference.judge``), after the program's
             index is freed

``BENCHMARK.json`` says which end-to-end and per-layer metrics a cell
reports; a cell's parameters live in ``workloads/<cell>.json``, its
configuration in ``configs/<config>.json``, its mix in
``traffic/<mix>.json``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from lpqbench import data, endtoend, loadgen, metrics, roofline
from lpqbench import trace as tracemod
from lpqbench.reference import judge as judgemod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(path: Optional[Path] = None) -> dict:
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict            # workloads/<cell>.json
    config: dict          # configs/<config>.json
    mix: dict             # traffic/<mix>.json
    end_to_end: list      # BENCHMARK.json end_to_end entries it reports
    per_layer: list       # BENCHMARK.json per_layer entries it reports


#: calls of each bucket the cell's traffic hits, before the window
WARM_CALLS = 3


def load_cell(bench: dict, name: str) -> Cell:
    """A cell of ``bench`` and its files, found by name."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    spec = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    for key in ("config", "traffic", "chips"):
        if spec[key] != entry[key]:
            raise ValueError(f"{name}: {key} is {spec[key]!r} in its file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    config = json.loads(
        (HERE / "configs" / f"{entry['config']}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if any("workloads" not in m for m in bench["per_layer"]):
        raise ValueError("every per_layer metric lists its workloads")
    layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name, spec, config, loadgen.load_mix(entry["traffic"]), e2e,
                layer)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _wait_until(t: float) -> None:
    while True:
        dt = t - time.perf_counter()
        if dt <= 0:
            return
        if dt > 3e-4:
            time.sleep(dt - 2e-4)


def setup(cell: Cell, seed: int, dev, make_system: Callable, log,
          warm: bool = True) -> dict:
    """Corpus, pool, the built system and what it holds, warmed."""
    cfg = cell.config
    t_draw = time.perf_counter()
    draw = data.sampler(cfg, seed, dev)
    n, d = int(cfg["rows"]), int(cfg["dim"])
    corpus = data.fill(draw, n, d, seed, "corpus", dev)
    pool = data.fill(draw, int(cfg["queries"]), d, seed, "queries", dev)
    _sync(dev)
    t = time.perf_counter()
    system = make_system(cfg, corpus, dev)
    del corpus
    _sync(dev)
    t_warm = time.perf_counter()
    index_bytes = None
    if dev.type == "cuda":
        index_bytes = (torch.cuda.memory_allocated(dev)
                       - pool.numel() * pool.element_size())
        log(f"[setup] index {index_bytes} bytes, set-up peak "
            f"{torch.cuda.max_memory_allocated(dev)} bytes")
    for size in cell.mix["sizes"] if warm else ():   # the buckets it hits
        for _ in range(WARM_CALLS):
            system(pool[:size])
    _sync(dev)
    log(f"[setup] draw {t - t_draw:.3f} s (the CUDA start with it), build "
        f"{t_warm - t:.3f} s, warm {time.perf_counter() - t_warm:.3f} s")
    return {"system": system, "pool": pool, "index_bytes": index_bytes}


def run_window(cell: Cell, st: dict, seconds: float, seed: int, dev,
               trace: Optional[tracemod.DeviceTrace] = None) -> dict:
    """Drive the system with the cell's traffic for ``seconds``."""
    system, pool = st["system"], st["pool"]
    cuda = dev.type == "cuda"
    open_loop = cell.mix["loop"] == "open"
    if open_loop:
        reqs = loadgen.open_schedule(cell.mix, float(cell.spec["rate"]),
                                     seconds, pool.shape[0], seed)
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) if cuda else None
                  for _ in reqs]
    else:
        stream = loadgen.closed_requests(cell.mix, pool.shape[0], seed)
    opened = torch.cuda.Event(enable_timing=True) if cuda else None
    spans, recs, answers, failed = [], [], {}, 0
    gc.collect()           # no collector pause inside the window
    gc.freeze()
    gc.disable()
    _sync(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    if trace is not None:
        trace.mark(t0)
    if cuda:
        opened.record()

    if open_loop:
        for r, ev in zip(reqs, events):
            t_wait = time.perf_counter()
            _wait_until(t0 + r.due)
            t_send = time.perf_counter()
            if cuda:
                ev[0].record()
            try:
                answers[r.index] = system(pool[r.offset:r.offset + r.size])
            except (RuntimeError, ValueError) as exc:
                failed += 1
                print(f"[window] request {r.index} failed: {exc}",
                      file=sys.stderr)
                continue
            t_ret = time.perf_counter()
            if cuda:
                ev[1].record()
            spans += [("wait_arrival", t_wait, t_send),
                      ("searcher_call", t_send, t_ret)]
            recs.append({"index": r.index, "size": r.size, "offset": r.offset,
                         "due": t0 + r.due, "send_lag_s": t_send - t0 - r.due,
                         "host_call_s": t_ret - t_send, "done": t_ret,
                         "event": ev})
        _sync(dev)
        for rec in recs:
            ev = rec.pop("event")
            if cuda:
                rec["done"] = t0 + opened.elapsed_time(ev[1]) * 1e-3
                rec["device_s"] = ev[0].elapsed_time(ev[1]) * 1e-3
            rec["latency_s"] = rec["done"] - rec.pop("due")
    else:
        while time.perf_counter() - t0 < seconds:
            r = next(stream)
            t_send = time.perf_counter()
            try:
                answers[r.index] = system(pool[r.offset:r.offset + r.size])
            except (RuntimeError, ValueError) as exc:
                failed += 1
                print(f"[window] request {r.index} failed: {exc}",
                      file=sys.stderr)
                continue
            t_ret = time.perf_counter()
            _sync(dev)
            t_done = time.perf_counter()
            spans += [("searcher_call", t_send, t_ret),
                      ("sync_wait", t_ret, t_done)]
            recs.append({"index": r.index, "size": r.size, "offset": r.offset,
                         "host_call_s": t_ret - t_send, "done": t_done,
                         "latency_s": t_done - t_send})
    t_end = max([rec["done"] for rec in recs], default=time.perf_counter())
    gc.enable()
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if trace is not None:
        trace.mark(time.perf_counter())
    return {"requests": recs, "answers": answers, "failed": failed,
            "attempted": len(recs) + failed, "t0": t0, "t_end": t_end,
            "window_s": t_end - t0, "peak_bytes": peak, "spans": spans,
            "loop": cell.mix["loop"]}


def sample(cell: Cell, done: list[int], seed: int) -> list[int]:
    """The requests the judge checks: a seeded draw among those answered."""
    m = min(int(cell.spec["check"]["requests"]), len(done))
    rng = np.random.default_rng(data.derive_seed(seed, "check"))
    return sorted(rng.choice(done, size=m, replace=False).tolist()) if m else []


def judge(cell: Cell, st: dict, window: dict, seed: int, dev) -> dict:
    """The judge's numbers for the sampled requests (the system's index is
    released first; the harness keeps only its pool and the answers)."""
    picked = sample(cell, sorted(window["answers"]), seed)
    by_index = {r["index"]: r for r in window["requests"]}
    answers = [window["answers"][i] for i in picked]
    q = [st["pool"][by_index[i]["offset"]:by_index[i]["offset"]
                    + by_index[i]["size"]] for i in picked]
    window["answers"].clear()
    state = st.pop("system")
    state.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if not picked:
        return {"requests_checked": 0}
    nums = judgemod.judge(cell.config, seed, dev, torch.cat(q),
                          torch.cat([a[0] for a in answers]),
                          torch.cat([a[1] for a in answers]), state)
    nums["requests_checked"] = len(picked)
    nums["queries_checked"] = sum(x.shape[0] for x in q)
    return nums


def verdict(cell: Cell, nums: dict, window: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit, and whether all hold."""
    limits = cell.spec["check"]["limits"]
    checks = {name: {"value": float(nums.get(name, judgemod.BIG)),
                     "limit": float(lim)} for name, lim in limits.items()}
    ok = (window["failed"] == 0 and nums.get("requests_checked", 0) > 0
          and all(c["value"] <= c["limit"] for c in checks.values()))
    return ok, checks


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, dev,
             make_system: Callable, t_start: float, log) -> dict:
    """One whole run; returns the result line's object."""
    st = setup(cell, seed, dev, make_system, log)
    tr = None
    if traced:
        tr = tracemod.DeviceTrace()
        tr.start()
    window = run_window(cell, st, seconds, seed, dev, tr)
    window["setup_s"] = window["t0"] - t_start
    if tr is not None:
        tr.stop()
    reduced = None
    if tr is not None:
        reduced = tracemod.reduce(tr.events(), window["spans"], window["t0"],
                                  window["t_end"])
        if reduced is None:
            raise RuntimeError("the trace holds no device op in the window")
        log(f"[trace] busy {reduced['busy_s']:.6f} s of "
            f"{reduced['window_s']:.6f} s, {reduced['kernels']} kernels")
    log(f"[window] {len(window['requests'])} requests, "
        f"{window['failed']} failed, {window['window_s']:.3f} s, "
        f"peak {window['peak_bytes']} bytes")
    reqs = window["requests"]
    if reqs and "device_s" in reqs[0]:
        dev_ms = [r["device_s"] * 1e3 for r in reqs]
        lat_ms = [r["latency_s"] * 1e3 for r in reqs]
        log(f"[window] a request on the card: median "
            f"{np.median(dev_ms):.4f} ms, mean {np.mean(dev_ms):.4f} ms; "
            f"latency median {np.median(lat_ms):.4f} ms")
    nums = judge(cell, st, window, seed, dev)
    log("[judge] " + json.dumps(nums))
    ok, checks = verdict(cell, nums, window)

    out = {"correct": ok, "attempted": window["attempted"],
           "failed": window["failed"], "metrics": {}}
    if not traced:
        for m in cell.end_to_end:
            out["metrics"][m["name"]] = {
                "value": endtoend.read(m["name"], window), "unit": m["unit"]}
    else:
        ctx = {"config": cell.config, "window": window, "trace": reduced,
               "memory": {"index_bytes": st["index_bytes"]}}
        for m in cell.per_layer:
            v = metrics.reader(m["name"])(ctx)
            if v is not None:
                out["metrics"][m["name"]] = {"value": float(v),
                                             "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": 1, "memory_peak_bytes": int(window["peak_bytes"]),
              "power_limit_w": (roofline.power_limit_w()
                                if dev.type == "cuda" else None)}
    if reduced is not None:
        device.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
        out["breakdown"] = {"device_ops": reduced["device_ops"],
                            "idle_gaps": reduced["idle_gaps"]}
    out["device"] = device
    out["checks"] = checks
    return out
