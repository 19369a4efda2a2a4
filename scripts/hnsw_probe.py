"""Where an HNSW request's and build's time goes on the card.

    python scripts/hnsw_probe.py        # one NVIDIA GPU, about 7 minutes

On product-like 20,000 x 256 (ip, ef_construction 300, batch 256, 256
queries): for ``hnsw32,lpq8@gaussian:3`` and ``hnsw32``, the build's
seconds and walk steps, then one 256-query request at ef_search 300 and
800 (recall@100 against the fp32 flat arm, seconds by the host clock
after a synchronize, walk steps and per-query iterations from
``knn.graph.STEPS``, B1 launches), then one ef_search 300 request under
``torch.profiler``: device kernel records and host launch calls a step,
the card's busy time, and the ops a step by count.  Last, the int8 arm's
build at 100,000 x 256 (seconds, layers, walk steps).  Prints the card's
name and power limit first.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.core.preserve import recall_at_k  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.knn import SearchParams, make_index  # noqa: E402
from repro_torch.knn import graph as G  # noqa: E402

ARMS = ("hnsw32,lpq8@gaussian:3", "hnsw32")
BUILD = {"ef_construction": 300, "batch_size": 256}


def log(msg: str) -> None:
    print(msg, flush=True)


def request(searcher, queries):
    """One synchronized request: (result, seconds, walk steps, B1 launches)."""
    torch.cuda.synchronize()
    G.reset_steps()
    before = kernels.launch_counts()["quantize"]
    t0 = time.perf_counter()
    res = searcher(queries)
    torch.cuda.synchronize()
    return (res, time.perf_counter() - t0, dict(G.STEPS),
            kernels.launch_counts()["quantize"] - before)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("hnsw_probe: needs a CUDA device")
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip())
    corpus, queries, metric = synthetic.load("product", 20000, 256)
    gt = make_index("flat", corpus, metric=metric).search(queries, 100).ids
    for f in ARMS:
        G.reset_steps()
        t0 = time.perf_counter()
        idx = make_index(f, corpus, metric=metric, **BUILD)
        log(f"{f} 20000x256: build {time.perf_counter() - t0:.2f} s, "
            f"{len(idx.layers)} layers, walk steps {dict(G.STEPS)}")
        for ef in (300, 800):
            s = idx.searcher(100, SearchParams(ef_search=ef))
            request(s, queries)                                  # warm
            res, sec, steps, b1 = request(s, queries)
            log(f"{f} ef_search {ef}: recall@100 {recall_at_k(gt, res.ids):.4f}"
                f", 256-query request {sec:.4f} s, steps {steps}, "
                f"{sec / (steps['beam'] + steps['greedy']) * 1e3:.3f} ms a "
                f"step, {b1} B1 launches")
        s = idx.searcher(100, SearchParams(ef_search=300))
        _, sec, _, _ = request(s, queries)
        G.reset_steps()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            s(queries)
            torch.cuda.synchronize()
        n_steps = G.STEPS["beam"] + G.STEPS["greedy"]
        events = prof.events()
        device = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        launches = sum(1 for e in events if e.name.startswith("cudaLaunch"))
        busy = sum(e.self_device_time_total for e in device) / 1e3
        log(f"{f} ef_search 300 profiled: {len(device) / n_steps:.1f} device "
            f"records and {launches / n_steps:.1f} launch calls a step over "
            f"{n_steps} steps; device busy {busy:.1f} ms against {sec * 1e3:.1f}"
            f" ms for the same request unprofiled")
        ops = sorted(((e.count / n_steps, e.key) for e in prof.key_averages()
                      if e.key.startswith("aten::")), reverse=True)[:16]
        log("ops a step: " + ", ".join(f"{k} {c:.1f}" for c, k in ops))
        del idx
    corpus, queries, metric = synthetic.load("product", 100_000, 256)
    G.reset_steps()
    t0 = time.perf_counter()
    idx = make_index(ARMS[0], corpus, metric=metric, **BUILD)
    log(f"{ARMS[0]} 100000x256: build {time.perf_counter() - t0:.2f} s, "
        f"{len(idx.layers)} layers, walk steps {dict(G.STEPS)}")


if __name__ == "__main__":
    main()
