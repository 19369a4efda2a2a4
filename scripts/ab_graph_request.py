"""Serve the SIFT-like 1,000,000 x 128 graph arms of ``chip_smoke.py``
phase 8(c) (``graph24,lpq8@global_minmax`` and ``graph24``, l2, k=100,
ef_search 300) on one GPU, from the ``repro_torch`` package under a given
``src`` directory, and print one JSON line per arm: the p50 and QPS of
twelve 256-query requests (the 1,000 queries three times), the walk's
loop steps a request and the build seconds.

    python scripts/ab_graph_request.py <src dir>

To compare two checkouts, run them in turns on one card: parent, change,
change, parent.
"""

import json
import statistics
import sys
import time

sys.path.insert(0, sys.argv[1])

import torch  # noqa: E402

import repro_torch  # noqa: E402,F401  (TF32 off)
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.knn import SearchParams, make_index  # noqa: E402
from repro_torch.knn import graph as G  # noqa: E402

ARMS = ("graph24,lpq8@global_minmax", "graph24")


def main():
    corpus, queries, metric = synthetic.load("sift", 1_000_000, 1000)
    for f in ARMS:
        t = time.perf_counter()
        idx = make_index(f, corpus, metric=metric)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        s = idx.searcher(100, SearchParams(ef_search=300),
                         batch_sizes=(1, 8, 32, 256))
        for b in (1, 8, 32, 256):
            s(queries[:b])
        torch.cuda.synchronize()
        G.reset_steps()
        lat, t0 = [], time.perf_counter()
        for _ in range(3):
            for st in range(0, 1000, 256):
                t = time.perf_counter()
                s(queries[st:st + 256])
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t) * 1e3)
        total = time.perf_counter() - t0
        print(json.dumps({"src": sys.argv[1], "arm": f,
                          "p50_ms": statistics.median(lat),
                          "min_ms": min(lat), "max_ms": max(lat),
                          "qps": 3000 / total,
                          "steps_a_request": G.STEPS["beam"] / len(lat),
                          "build_s": build_s}), flush=True)
        del idx, s
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
