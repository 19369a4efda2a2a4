"""Recall of the JAX reference's cascade and regions arms at n=20000, 128
queries.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/cascade_reference_recall.py

Prints, over three seeds (seed s draws the data from ``PRNGKey(100 + s)``
and every k-means init and HNSW level from ``PRNGKey(s)``), the
reference's recall against its own fp32 ``flat`` arm for:

* product-like rows (ip), recall@10 (``benchmarks/bench_cascade.py``'s
  arms and budgets, its ``kmeans_iters=4``): ``cascade(pq16x4|lpq8|r32)``
  at budgets (768, 96) and ``cascade(flat,lpq4|r32)`` at (64,);
* SIFT-like rows (l2), recall@100: ``ivf128,lpq8@global_minmax,regions``
  at nprobe 8 and 32 and ``graph24,lpq8@global_minmax,regions`` at
  ef_search 300;
* product-like rows, recall@100: ``hnsw32,lpq8@gaussian:3,regions`` at
  ef_search 300, built with ``ef_construction=300``, ``batch_size=256``;

then each (arm, knob)'s mean and spread (max - min).  ``chip_smoke.py``
phase 10(b) holds the PyTorch port, whose data and draws come from
``torch.Generator``, to the mean within max(0.02, spread)
(``REF_CASCADE``).
"""

from __future__ import annotations

import argparse
import time

import jax

from repro.core.preserve import recall_at_k
from repro.data import synthetic
from repro.knn import SearchParams, make_index

#: (dataset, factory, k, build overrides, [(knob label, SearchParams kw)])
ARMS = (
    ("product", "cascade(pq16x4|lpq8|r32)", 10, {"kmeans_iters": 4},
     [("budgets (768, 96)", {"budgets": (768, 96)})]),
    ("product", "cascade(flat,lpq4|r32)", 10, {},
     [("budgets (64,)", {"budgets": (64,)})]),
    ("sift", "ivf128,lpq8@global_minmax,regions", 100, {},
     [("nprobe 8", {"nprobe": 8}), ("nprobe 32", {"nprobe": 32})]),
    ("sift", "graph24,lpq8@global_minmax,regions", 100, {},
     [("ef_search 300", {"ef_search": 300})]),
    ("product", "hnsw32,lpq8@gaussian:3,regions", 100,
     {"ef_construction": 300, "batch_size": 256},
     [("ef_search 300", {"ef_search": 300})]),
)
SEEDS = (0, 1, 2)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--seeds", type=int, default=len(SEEDS))
    args = ap.parse_args()
    t_all = time.perf_counter()
    rec = {}
    for s in SEEDS[:args.seeds]:
        data = {}
        for name, f, k, over, knobs in ARMS:
            if name not in data:
                corpus, queries, metric = synthetic.load(
                    name, args.n, 128, key=jax.random.PRNGKey(100 + s))
                gt = make_index("flat", corpus, metric=metric).search(
                    queries, 100).ids
                data[name] = corpus, queries, metric, gt
            corpus, queries, metric, gt = data[name]
            t0 = time.perf_counter()
            idx = make_index(f, corpus, metric=metric,
                             key=jax.random.PRNGKey(s), **over)
            build_s = time.perf_counter() - t0
            for label, kw in knobs:
                ids = idx.search(queries, k, SearchParams(**kw)).ids
                r = float(recall_at_k(gt[:, :k], ids))
                rec.setdefault((name, f, label, k), []).append(r)
                print(f"{name} {args.n} {f} seed {s} {label}: recall@{k} "
                      f"{r:.4f} (build {build_s:.1f} s)", flush=True)
    for (name, f, label, k), rs in rec.items():
        print(f"{name} {args.n} {f} {label} recall@{k}: mean "
              f"{sum(rs) / len(rs):.4f} spread {max(rs) - min(rs):.4f} "
              f"({', '.join(f'{r:.4f}' for r in rs)})")
    print(f"{time.perf_counter() - t_all:.1f} s in all")


if __name__ == "__main__":
    main()
