"""Recall@100 of the JAX reference's Table 3 arms (the NGT-style graph
index) and two IVF arms at n=20000, 128 queries.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/graph_reference_recall.py

Prints, for ``benchmarks/table3_graph_recall.py``'s three arm pairs
(``graph24`` and ``graph24,<fragment>`` on SIFT-like l2, GloVe-like
angular and product-like ip data, each at its own width) at
``ef_search`` 300, and for ``ivf128,lpq8@global_minmax`` and ``ivf128`` on
the SIFT-like rows at ``nprobe`` 8 and 32, the reference's recall@100
against its own fp32 ``flat`` arm over three seeds (seed s draws the data
from ``PRNGKey(100 + s)`` and the k-means init from ``PRNGKey(s)``), then
each (arm, knob)'s mean and spread (max - min).  ``chip_smoke.py`` phase
8(b) holds the PyTorch port, whose data and k-means come from
``torch.Generator``, to the mean within max(0.02, spread) (``REF_GRAPH``).
"""

from __future__ import annotations

import argparse
import time

import jax

from repro.core.preserve import recall_at_k
from repro.data import synthetic
from repro.knn import make_index

#: (dataset, factory, knob name, knob values)
ARMS = (
    ("sift", "graph24", "ef_search", (300,)),
    ("sift", "graph24,lpq8@global_minmax", "ef_search", (300,)),
    ("glove", "graph24", "ef_search", (300,)),
    ("glove", "graph24,lpq8@global_absmax", "ef_search", (300,)),
    ("product", "graph24", "ef_search", (300,)),
    ("product", "graph24,lpq8@gaussian:3", "ef_search", (300,)),
    ("sift", "ivf128,lpq8@global_minmax", "nprobe", (8, 32)),
    ("sift", "ivf128", "nprobe", (8, 32)),
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
        for name, f, knob, values in ARMS:
            if name not in data:
                corpus, queries, metric = synthetic.load(
                    name, args.n, 128, key=jax.random.PRNGKey(100 + s))
                gt = make_index("flat", corpus, metric=metric).search(
                    queries, 100).ids
                data[name] = corpus, queries, metric, gt
            corpus, queries, metric, gt = data[name]
            t0 = time.perf_counter()
            idx = make_index(f, corpus, metric=metric, key=jax.random.PRNGKey(s))
            build_s = time.perf_counter() - t0
            for v in values:
                ids = idx.search(queries, 100, **{knob: v}).ids
                r = float(recall_at_k(gt, ids))
                rec.setdefault((name, f, v), []).append(r)
                print(f"{name} {args.n} {f} seed {s} {knob} {v}: recall@100 "
                      f"{r:.4f} (build {build_s:.1f} s)", flush=True)
    for (name, f, v), rs in rec.items():
        print(f"{name} {args.n} {f} {v}: mean {sum(rs) / len(rs):.4f} "
              f"spread {max(rs) - min(rs):.4f} "
              f"({', '.join(f'{r:.4f}' for r in rs)})")
    print(f"{time.perf_counter() - t_all:.1f} s in all")


if __name__ == "__main__":
    main()
