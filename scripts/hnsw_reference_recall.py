"""Recall@100 of the JAX reference's HNSW arms at n=20000 x 256, 128 queries.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/hnsw_reference_recall.py

Prints, for the paper's arm ``hnsw32,lpq8@gaussian:3`` and its fp32 pair
``hnsw32`` on product-like data (ip), built with ``ef_construction=300``
and ``batch_size=256`` (Table 1's batch, paper §5.2's smallest EFC and M),
the reference's recall@100 against its own fp32 ``flat`` arm at
``ef_search`` 300 and 800 over three seeds (seed s draws the corpus and
queries from ``PRNGKey(100 + s)`` and the HNSW levels from
``PRNGKey(s)``), each build's seconds, then each (arm, ef_search)'s mean
and spread (max - min).  ``chip_smoke.py`` phase 7 holds the PyTorch
port, whose data and levels come from ``torch.Generator``, to the mean
within max(0.02, spread) (``REF_HNSW``).  ``--efc`` changes
``ef_construction`` (both ends of the comparison must use the same);
``--n`` and ``--seeds`` re-measure at phase 7(c)'s 50,000 rows, e.g.
``--n 50000 --seeds 1`` (about 10 minutes).
"""

from __future__ import annotations

import argparse
import time

import jax

from repro.core.preserve import recall_at_k
from repro.data import synthetic
from repro.knn import make_index

ARMS = ("hnsw32,lpq8@gaussian:3", "hnsw32")
EF_SEARCH = (300, 800)
SEEDS = (0, 1, 2)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--efc", type=int, default=300)
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--seeds", type=int, default=len(SEEDS))
    args = ap.parse_args()
    t_all = time.perf_counter()
    rec = {}
    for s in SEEDS[:args.seeds]:
        corpus, queries, metric = synthetic.load(
            "product", args.n, 128, key=jax.random.PRNGKey(100 + s))
        gt = make_index("flat", corpus, metric=metric).search(queries, 100).ids
        for f in ARMS:
            t0 = time.perf_counter()
            idx = make_index(f, corpus, metric=metric, ef_construction=args.efc,
                             batch_size=256, key=jax.random.PRNGKey(s))
            build_s = time.perf_counter() - t0
            for ef in EF_SEARCH:
                ids = idx.search(queries, 100, ef_search=ef).ids
                r = float(recall_at_k(gt, ids))
                rec.setdefault((f, ef), []).append(r)
                print(f"product {args.n} {f} seed {s} ef_search {ef}: recall@100 "
                      f"{r:.4f} (build {build_s:.1f} s, {len(idx.layers)} "
                      f"layers)", flush=True)
    for (f, ef), rs in rec.items():
        print(f"product {args.n} {f} ef_search {ef}: mean {sum(rs) / len(rs):.4f} "
              f"spread {max(rs) - min(rs):.4f} "
              f"({', '.join(f'{r:.4f}' for r in rs)})")
    print(f"efc {args.efc}: {time.perf_counter() - t_all:.1f} s in all")


if __name__ == "__main__":
    main()
