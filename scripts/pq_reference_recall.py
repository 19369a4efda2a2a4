"""Recall@100 of the JAX reference's PQ arms at n=20000, 128 queries.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/pq_reference_recall.py

Prints, for each (corpus, factory) that ``chip_smoke.py`` phase 5 checks
the PyTorch port on, the reference's recall@100 against its own fp32
``flat`` arm over three seeds (seed s draws the corpus and queries from
``PRNGKey(100 + s)`` and the k-means inits from ``PRNGKey(s)``), then their
mean and spread (max - min).  The port draws its data and inits from
``torch.Generator``, so its recall is held to the mean within
max(0.03, spread).  Runs on the CPU in a few minutes.
"""

from __future__ import annotations

import jax

from repro.core.preserve import recall_at_k
from repro.data import synthetic
from repro.knn import make_index

ARMS = {
    "product": ["pq32+lpq", "pq64x4+lpq", "pq64x4+lpq,r32"],
    "sift": ["pq16+lpq", "pq16"],
}
SEEDS = (0, 1, 2)


def main() -> None:
    rec = {}
    for name, factories in ARMS.items():
        for s in SEEDS:
            corpus, queries, metric = synthetic.load(
                name, 20000, 128, key=jax.random.PRNGKey(100 + s))
            gt = make_index("flat", corpus, metric=metric).search(queries, 100).ids
            for f in factories:
                idx = make_index(f, corpus, metric=metric,
                                 key=jax.random.PRNGKey(s))
                r = float(recall_at_k(gt, idx.search(queries, 100).ids))
                rec.setdefault((name, f), []).append(r)
                print(f"{name} {f} seed {s}: recall@100 {r:.4f}", flush=True)
    for (name, f), rs in rec.items():
        print(f"{name} {f}: mean {sum(rs) / len(rs):.4f} spread "
              f"{max(rs) - min(rs):.4f} ({', '.join(f'{r:.4f}' for r in rs)})")


if __name__ == "__main__":
    main()
