"""Recall@100 of the JAX reference's int8 candidate retrieval against its
fp32 arm at n=20000, d=128, 128 queries (the recsys ``retrieval_cand``
path at reduced scale).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/recsys_reference_recall.py

The table and queries are drawn with numpy from seed 0 in the reference's
``table_init`` distribution, N(0, 1) * d^-1/2, exactly as
``chip_smoke.py``'s ``retrieval_data`` draws them, so the PyTorch port on
the GPU scores the same numbers; ``chip_smoke.py`` holds its recall to
the value printed here (``REF_RETRIEVAL_RECALL``) within 0.01.  Runs on
the CPU in seconds.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from repro.core.preserve import recall_at_k
from repro.launch.steps import make_retrieval
from repro.models.recsys.embedding import QuantizedTable

N, D, N_QUERIES, SEED, K = 20000, 128, 128, 0, 100


def main() -> None:
    rng = np.random.default_rng(SEED)
    scale = np.float32(D ** -0.5)
    table = rng.standard_normal((N, D), dtype=np.float32) * scale
    queries = rng.standard_normal((N_QUERIES, D), dtype=np.float32) * scale
    qt = QuantizedTable.from_dense(jnp.asarray(table))
    p = qt.params
    _, ids8 = make_retrieval(True, k=K)(jnp.asarray(queries), qt.codes,
                                        p.lo, p.hi, p.zero)
    _, ids32 = make_retrieval(False, k=K)(jnp.asarray(queries),
                                          jnp.asarray(table))
    print(f"n={N} d={D} queries={N_QUERIES} seed={SEED}: int8 vs fp32 "
          f"recall@{K} {float(recall_at_k(ids32, ids8)):.4f}")


if __name__ == "__main__":
    main()
