"""Shared shape-cell definitions (port of ``repro.configs.base``, the
recsys part).

Every architecture config module exposes:
  ARCH_ID, FAMILY ("recsys"), config(), reduced_config(),
  SHAPES (its own cell dict), SKIP (cell -> reason, documented skips).
"""

from __future__ import annotations

# -- RecSys -------------------------------------------------------------------
RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65_536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262_144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}

# Criteo-1TB (MLPerf DLRM) per-field hash sizes — the standard 26-table set.
CRITEO_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)
# 13 bucketized dense fields (AutoInt treats everything as categorical)
CRITEO_DENSE_BUCKETS = (64,) * 13
