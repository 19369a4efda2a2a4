"""Shared shape-cell definitions (port of ``repro.configs.base``).

Every architecture config module exposes:
  ARCH_ID, FAMILY ("lm" | "gnn" | "recsys"), config(), reduced_config(),
  SHAPES (its own cell dict), SKIP (cell -> reason, documented skips).
"""

from __future__ import annotations

# -- LM transformers: seq_len x global_batch --------------------------------
LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

# -- GNN (schnet) ------------------------------------------------------------
GNN_SHAPES = {
    "full_graph_sm": dict(
        kind="full_graph", n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7
    ),
    "minibatch_lg": dict(
        kind="minibatch", n_nodes=232_965, n_edges=114_615_892,
        batch_nodes=1024, fanout=(15, 10), d_feat=602, n_classes=41,
        # padded compiled-step sizes from seeds x fanout closure
        pad_nodes=1024 * (1 + 15 + 15 * 10), pad_edges=1024 * (15 + 150),
    ),
    "ogb_products": dict(
        kind="full_graph", n_nodes=2_449_029, n_edges=61_859_140, d_feat=100,
        n_classes=47,
    ),
    "molecule": dict(kind="molecule", n_nodes=30, n_edges=64, batch=128),
}

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
