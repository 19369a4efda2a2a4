"""The scoring engine (port of ``repro.engine``): corpus storage plus the
query hot path every index calls."""

from repro_torch.engine.scorer import (  # noqa: F401
    NEG,
    chunked_topk,
    make_score_set,
    merge_topk,
    pad_rows,
    remap_ids,
    rerank_among,
    search_stats,
    topk,
    topk_among,
)
from repro_torch.engine.store import CodeStore  # noqa: F401
