"""The scoring engine (port of ``repro.engine``): corpus storage plus the
query hot path every index calls."""

from repro_torch.engine.scorer import (  # noqa: F401
    NEG,
    build_pq_lut,
    get_lut_cache,
    lut_cache_bypassed,
    chunked_topk,
    distributed_topk,
    make_batch_score_set,
    make_score_set,
    merge_topk,
    pad_rows,
    quantize_pq_lut,
    refine_among,
    regional_stats,
    remap_ids,
    rerank_among,
    search_stats,
    set_lut_cache,
    topk,
    topk_among,
    topk_among_regional,
    topk_from_lut,
)
from repro_torch.engine.store import PQ_CODE_BITS, CodeStore, PQStore  # noqa: F401
