"""The paper's quantization family (Q, phi) in torch: Eq. 1 constants and
codes, integer-domain distances, int4 packing, and the Definition-2 and
recall validators (port of ``repro.core``; ``distributed_stats`` waits for
ROADMAP queue A14)."""

from repro_torch.core.distances import (  # noqa: F401
    angular_scores,
    ip_scores,
    l2_scores,
    pairwise_distance,
    qangular_scores,
    qip_scores,
    ql2_scores,
    scores,
)
from repro_torch.core.preserve import (  # noqa: F401
    knn_recall,
    order_agreement,
    recall_at_k,
)
from repro_torch.core.quant import (  # noqa: F401
    QuantParams,
    Scheme,
    dequantize,
    learn_params,
    params_from_stats,
    quantization_error,
    quantize,
    quantize_corpus,
)
from repro_torch.core.stats import (  # noqa: F401
    DimStats,
    StreamingStats,
    corpus_stats,
    merge_stats,
)
