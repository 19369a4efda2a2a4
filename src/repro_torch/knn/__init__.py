"""Index kinds behind one API (port of ``repro.knn``; ``flat``, ``hnsw``
and ``pq`` so far)."""

from repro_torch.knn.base import SearchParams, SearchResult  # noqa: F401
from repro_torch.knn.registry import kinds, load_index, make_index  # noqa: F401
from repro_torch.knn.spec import (  # noqa: F401
    IndexSpec,
    QuantSpec,
    as_spec,
    parse_factory,
)
