"""Index kinds behind one API (port of ``repro.knn``: ``flat``, ``graph``,
``hnsw``, ``ivf``, ``pq``, the ``stream`` wrapper and the ``cascade``
kind), the graph-construction utilities, and the searcher's plans
(``Searcher``, ``Rerank``, the sharded and multi-source plans, and the
cross-shard merge ``distributed_topk``)."""

from repro_torch.engine import (  # noqa: F401
    chunked_topk,
    distributed_topk,
    merge_topk,
)
from repro_torch.knn.base import Index, SearchParams, SearchResult  # noqa: F401
from repro_torch.knn.flat import FlatIndex  # noqa: F401
from repro_torch.knn.graph_index import GraphIndex  # noqa: F401
from repro_torch.knn.graph_utils import knn_graph, radius_graph  # noqa: F401
from repro_torch.knn.hnsw import HNSWIndex  # noqa: F401
from repro_torch.knn.ivf import IVFIndex, kmeans  # noqa: F401
from repro_torch.knn.pq import PQIndex  # noqa: F401
from repro_torch.knn.registry import kinds, load_index, make_index  # noqa: F401
from repro_torch.knn.searcher import (  # noqa: F401
    Rerank,
    Searcher,
    multi_source_plan,
    sharded_scan_plan,
)
from repro_torch.knn.spec import (  # noqa: F401
    IndexSpec,
    QuantSpec,
    as_spec,
    parse_factory,
)


def __getattr__(name):
    # the stream wrapper imports repro_torch.knn submodules itself:
    # resolve it lazily (PEP 562), as the reference does
    if name == "MutableIndex":
        from repro_torch.stream import MutableIndex

        return MutableIndex
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
