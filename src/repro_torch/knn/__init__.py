"""Index kinds behind one API (port of ``repro.knn``: ``flat``, ``graph``,
``hnsw``, ``ivf``, ``pq``, the ``stream`` wrapper and the ``cascade``
kind), and the graph-construction utilities."""

from repro_torch.knn.base import Index, SearchParams, SearchResult  # noqa: F401
from repro_torch.knn.graph_utils import knn_graph, radius_graph  # noqa: F401
from repro_torch.knn.registry import kinds, load_index, make_index  # noqa: F401
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
