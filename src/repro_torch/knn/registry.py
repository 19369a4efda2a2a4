"""kind -> implementation registry and the ``make_index`` / ``load_index``
entry points (port of ``repro.knn.registry``).

Every kind the grammar parses is ported: ``cascade``, ``flat``,
``graph``, ``hnsw``, ``ivf``, ``pq`` and ``stream``.  Entry points run on
the card by default: ``device=None`` resolves to ``cuda`` and raises when
no CUDA device exists; pass ``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.knn.spec import IndexSpec, as_spec

_REGISTRY: dict[str, type] = {}

def register(kind: str):
    """Class decorator: register an Index implementation under ``kind``."""

    def deco(cls):
        cls.kind = kind
        _REGISTRY[kind] = cls
        return cls

    return deco


def _ensure_registered() -> None:
    from repro_torch.cascade import index  # noqa: F401  (kind "cascade")
    from repro_torch.knn import flat  # noqa: F401  (kind "flat")
    from repro_torch.knn import graph_index  # noqa: F401  (kind "graph")
    from repro_torch.knn import hnsw  # noqa: F401  (kind "hnsw")
    from repro_torch.knn import ivf  # noqa: F401  (kind "ivf")
    from repro_torch.knn import pq  # noqa: F401  (kind "pq")
    from repro_torch.stream import mutable  # noqa: F401  (kind "stream")


def kinds() -> tuple[str, ...]:
    _ensure_registered()
    return tuple(sorted(_REGISTRY))


def get_impl(kind: str) -> type:
    _ensure_registered()
    if kind not in _REGISTRY:
        raise KeyError(f"no index registered for kind {kind!r}; have {kinds()}")
    return _REGISTRY[kind]


def make_index(
    spec: IndexSpec | str,
    corpus,
    *,
    metric: Optional[str] = None,
    key=None,
    device=None,
    **overrides,
):
    """Build any ported index from an ``IndexSpec`` or factory string.

    ``corpus`` (numpy or tensor, [N, d]) is moved to ``device`` (default:
    the GPU).  ``metric`` is the default for factory strings (a metric
    fragment wins) and an explicit override for IndexSpec inputs.
    """
    resolved = as_spec(spec, metric=metric)
    if metric is not None and isinstance(spec, IndexSpec):
        resolved = dataclasses.replace(resolved, metric=metric)
    if overrides:
        resolved = resolved.with_overrides(**overrides)
    return get_impl(resolved.kind).build(corpus, resolved, key=key,
                                         device=device)


def load_index(path, *, device=None):
    """Load a saved index (either package's npz), dispatching on the
    recorded kind, onto ``device`` (default: the GPU)."""
    from repro_torch.knn import base

    meta = base.load_meta(path)
    return get_impl(meta["kind"]).load(path, device=device)
