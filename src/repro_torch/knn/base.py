"""``SearchParams``, ``SearchResult`` and the npz disk format (port of
``repro.knn.base``).

The on-disk format is the reference's, byte for byte: one ``.npz`` holding
the index's arrays plus a ``__meta__`` uint8 array with the JSON meta
record.  An index saved by either package loads in the other.  The active
tuning table rides along under the ``"tune"`` meta key, as in the
reference; ``registry.load_index`` adopts it, stamp-checked.

``Index`` is the structural protocol every registered kind satisfies.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Iterator, Optional, Protocol, runtime_checkable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Union of every index kind's search-time knobs (see the reference):
    ``chunk`` bounds the exhaustive scan's working set; ``ef_search`` is
    the hnsw / graph beam width; ``nprobe`` is the ivf lists probed;
    ``budgets`` are a cascade's per-stage fetch depths; ``filter`` is a
    ``repro_torch.filter.Filter`` over the index's external ids (or
    None)."""

    chunk: int = 16384
    nprobe: int = 8
    ef_search: int = 100
    budgets: Optional[tuple[int, ...]] = None
    filter: Optional[Any] = None

    def merged(self, **overrides) -> "SearchParams":
        live = {k: v for k, v in overrides.items() if v is not None}
        return dataclasses.replace(self, **live) if live else self

    def validate(self) -> "SearchParams":
        """Reject nonsense knobs at plan time with clear ``ValueError``s."""
        for name in ("chunk", "nprobe", "ef_search"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
                raise ValueError(
                    f"SearchParams.{name} must be a positive int, got {v!r}"
                )
        if self.budgets is not None:
            if not isinstance(self.budgets, tuple) or not self.budgets:
                raise ValueError(
                    f"SearchParams.budgets must be a non-empty tuple of "
                    f"positive ints (or None), got {self.budgets!r}"
                )
            for v in self.budgets:
                if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
                    raise ValueError(
                        f"SearchParams.budgets entries must be positive "
                        f"ints, got {v!r} in {self.budgets!r}"
                    )
        if self.filter is not None:
            from repro_torch.filter import Filter

            if not isinstance(self.filter, Filter):
                raise ValueError(
                    f"SearchParams.filter must be a repro_torch.filter.Filter "
                    f"(or None), got {type(self.filter).__name__}"
                )
        return self


def filter_mask(sp: SearchParams, n: int, device
                ) -> tuple[Optional[torch.Tensor], dict[str, Any]]:
    """Plan-time view of ``sp.filter`` over an index of ``n`` rows: the
    bitmap as a [n] bool tensor on ``device`` (moved once, so a request
    copies nothing from the host), and the ``filter_selectivity`` stat.
    (None, {}) without a filter."""
    if sp.filter is None:
        return None, {}
    sp.validate()
    mask = torch.from_numpy(np.array(sp.filter.aligned(n), dtype=bool))
    return (mask.to(device),
            {"filter_selectivity": round(sp.filter.selectivity, 6)})


@dataclasses.dataclass
class SearchResult:
    """scores [Q, k] f32 (larger-is-closer), ids [Q, k] i32 (-1 = no hit),
    stats: per-search accounting.  Unpacks like a ``(scores, ids)`` pair."""

    scores: torch.Tensor
    ids: torch.Tensor
    stats: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __iter__(self) -> Iterator[torch.Tensor]:
        return iter((self.scores, self.ids))

    def __getitem__(self, i):
        return (self.scores, self.ids)[i]

    def __len__(self) -> int:
        return 2


@runtime_checkable
class Index(Protocol):
    """Structural protocol every registered index satisfies.

    The query side is plan-then-execute: ``plan`` freezes k +
    SearchParams into a runner, ``searcher`` wraps that runner in the
    bucketed, rerank-capable ``Searcher``, and ``search`` is a one-shot
    searcher call."""

    kind: str

    @staticmethod
    def build(corpus, spec=None, *, key=None, device=None) -> "Index":
        ...

    def search(self, queries, k: int,
               params: Optional[SearchParams] = None) -> SearchResult:
        ...

    def plan(self, k: int, params: Optional[SearchParams] = None, *,
             mesh=None, placement=None):
        ...

    def searcher(self, k: int, params: Optional[SearchParams] = None,
                 **kwargs):
        ...

    def memory_bytes(self) -> int:
        ...

    def save(self, path) -> None:
        ...

    @staticmethod
    def load(path, device=None) -> "Index":
        ...


# --------------------------------------------------------------------------
# Disk round-trip: one .npz per index — arrays plus a JSON meta record.
# --------------------------------------------------------------------------

_META_KEY = "__meta__"


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_state(path, arrays: dict[str, Any], meta: dict[str, Any]) -> None:
    """Write an index's arrays + JSON-serializable ``meta`` (which includes
    ``kind``) as one ``.npz``; ``path`` may be a path or a binary file.
    The active tuning table rides along under ``meta["tune"]``."""
    from repro_torch.tune import table as tunetable

    active_table = tunetable.active()
    if active_table is not None and "tune" not in meta:
        meta = {**meta, "tune": active_table.to_dict()}
    out = {k: _numpy(v) for k, v in arrays.items() if v is not None}
    out[_META_KEY] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8
    )
    if hasattr(path, "write"):
        np.savez(path, **out)
        return
    with open(path, "wb") as f:
        np.savez(f, **out)


def load_state(path) -> tuple[dict[str, np.ndarray], dict[str, Any]]:
    if hasattr(path, "seek"):
        path.seek(0)
    with np.load(path) as z:
        meta = json.loads(bytes(z[_META_KEY].tobytes()).decode("utf-8"))
        arrays = {k: z[k] for k in z.files if k != _META_KEY}
    return arrays, meta


def load_meta(path) -> dict[str, Any]:
    """Read only the metadata record (npz members load lazily)."""
    if hasattr(path, "seek"):
        path.seek(0)
    with np.load(path) as z:
        meta = json.loads(bytes(z[_META_KEY].tobytes()).decode("utf-8"))
    return meta
