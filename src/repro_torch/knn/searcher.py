"""The Searcher: planned, bucketed, rerank-capable search sessions (port of
the single-device half of ``repro.knn.searcher``, DESIGN.md §9).

  * **plan once** — ``index.searcher(k, params)`` validates the plan
    (k <= 0, k > n, chunk <= 0, ... fail here with ``ValueError``s),
    resolves the rerank stage and freezes the per-kind runner.
  * **bucket** — requests are sliced into padded batch-size buckets
    (default 1/8/32/256) and stitched back.  Torch runs eagerly, so
    ``trace_counts`` records the first run of each bucket (the reference
    counts jit traces); capturing each bucket as a CUDA graph is later work.
  * **rerank** — an optional ``Rerank(depth, store)`` tail re-scores the
    quantized top-``depth`` against an fp32/int8 store (§3.4 recall
    recovery; ``"flat,lpq4+r32"`` builds the store at index time).
  * **account** — every result's stats carry the engine block plus
    ``{bucket, padded_q, shards, reranked}``.

The sharded (mesh) and multi-source (stream) plans are not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Optional, Sequence, Union

import torch

from repro_torch import engine
from repro_torch.device import to_tensor
from repro_torch.knn import base as B

__all__ = ["Searcher", "Rerank", "one_shot", "DEFAULT_BATCH_SIZES",
           "DEFAULT_RERANK_DEPTH"]

#: padded batch-size buckets (smallest covering bucket per request;
#: oversize requests run in max-bucket slices)
DEFAULT_BATCH_SIZES = (1, 8, 32, 256)


def DEFAULT_RERANK_DEPTH(k: int, n: int) -> int:
    """Candidate depth when a rerank store exists but no depth is given:
    4k, clamped to [k, n]."""
    return max(k, min(n, 4 * k))


@dataclasses.dataclass(frozen=True)
class Rerank:
    """Rerank stage: re-score the quantized top-``depth`` against ``store``
    (an fp32 or int8 ``engine.CodeStore``) by exact distance."""

    depth: int
    store: Optional[engine.CodeStore]


def _query_dim(index) -> Optional[int]:
    """Expected query width, for plan-time shape validation."""
    store = getattr(index, "store", None)
    if isinstance(store, engine.CodeStore):
        # the graph kind's MIP->L2 augmentation adds one internal column
        return store.d - 1 if getattr(index, "aug", False) else store.d
    if isinstance(store, engine.PQStore):
        return int(store.codebooks.shape[0] * store.codebooks.shape[2])
    d = getattr(index, "d", None)
    return int(d) if d is not None else None


def _resolve_rerank(index, k: int, n: int, rerank) -> Optional[Rerank]:
    """Normalize ``rerank=``: None -> the index's ``+rN`` store at default
    depth (or none); False -> off; int -> depth over the index's store;
    Rerank -> explicit (its store must cover the same id space)."""
    if rerank is False:
        return None
    own = getattr(index, "rerank_store", None)
    if rerank is None or rerank is True:
        if own is None:
            if rerank is True:
                raise ValueError(
                    "rerank=True but the index holds no rerank store — "
                    "build with a '+r32'/'+r8' factory suffix or pass "
                    "Rerank(depth, store)"
                )
            return None
        return Rerank(DEFAULT_RERANK_DEPTH(k, n), own)
    if isinstance(rerank, int):
        if own is None:
            raise ValueError(
                f"rerank depth {rerank} given but the index holds no rerank "
                "store — build with a '+r32'/'+r8' factory suffix or pass "
                "Rerank(depth, store)"
            )
        rerank = Rerank(int(rerank), own)
    if not isinstance(rerank, Rerank):
        raise TypeError(
            f"rerank must be None/False/int depth/Rerank, got {type(rerank)!r}"
        )
    if not isinstance(rerank.store, engine.CodeStore):
        raise TypeError("Rerank.store must be an engine.CodeStore")
    if rerank.store.n != n:
        raise ValueError(
            f"rerank store covers {rerank.store.n} rows but the index holds "
            f"{n} — the stores must share one id space"
        )
    if rerank.depth <= 0:
        raise ValueError(f"rerank depth must be positive, got {rerank.depth}")
    return dataclasses.replace(rerank, depth=max(k, min(rerank.depth, n)))


class Searcher:
    """A planned search session: ``index.searcher(k, params)(queries)``.

    ``batch_sizes=None`` is the one-shot mode ``Index.search`` uses: no
    padding, one direct run.
    """

    def __init__(
        self,
        index,
        k: int,
        params: Optional[B.SearchParams] = None,
        *,
        batch_sizes: Optional[Sequence[int]] = DEFAULT_BATCH_SIZES,
        shards=None,
        rerank: Union[None, bool, int, Rerank] = None,
        strict: bool = True,
    ):
        if shards is not None:
            raise NotImplementedError(
                "sharded Searchers are not ported yet: ROADMAP queue A14")
        if not isinstance(k, int) or isinstance(k, bool) or k <= 0:
            raise ValueError(f"k must be a positive int, got {k!r}")
        n = int(index.n)
        if strict and k > n:
            raise ValueError(
                f"k={k} exceeds the corpus size n={n}; a plan cannot return "
                "more neighbors than the index holds"
            )
        sp = (params or B.SearchParams()).validate()
        if batch_sizes is not None:
            batch_sizes = tuple(sorted(set(int(b) for b in batch_sizes)))
            if not batch_sizes or batch_sizes[0] <= 0:
                raise ValueError(
                    f"batch_sizes must be positive ints, got {batch_sizes!r}"
                )

        self.index = index
        self.k = k
        self.params = sp
        self.batch_sizes = batch_sizes
        self.mesh = None
        self.rerank = _resolve_rerank(index, k, n, rerank)
        self._qdim = _query_dim(index)
        self._counts: collections.Counter = collections.Counter()
        self._extras = {"shards": 1, "tuned": False}

        rr = self.rerank
        inner = index.plan(rr.depth if rr is not None else k, sp)
        metric = index.metric

        def run(queries: torch.Tensor) -> B.SearchResult:
            res = inner(queries)
            stats = dict(res.stats)
            s, i = res.scores, res.ids
            if rr is not None:
                s, i, rstats = engine.rerank_among(queries, rr.store, i, k,
                                                   metric)
                stats.update(rstats)
                stats["bytes_read"] = (
                    stats.get("bytes_read", 0) + rstats["rerank_bytes"]
                )
            else:
                stats.setdefault("reranked", 0)
            return B.SearchResult(s, i, stats)

        self._run = run

    # -- accounting --------------------------------------------------------
    @property
    def trace_counts(self) -> dict[int, int]:
        """bucket size -> runs recorded (bucketed: the first run of each)."""
        return dict(self._counts)

    @property
    def n_shards(self) -> int:
        return self._extras["shards"]

    def buckets_for(self, q_len: int) -> tuple[int, ...]:
        """The buckets a ``q_len``-query request executes in (one per
        slice) — callers warm these before timing."""
        if self.batch_sizes is None:
            return (q_len,)
        out = []
        max_b = self.batch_sizes[-1]
        while q_len > 0:
            rows = min(q_len, max_b)
            out.append(next(b for b in self.batch_sizes if b >= rows))
            q_len -= rows
        return tuple(out)

    # -- execution ---------------------------------------------------------
    def _validate_queries(self, queries) -> torch.Tensor:
        q = to_tensor(queries)
        if q.dim() != 2:
            raise ValueError(
                f"queries must be [Q, d], got shape {tuple(q.shape)}"
            )
        if q.shape[0] == 0:
            raise ValueError("empty query batch: queries.shape[0] == 0")
        if self._qdim is not None and int(q.shape[1]) != self._qdim:
            raise ValueError(
                f"query dim {int(q.shape[1])} != index dim {self._qdim}"
            )
        return q.to(device=self.index.device, dtype=torch.float32)

    def __call__(self, queries) -> B.SearchResult:
        q = self._validate_queries(queries)
        if self.batch_sizes is None:                       # one-shot mode
            self._counts[int(q.shape[0])] += 1
            res = self._run(q)
            return B.SearchResult(res.scores, res.ids, {
                **res.stats, **self._extras,
                "bucket": int(q.shape[0]), "padded_q": 0,
            })

        total = int(q.shape[0])
        max_b = self.batch_sizes[-1]
        parts_s, parts_i = [], []
        padded_q = 0
        # batch-cumulative keys sum across slices; the per-query keys
        # (candidates/chunks/reranked) carry over from the last slice
        summed = {"bytes_read": 0, "rerank_bytes": 0}
        stats: dict[str, Any] = {}
        bucket = max_b
        start = 0
        while start < total:
            stop = min(start + max_b, total)
            sl = q[start:stop]
            rows = stop - start
            bucket = next(b for b in self.batch_sizes if b >= rows)
            if bucket > rows:
                sl = torch.nn.functional.pad(sl, (0, 0, 0, bucket - rows))
            if bucket not in self._counts:
                self._counts[bucket] = 1
            res = self._run(sl)
            parts_s.append(res.scores[:rows])
            parts_i.append(res.ids[:rows])
            padded_q += bucket - rows
            for key in summed:
                summed[key] += int(res.stats.get(key, 0))
            stats = dict(res.stats)
            start = stop

        s = parts_s[0] if len(parts_s) == 1 else torch.cat(parts_s)
        i = parts_i[0] if len(parts_i) == 1 else torch.cat(parts_i)
        stats.update(self._extras)
        stats.update(bucket=bucket, padded_q=padded_q,
                     bytes_read=summed["bytes_read"])
        if summed["rerank_bytes"]:
            stats["rerank_bytes"] = summed["rerank_bytes"]
        return B.SearchResult(s, i, stats)


def one_shot(index, queries, k: int,
             params: Optional[B.SearchParams]) -> B.SearchResult:
    """The eager path ``Index.search`` delegates to: non-strict (k > n keeps
    the pad-with--1 contract), unbucketed, built and called once."""
    return Searcher(index, k, params, batch_sizes=None, strict=False)(queries)
