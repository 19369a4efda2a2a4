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
    ``{bucket, padded_q, shards, reranked, tuned}``.
  * **tune** — the active tuning table (``repro_torch.tune``) is
    snapshotted at plan time and every run executes under
    ``pinned(snapshot)``, so a table installed later cannot change a
    planned Searcher; ``stats["tuned"]`` says whether the plan holds one.
    Bucketed runs build their PQ tables afresh (``engine.lut_cache_bypassed``),
    as the reference's compiled buckets do; one-shot searches may use the
    LUT cache.

  * **shard** — ``shards=mesh`` (``dist.make_mesh``) pins the index's
    placement (``dist.placement.for_index``) at plan time, hands it to
    ``index.plan(..., mesh=, placement=)`` and reports ``shards``,
    ``placement``, ``placement_balance`` and ``merge_wire_bytes``.

``sharded_scan_plan`` is the row-sharded scan of the flat kind;
``multi_source_plan`` fuses per-source plans (a stream index's sealed
segments and memtable) behind one runner.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Optional, Sequence, Union

import torch

from repro_torch import engine
from repro_torch.device import to_tensor
from repro_torch.filter import overfetch
from repro_torch.kernels.ref import NEG, stable_desc
from repro_torch.knn import base as B
from repro_torch.tune import table as tunetable

__all__ = ["Searcher", "Rerank", "one_shot", "multi_source_plan",
           "sharded_scan_plan", "DEFAULT_BATCH_SIZES",
           "DEFAULT_RERANK_DEPTH"]

PlanFn = Callable[[torch.Tensor], B.SearchResult]

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
    (an fp32 or int8 ``engine.CodeStore``) by exact distance.

    ``store`` is None for indexes that own their rerank stage
    (``handles_rerank = True``: the stream kind, whose multi-source merge
    re-scores against the raw payloads in its own plan); the Searcher then
    only resolves the depth and passes it to ``index.plan``."""

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
    Rerank -> explicit (its store must cover the same id space).  An
    index with ``handles_rerank`` gets a store-less ``Rerank(depth, None)``
    (None when it has no ``+rN`` and no depth was asked for)."""
    if rerank is False:
        return None
    if getattr(index, "handles_rerank", False):
        if rerank is None:
            if getattr(index, "rerank_bits", None) is None:
                return None
            return Rerank(DEFAULT_RERANK_DEPTH(k, n), None)
        if rerank is True:
            return Rerank(DEFAULT_RERANK_DEPTH(k, n), None)
        if isinstance(rerank, bool) or not isinstance(rerank, int):
            raise TypeError(
                f"{index.kind!r} owns its rerank stage; pass None / False / "
                f"an int depth, not {type(rerank)!r}"
            )
        if rerank <= 0:
            raise ValueError(f"rerank depth must be positive, got {rerank}")
        return Rerank(max(k, min(int(rerank), max(n, k))), None)
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


# --------------------------------------------------------------------------
# sharded flat scan (used by FlatIndex.plan)
# --------------------------------------------------------------------------

def sharded_scan_plan(
    store: engine.CodeStore, metric: str, k: int, mesh, chunk: int = 16384,
    placement=None, mask=None,
) -> PlanFn:
    """Row-shard a ``CodeStore`` scan over a mesh (DESIGN.md §4/§9/§15).

    Queries replicate; corpus rows shard over every mesh axis in the
    contiguous blocks a ``rows`` placement describes (``Placement.rows``
    by default: ceil-sized blocks in shard order).  Each block is scanned
    through ``engine.topk`` on a ``CodeStore`` view with ``base = lo``: a
    slice of the store's payload (no copy) where the shard's device is the
    store's, so on the card each shard runs B2 (fp32 / int8) or B3 (int4)
    over its rows, with its slice of the filter ``mask`` (a filtered row
    dies at the kernel's fence, exactly like a pad row).  Each block's
    list is exact over its rows, with ties to the lowest row, so the
    ``distributed_topk`` merge in block (= id) order
    (``tie_break="order"``) returns the unsharded scan's ids and scores
    bit for bit.  An empty block launches nothing and contributes ``(NEG,
    -1)``; no pad row exists in a view, and any id >= n is mapped to -1 at
    the boundary.  Every shard's work is launched before the merge
    gathers.
    """
    from repro_torch.dist.sharding import (corpus_shards, row_blocks,
                                           rows_placement, run_row_shards)

    if store.base:
        raise ValueError("sharded plans require a base-0 store (the plan "
                         "owns the global id space)")
    _axes, n_shards = corpus_shards(mesh)
    n = store.n
    placement = rows_placement(placement, n, n_shards, "sharded_scan_plan")
    k_local = min(k, n, max(placement.unit_sizes, default=0))
    shards = []
    for lo, hi, dev in row_blocks(placement, mesh):
        view = None if hi == lo else (
            dataclasses.replace(store, n=hi - lo,
                                data=store.data[lo:hi].to(dev), base=lo),
            None if mask is None else mask[lo:hi].to(dev))
        shards.append((view, dev))
    merge_wire = n_shards * min(k, n) * 8    # per query: f32 score + i32 id

    def run(queries) -> B.SearchResult:
        q = store.encode_queries(queries)

        def scan(view, dev):
            return engine.topk(q.to(dev), view[0], k_local, metric,
                               chunk=chunk, prepared=True, mask=view[1])

        s, i, agg = run_row_shards(shards, scan, q.shape[0], k_local, k, n)
        stats = engine.search_stats(store, candidates=n, chunks=agg["chunks"],
                                    rows_read=0)
        stats.update(bytes_read=agg["bytes_read"], tuned=agg["tuned"])
        return B.SearchResult(s, i, {
            "kind": "flat", **stats, "placement": placement.kind,
            "merge_wire_bytes": int(q.shape[0]) * merge_wire,
        })

    return run


# --------------------------------------------------------------------------
# multi-source plans: segments + memtable behind one runner (stream kind)
# --------------------------------------------------------------------------

def multi_source_plan(
    sources: Sequence[tuple[PlanFn, int, int]],
    *,
    k: int,
    metric: str,
    id_map: torch.Tensor,
    live: torch.Tensor,
    merge_store: Optional[engine.CodeStore],
    rescore: bool,
    stats_extra: Optional[dict] = None,
    mesh=None,
    placement=None,
) -> PlanFn:
    """Fuse per-source plans into one runner over a shared internal id
    space (DESIGN.md §10: the stream kind's search path).

    ``sources`` is a list of ``(runner, base, width)``: each runner is a
    kind's ``plan`` over one sealed segment (or the memtable's flat scan)
    returning *local* ids; ``base`` rebases them into the manifest's
    internal id space; ``width`` is the candidate count it returns.  The
    runner:

      1. runs every source, rebases ids, and masks candidates through
         ``live`` ([rows] bool on the device: the tombstone bitmap, and a
         search-time filter composed into it by the caller), so a dead
         or filtered row can take a candidate slot but never a result
         slot; sources over-fetch by their masked count;
      2. merges: with ``rescore``, every candidate is re-scored in one
         common space through ``engine.topk_among`` against
         ``merge_store`` (per-segment quantized scores are not comparable
         across differently calibrated segments; this is also the ``+rN``
         rerank tail); a single source with no re-score passes through in
         its own score order (a stable cut, so dropping dead slots cannot
         reorder live ties);
      3. maps internal ids to external ids through ``engine.remap_ids``.

    The runner snapshots the state it closed over: mutations after plan
    time need a new plan.

    Under a ``mesh`` the source runners handed in are themselves sharded
    plans (each segment's inner kind shards its own rows / lists over the
    full mesh, DESIGN.md §15), and the mask, merge and re-score above them
    run on the ``live`` bitmap's device; ``placement`` (a ``segments``
    placement) is the accounting view, stamped into the stats.
    """
    del mesh          # the sources carry it; the merge runs where live is
    if rescore and merge_store is None:
        raise ValueError("rescoring merge needs a merge_store")
    extra = dict(stats_extra or {})
    if placement is not None:
        extra["placement"] = placement.kind
        extra["placement_balance"] = placement.summary()["balance"]
    total_width = sum(w for _, _, w in sources)

    def run(queries: torch.Tensor) -> B.SearchResult:
        q = queries.to(device=live.device, dtype=torch.float32)
        Q = q.shape[0]
        if not sources:                       # fully empty index
            return B.SearchResult(
                torch.full((Q, k), NEG, dtype=torch.float32, device=q.device),
                torch.full((Q, k), -1, dtype=torch.int32, device=q.device),
                {"kind": "stream", "candidates": 0, "reranked": 0, **extra},
            )

        parts_s, parts_i = [], []
        agg = {"candidates": 0, "bytes_read": 0, "chunks": 0,
               "merge_wire_bytes": 0}
        for runner, base, _w in sources:
            res = runner(q)
            parts_s.append(res.scores.to(torch.float32))
            parts_i.append(torch.where(res.ids >= 0, res.ids + base, -1))
            for key in agg:
                agg[key] += int(res.stats.get(key, 0))
        s = torch.cat(parts_s, dim=1)
        gids = torch.cat(parts_i, dim=1)

        # tombstone (and filter) mask: dead rows lose their slot here
        ok = (gids >= 0) & live[gids.clamp(0, live.shape[0] - 1).long()]
        s = torch.where(ok, s, NEG)
        gids = torch.where(ok, gids, -1).to(torch.int32)

        stats = {"kind": "stream", **agg, **extra}
        if rescore:
            qm = merge_store.encode_queries(q)
            s, gids = engine.topk_among(qm, merge_store, gids, k, metric)
            stats.update(
                reranked=total_width,
                rerank_bits=int(merge_store.bits),
                rerank_bytes=int(Q) * total_width * merge_store.row_bytes,
            )
            stats["bytes_read"] += stats["rerank_bytes"]
        else:
            k_eff = min(k, s.shape[1])
            pos = stable_desc(s, k_eff)
            s = torch.gather(s, 1, pos)
            gids = torch.gather(gids, 1, pos)
            if k_eff < k:
                s = torch.nn.functional.pad(s, (0, k - k_eff), value=NEG)
                gids = torch.nn.functional.pad(gids, (0, k - k_eff),
                                               value=-1)
            stats["reranked"] = 0
        ext = engine.remap_ids(gids, id_map)
        return B.SearchResult(s, ext, stats)

    return run


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
        self.mesh = shards
        self.rerank = _resolve_rerank(index, k, n, rerank)
        if self.rerank is not None and sp.filter is not None:
            # filter over-fetch (DESIGN.md §16): widen the candidate depth
            # by the filter's selectivity so ~k allowed rows reach the
            # rerank; fewer survivors still pad with (NEG, -1)
            self.rerank = dataclasses.replace(
                self.rerank,
                depth=max(self.rerank.depth,
                          overfetch(k, sp.filter.selectivity, n)),
            )
        self._qdim = _query_dim(index)
        self._counts: collections.Counter = collections.Counter()
        # plan-time table resolution: the active table (if it was measured
        # on this backend) is frozen now and pinned around every run
        self.tune_table = tunetable.snapshot_for_plan()
        # plan-time placement, as the table: the unit -> shard assignment
        # is worked out now from the index's sizes (row count, list sizes,
        # segment rows), so a later mutation cannot re-place a planned
        # Searcher's shards (DESIGN.md §15)
        n_shards = int(shards.devices.size) if shards is not None else 1
        if shards is not None:
            from repro_torch.dist import placement as dplacement

            self.placement = dplacement.for_index(index, n_shards)
        else:
            self.placement = None
        self._extras = {"shards": n_shards,
                        "tuned": self.tune_table is not None}
        if self.placement is not None:
            self._extras["placement"] = self.placement.kind
            self._extras["placement_balance"] = (
                self.placement.summary()["balance"])

        rr = self.rerank
        if rr is not None and rr.store is None:
            # index-owned rerank (stream): the plan runs scan -> merge ->
            # exact re-score itself; hand it k and the candidate depth
            inner = index.plan(k, sp, mesh=shards, placement=self.placement,
                               rerank_depth=rr.depth)
            rr = None
        else:
            inner = index.plan(rr.depth if rr is not None else k, sp,
                               mesh=shards, placement=self.placement)
        metric = index.metric

        def run(queries: torch.Tensor) -> B.SearchResult:
            with tunetable.pinned(self.tune_table):    # plan-time snapshot
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
            with engine.lut_cache_bypassed():
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
