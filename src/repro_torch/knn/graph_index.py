"""NGT-equivalent: neighbourhood-graph + seed-structure index, ONNG-style
(port of ``repro.knn.graph_index``): the paper's Table 3 arm,
``graph24,lpq8@global_minmax``.

The graph is the exact kNN graph made bidirectional and degree-capped
(ANNG/ONNG construction); a k-means centroid table probed through
``engine.topk`` stands in for NGT's VP-tree and picks each query's entry
points; the walk is the batched beam walk of ``knn.graph`` over the
engine's store-aware score set (fp32, int8 or packed int4).

The build is the reference's, step for step, on the index's device:

* For metric ``ip`` the corpus gains the column sqrt(max ||x||^2 -
  ||x||^2) and the graph is built and walked on ``l2`` (the MIP -> L2
  reduction); Eq. 1 constants are fitted on the augmented corpus, and a
  query gains a zero column.  The rerank store stays in user space.
* The exact kNN self-join is ``FlatIndex.search`` of the whole corpus
  (dequantized codes for a quantized store, re-encoded as queries) at
  k = degree // 2 + 1, in blocks of queries of at most ``JOIN_BYTES``
  of working set; column 0 is dropped as "self", whatever it holds.
* The bidirectional, capped assembly is the reference's double loop in
  vectorized form (``onng_adjacency``).
* Seeds: k-means centroids of the (augmented) corpus, and the corpus row
  nearest each, by f32 negated L2, first maximum on ties.

Random draws and float sums: the reference draws its centroids from
``jax.random``; here ``key`` (an int) seeds ``knn.ivf.kmeans``.  The
augmentation column and the Eq. 1 constants are reduced in torch's order
on the store's device.  The private ``_given`` argument takes them from
elsewhere (the reference's, or another device's), and then the integer
arms build the same graph.

Per-region constants (``graph16,lpq4,regions``): the seeds' neighbourhoods
are the regions.  Rows are assigned to the nearest seed in *user* space
(the seeds' first d coordinates), one Eq. 1 constant set a seed is fitted
on the user-space corpus (``cascade.RegionQuant``, or ``_given["regions"]``)
and a second, regional store holds the user-space corpus under them.  The
walk is unchanged; its ef survivors are re-scored under each row's own
constants in the user's metric, at width d (``engine.topk_among_regional``),
before the cut to k.

A ``SearchParams.filter`` leaves the walk alone, widens ef to
``overfetch(k, selectivity, n)`` and masks the cut from ef to k (or the
regional re-score).  The walk is not row-shardable: on a mesh the index
replicates and the query batch splits over the shards
(``dist.replica.replicated_query_plan``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from repro_torch import engine
from repro_torch.cascade.regions import RegionQuant
from repro_torch.core import distances as D
from repro_torch.core import quant as Qz
from repro_torch.device import resolve_device, to_tensor
from repro_torch.filter import overfetch
from repro_torch.knn import base as B
from repro_torch.knn import graph as G
from repro_torch.knn import ivf as IVF
from repro_torch.knn import registry
from repro_torch.knn.flat import FlatIndex
from repro_torch.knn.spec import (
    IndexSpec,
    build_rerank_store,
    quant_spec_from_kwargs,
    resolve_build_spec,
)

#: bytes of working set one block of the self-join's queries may hold
JOIN_BYTES = 1 << 28


def join_block_rows(store: engine.CodeStore, metric: str, k: int,
                    chunk: int = B.SearchParams.chunk) -> int:
    """Queries a block of the self-join takes: ``JOIN_BYTES`` over one
    query's working set.  On the fused kernels (a CUDA store, ip or l2)
    that is its f32 row and codes and its k kept and k pass-1 keys; on the
    plain scan, its row of the [rows, chunk] f32 score tile."""
    if store.device.type == "cuda" and metric in ("ip", "l2"):
        per = 5 * store.d + 16 * k
    else:
        per = 4 * min(store.n, chunk)
    return max(1, JOIN_BYTES // per)


def mip_column(corpus: torch.Tensor) -> torch.Tensor:
    """The MIP -> L2 augmentation column, sqrt(max(max ||x||^2 - ||x||^2,
    0)) per row ([N] f32, summed on the corpus's device)."""
    norms2 = torch.sum(corpus * corpus, dim=-1)
    return D._sqrt32(torch.clamp_min(torch.max(norms2) - norms2, 0.0))


def onng_adjacency(nbr: torch.Tensor, degree: int) -> torch.Tensor:
    """The reference's bidirectional, capped assembly (``graph_index.py``
    ``:148-160``), vectorized on ``nbr``'s device.  The loop visits row i's
    neighbours j in order and appends j to row i, then i to row j, each
    while the row holds fewer than ``degree``; ``-1`` is skipped.  Written
    as events in loop order, row r keeps the first ``degree`` events that
    target r, in that order: a stable sort by target, a rank within each
    target, a scatter of the ranks below ``degree``.  [N, degree] int32,
    -1 pad."""
    n, dev = nbr.shape[0], nbr.device
    rows = torch.arange(n, device=dev)[:, None].expand(nbr.shape)
    ok = nbr >= 0
    i, j = rows[ok], nbr[ok].long()              # row-major: loop order
    target = torch.stack([i, j], dim=1).reshape(-1)
    value = torch.stack([j, i], dim=1).reshape(-1)
    t, order = torch.sort(target, stable=True)
    counts = torch.bincount(t, minlength=n)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t.numel(), device=dev) - starts[t]
    keep = rank < degree
    adj = torch.full((n, degree), -1, dtype=torch.int32, device=dev)
    adj[t[keep], rank[keep]] = value[order][keep].to(torch.int32)
    return adj


@registry.register("graph")
@dataclasses.dataclass
class GraphIndex:
    metric: str
    degree: int
    store: engine.CodeStore
    adj: torch.Tensor                   # [N, degree] int32, -1 pad
    seeds: torch.Tensor                 # [n_seeds, d] f32 centroids
    seed_ids: torch.Tensor              # [n_seeds] nearest corpus row each
    build_seconds: float = 0.0
    # the rerank store lives in the user's (un-augmented) space: the walk
    # runs on the internal metric, the rerank tail on the user's metric
    rerank_store: Optional[engine.CodeStore] = None
    # MIP -> L2 reduction (Bachrach et al.): internal_metric is what the
    # walk uses; aug marks the extra corpus column
    internal_metric: str = "l2"
    aug: bool = False
    # per-seed constants ('graph24,lpq8,regions'), fitted in user space,
    # and the user-space corpus encoded under them
    regions: Optional[RegionQuant] = None
    region_store: Optional[engine.CodeStore] = None
    #: build seconds by part (self_join, assembly, seeds, regions); not
    #: saved
    build_parts: dict = dataclasses.field(default_factory=dict,
                                          compare=False)

    # -- views --------------------------------------------------------------
    @property
    def n(self) -> int:
        return self.store.n

    @property
    def quantized(self) -> bool:
        return self.store.quantized

    @property
    def data(self) -> torch.Tensor:
        return self.store.data

    @property
    def params(self) -> Optional[Qz.QuantParams]:
        return self.store.params

    @property
    def device(self) -> torch.device:
        return self.store.device

    # -- construction -----------------------------------------------------
    @staticmethod
    def build(
        corpus,
        spec: IndexSpec | str | None = None,
        *,
        degree: int = 32,
        n_seeds: int = 32,
        metric: str = "ip",
        quantized: bool = False,
        bits: int = 8,
        scheme: str | Qz.Scheme = Qz.Scheme.GAUSSIAN,
        sigmas: float = 1.0,
        key: int | None = None,
        device=None,
        _given: Optional[dict[str, Any]] = None,
    ) -> "GraphIndex":
        """Build on ``device`` (default: the GPU).  ``key`` is an int seed
        for the seed k-means (default 0).  ``_given`` may hold
        ``centroids`` ([n_seeds, d(+1)] f32, replacing the k-means),
        ``extra`` ([N] f32, the ip augmentation column), ``params`` (Eq.
        1 constants of the index's own, possibly augmented, space) and, for
        a regions build, ``regions`` (a ``RegionQuant`` over the user-space
        corpus)."""
        spec, p = resolve_build_spec(
            "graph", spec, metric=metric,
            quant=quant_spec_from_kwargs(quantized, bits, scheme, sigmas),
            degree=degree, n_seeds=n_seeds,
        )
        degree = int(p["degree"])
        n_seeds = int(p["n_seeds"])
        metric = spec.metric
        given = dict(_given or {})

        t0 = time.perf_counter()
        dev = resolve_device(device)
        corpus = to_tensor(corpus, device=dev, dtype=torch.float32)
        user_corpus = corpus                 # pre-augmentation, for rerank
        n = corpus.shape[0]

        aug = metric == "ip"
        internal_metric = "l2" if aug else metric
        if aug:
            extra = given.get("extra")
            extra = (mip_column(corpus) if extra is None
                     else to_tensor(extra, device=dev, dtype=torch.float32))
            corpus = torch.cat([corpus, extra.reshape(n, 1)], dim=-1)

        if spec.quant is None:
            store = engine.CodeStore.dense(corpus)
        else:
            # constants are learned in the index's own (possibly augmented)
            # space: pre-learned d-dim params are dropped under augmentation
            quant = spec.quant
            if aug and quant.params is not None:
                quant = dataclasses.replace(quant, params=None)
            if given.get("params") is not None:
                quant = quant.with_params(given["params"])
            store = quant.build_store(corpus)

        # exact kNN graph in the index's own distance domain (integer codes
        # for a quantized store) through the engine-backed flat scan
        t1 = _clock(dev)
        half = max(degree // 2, 1)
        nbr = _self_join(store, corpus, internal_metric, half + 1)[:, 1:]
        t2 = _clock(dev)
        adj = onng_adjacency(nbr, degree)
        t3 = _clock(dev)

        # seed structure: k-means centroids + their nearest corpus rows
        cents = given.get("centroids")
        if cents is None:
            cents = IVF.kmeans(corpus, min(n_seeds, n),
                               0 if key is None else key)
        cents = to_tensor(cents, device=dev, dtype=torch.float32)
        seed_ids = torch.argmax(D.l2_scores(cents, corpus),
                                dim=-1).to(torch.int32)
        t4 = _clock(dev)

        regions = region_store = None
        if spec.params.get("regions"):
            # the seeds' neighbourhoods double as the regions, fitted in
            # user space
            regions = given.get("regions")
            if regions is None:
                seeds_user = cents[:, : user_corpus.shape[1]]
                r_assign = torch.argmax(D.l2_scores(user_corpus, seeds_user),
                                        dim=-1)
                regions = RegionQuant.fit(
                    user_corpus, r_assign, int(cents.shape[0]),
                    bits=spec.quant.bits, scheme=spec.quant.scheme,
                    sigmas=spec.quant.sigmas, device=dev)
            regions = regions.to(dev)
            # nominal global constants, kept for persistence only
            region_store = engine.CodeStore.from_codes(
                regions.encode(user_corpus),
                spec.quant.learn(user_corpus).to(dev),
                pack=spec.quant.effective_packed)

        idx = GraphIndex(
            metric=metric, degree=degree, store=store, adj=adj, seeds=cents,
            seed_ids=seed_ids, internal_metric=internal_metric, aug=aug,
            rerank_store=build_rerank_store(spec, user_corpus),
            regions=regions, region_store=region_store,
        )
        t5 = _clock(dev)
        idx.build_seconds = t5 - t0
        idx.build_parts = {"self_join": t2 - t1, "assembly": t3 - t2,
                           "seeds": t4 - t3}
        if regions is not None:
            idx.build_parts["regions"] = t5 - t4
        return idx

    # -- query ------------------------------------------------------------
    def prepare_queries(self, queries) -> torch.Tensor:
        """Queries must already be in the (possibly augmented) index space."""
        return self.store.encode_queries(queries)

    def placement(self, n_shards: int):
        """The walk is not row-shardable: every shard holds the whole
        adjacency and queries fan out instead (``dist.replica``)."""
        from repro_torch.dist.placement import Placement

        return Placement.replicated(self.n, n_shards)

    def plan(self, k: int, params: Optional[B.SearchParams] = None, *,
             mesh=None, placement=None):
        """Freeze (k, ef) into a seed-probe + beam-walk runner ``queries ->
        SearchResult``.  Queries enter in user space; the runner applies
        the MIP -> L2 augmentation itself, so the Searcher's rerank tail
        (user metric, un-augmented store) composes on the walked ids.
        Under a mesh the index replicates and the walks split over the
        shards, the cut or re-score running at the whole batch, as the
        hnsw kind's."""
        if placement is not None and placement.kind != "replicated":
            raise ValueError(
                f"the graph walk only replicates; got a {placement.kind!r} "
                "placement"
            )
        sp = params or B.SearchParams()
        ef = max(sp.ef_search, k)
        # filter (DESIGN.md §16): walk unfiltered, widen ef by the
        # filter's selectivity, apply the bitmap at the cut from ef to k
        fmask, fstats = B.filter_mask(sp, self.n, self.device)
        if fmask is not None:
            ef = max(ef, overfetch(k, sp.filter.selectivity, self.n))
        n_entry = min(8, self.seeds.shape[0])

        def walk_of(ix: "GraphIndex"):
            score_set = engine.make_batch_score_set(ix.store,
                                                    ix.internal_metric)
            seed_store = engine.CodeStore.dense(ix.seeds)

            def walk(queries):
                qf = to_tensor(queries, device=ix.device, dtype=torch.float32)
                if ix.aug:
                    qf = torch.nn.functional.pad(qf, (0, 1))
                q = ix.prepare_queries(qf)
                # entry points: the best seeds through the engine (the
                # "tree")
                _s, probe, _ = engine.topk(qf, seed_store, n_entry,
                                           ix.internal_metric)
                entry = ix.seed_ids[probe.long()]             # [Q, n_entry]
                return G.beam_search_batch(q, ix.adj, entry, score_set, ef)

            return walk

        if mesh is None:
            exec_walk = walk_of(self)
        else:
            # the walks fan out over the mesh; the cut (and a regional
            # re-score) runs on the gathered beams at the whole batch, so
            # its batched fp32 product has the unsharded plan's shape
            from repro_torch.dist.replica import replicated_walk

            exec_walk = replicated_walk(self, walk_of, mesh)
        rg = self.regions

        def run(queries) -> B.SearchResult:
            nq = queries.shape[0]
            scores, ids = exec_walk(queries)
            cand_bound = n_entry + 8 * ef * self.degree
            stats = {"kind": "graph", "ef_search": ef, "n_entry": n_entry,
                     **engine.search_stats(
                         self.store, candidates=cand_bound, chunks=1,
                         rows_read=nq * cand_bound), **fstats}
            if rg is None:
                scores, ids = G.filtered_cut(scores, ids, k, fmask)
            else:
                # re-score the walked candidates under each row's own seed's
                # constants, in the user's metric and space (the walk's
                # internal scores only order them)
                rs = engine.regional_stats(self.region_store, ids)
                scores, ids = engine.topk_among_regional(
                    to_tensor(queries, device=self.device,
                              dtype=torch.float32),
                    self.region_store, rg.scale, rg.zero, rg.assign, ids,
                    k, self.metric, mask=fmask)
                stats.update(regional=True,
                             regional_candidates=rs["candidates"],
                             bytes_read=stats["bytes_read"] + rs["bytes_read"])
            if mesh is not None:
                stats["placement"] = "replicated"
            return B.SearchResult(scores, ids, stats)

        return run

    def searcher(self, k: int, params: Optional[B.SearchParams] = None, **kw):
        from repro_torch.knn.searcher import Searcher

        return Searcher(self, k, params, **kw)

    def search(self, queries, k: int, params: Optional[B.SearchParams] = None,
               *, ef_search: int | None = None) -> B.SearchResult:
        """One-shot plan-and-run: seed probe + beam walk."""
        from repro_torch.knn import searcher as S

        sp = (params or B.SearchParams()).merged(ef_search=ef_search)
        return S.one_shot(self, queries, k, sp)

    # -- accounting ---------------------------------------------------------
    def memory_bytes(self) -> int:
        graph = int(self.adj.numel()) * 4
        seeds = int(self.seeds.numel()) * 4 + int(self.seed_ids.numel()) * 4
        total = self.store.memory_bytes() + graph + seeds
        if self.rerank_store is not None:
            total += self.rerank_store.memory_bytes()
        if self.regions is not None:
            total += self.regions.memory_bytes()
            total += self.region_store.memory_bytes()
        return total

    def region_drift(self, live_corpus):
        """Per-seed calibration drift of a live corpus against the fitted
        constants ([n_seeds] float64; +inf marks an empty neighbourhood).
        Live rows are assigned to the nearest seed in user space, the
        build's own rule, so the build corpus drifts exactly 0."""
        if self.regions is None:
            raise ValueError(
                "region_drift needs a per-region build — construct the "
                "index with an '...,regions' factory (e.g. 'graph,lpq8,regions')"
            )
        live = to_tensor(live_corpus, device=self.device, dtype=torch.float32)
        seeds_user = self.seeds[:, : self.region_store.d]
        return self.regions.drift_report(
            live, torch.argmax(D.l2_scores(live, seeds_user), dim=-1))

    # -- disk round-trip ---------------------------------------------------
    def save(self, path) -> None:
        arrays, meta = self.store.state()
        if self.rerank_store is not None:
            rr_a, rr_m = self.rerank_store.state(prefix="rr_")
            arrays.update(rr_a)
            meta.update(rr_m)
        if self.regions is not None:
            rg_a, rg_m = self.regions.state(prefix="rg_")
            rs_a, rs_m = self.region_store.state(prefix="rgs_")
            arrays.update({**rg_a, **rs_a})
            meta.update({**rg_m, **rs_m})
        B.save_state(
            path,
            {"adj": self.adj, "seeds": self.seeds,
             "seed_ids": self.seed_ids, **arrays},
            {"kind": "graph", "metric": self.metric,
             "quantized": self.quantized, "degree": self.degree,
             "internal_metric": self.internal_metric, "aug": self.aug,
             "build_seconds": self.build_seconds, **meta},
        )

    @staticmethod
    def from_state(arrays, meta, device=None) -> "GraphIndex":
        """Rebuild from (arrays, meta) as ``save`` writes them."""
        dev = resolve_device(device)
        regional = "rg_regions" in meta

        def t(name, dtype):
            return to_tensor(arrays[name], device=dev, dtype=dtype).contiguous()

        return GraphIndex(
            metric=meta["metric"], degree=int(meta["degree"]),
            store=engine.CodeStore.from_state(arrays, meta, device=dev),
            adj=t("adj", torch.int32), seeds=t("seeds", torch.float32),
            seed_ids=t("seed_ids", torch.int32),
            build_seconds=float(meta.get("build_seconds", 0.0)),
            internal_metric=meta["internal_metric"], aug=bool(meta["aug"]),
            rerank_store=(engine.CodeStore.from_state(arrays, meta,
                                                      prefix="rr_", device=dev)
                          if "rr_store" in meta else None),
            regions=(RegionQuant.from_state(arrays, meta, prefix="rg_",
                                            device=dev) if regional else None),
            region_store=(engine.CodeStore.from_state(
                arrays, meta, prefix="rgs_", device=dev) if regional else None),
        )

    @staticmethod
    def load(path, device=None) -> "GraphIndex":
        arrays, meta = B.load_state(path)
        return GraphIndex.from_state(arrays, meta, device=device)


def _clock(dev: torch.device) -> float:
    """Host seconds after the device's queued work (build part timings)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _self_join(store: engine.CodeStore, corpus: torch.Tensor, metric: str,
               k: int) -> torch.Tensor:
    """Each corpus row's exact top-k over the store ([N, k] int32):
    ``FlatIndex.search`` of the rows (for a quantized store its dequantized
    codes, which the search re-encodes) in blocks of
    ``join_block_rows`` queries.  A query's top-k does not depend on the
    others in its batch, so blocks give the one-batch result."""
    flat = FlatIndex.from_store(store, metric)
    rows = join_block_rows(store, metric, k)
    out = torch.empty((store.n, k), dtype=torch.int32, device=store.device)
    for s in range(0, store.n, rows):
        e = min(s + rows, store.n)
        if store.quantized:
            codes = store.take(torch.arange(s, e, device=store.device))
            q = Qz.dequantize(codes[:, : store.d], store.params)
        else:
            q = corpus[s:e]
        out[s:e] = flat.search(q, k).ids
    return out
