"""HNSW (Malkov & Yashunin) with the paper's int8 quantization as a
drop-in storage and distance option (port of ``repro.knn.hnsw``): the
paper's primary evaluation target, ``hnsw32,lpq8@gaussian:3``.

Layout: layer l's adjacency is a dense int32 [N, M_max(l)] tensor (-1
padded), M_max(0) = 2M, M_max(l>0) = M.  The build is the reference's,
step for step: inserts go in batches whose candidate searches are batched
beam walks (``knn.graph``) over the graph as it stood before the batch,
on the index's device; then the host commits each point's connections in
numpy with top-M pruning (``np.argsort``, as the reference sorts, so tied
integer scores order the same).  The walk sees a device mirror of every
layer, refreshed after each batch with the rows that batch committed.

Levels: the reference draws them from ``jax.random``; here ``key`` (an
int) seeds a ``torch.Generator`` on the CPU, so the same key gives the
same levels on every device, though not the reference's.  Given the same
levels (the private ``_levels`` argument), the integer arms build the
reference's adjacency and entry exactly.

Per-region constants (``hnsw32,lpq8,regions``): round(sqrt(n)) k-means
cells, at most 64, over the corpus (``knn.ivf.kmeans`` seeded by ``key +
1``, or the private ``_given["region_centroids"]``), one Eq. 1 constant
set a cell (``cascade.RegionQuant``, or ``_given["regions"]``), and a
second, regional store.  The walk runs on the global store as before; the
beam's ef survivors are re-scored under each row's own cell's constants
(``engine.topk_among_regional``) before the cut to k.

A ``SearchParams.filter`` leaves the walk alone, widens ef to
``overfetch(k, selectivity, n)`` and masks the cut from ef to k (or the
regional re-score).  Not ported yet: placement / mesh plans (ROADMAP
queue A14), which raise naming their item.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import engine
from repro_torch.cascade.regions import RegionQuant
from repro_torch.core import quant as Qz
from repro_torch.device import resolve_device, to_tensor
from repro_torch.filter import overfetch
from repro_torch.knn import base as B
from repro_torch.knn import graph as G
from repro_torch.knn import ivf as IVF
from repro_torch.knn import registry
from repro_torch.knn.spec import (
    IndexSpec,
    build_rerank_store,
    quant_spec_from_kwargs,
    resolve_build_spec,
)


def _prune(ids: np.ndarray, scores: np.ndarray, cap: int) -> np.ndarray:
    """The best ``cap`` ids by score, in the reference's order: numpy's
    default (unstable) argsort of the negated scores."""
    order = np.argsort(-scores)
    return ids[order][:cap]


def draw_levels(n: int, m: int, key: int = 0) -> np.ndarray:
    """HNSW levels floor(-ln U * mL), mL = 1/ln M, with U uniform in
    [1e-12, 1) from a CPU ``torch.Generator`` seeded by ``key``."""
    g = torch.Generator()
    g.manual_seed(int(key))
    u = np.maximum(torch.rand(n, generator=g, dtype=torch.float32).numpy(),
                   np.float32(1e-12))
    return np.floor(-np.log(u) * (1.0 / math.log(m))).astype(np.int32)


@registry.register("hnsw")
@dataclasses.dataclass
class HNSWIndex:
    metric: str
    m: int
    store: engine.CodeStore              # corpus payload at any precision
    layers: list[torch.Tensor]           # adj per layer, layer 0 first
    levels: np.ndarray                   # [N] int
    entry: int
    build_seconds: float = 0.0
    rerank_store: Optional[engine.CodeStore] = None
    # per-region constants ('hnsw32,lpq8,regions'): the cells' constants,
    # the corpus encoded under them, and the cells' k-means centres
    regions: Optional[RegionQuant] = None
    region_store: Optional[engine.CodeStore] = None
    region_cents: Optional[torch.Tensor] = None

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

    def prepare_queries(self, queries) -> torch.Tensor:
        """h(q) of Definition 2: queries enter the quantized space too."""
        return self.store.encode_queries(queries)

    # -- construction -----------------------------------------------------
    @staticmethod
    def build(
        corpus,
        spec: IndexSpec | str | None = None,
        *,
        m: int = 16,
        ef_construction: int = 100,
        metric: str = "ip",
        quantized: bool = False,
        bits: int = 8,
        scheme: str | Qz.Scheme = Qz.Scheme.GAUSSIAN,
        sigmas: float = 1.0,
        key: int | None = None,
        batch_size: int = 64,
        params: Optional[Qz.QuantParams] = None,
        device=None,
        _levels: Optional[np.ndarray] = None,
        _given: Optional[dict[str, Any]] = None,
    ) -> "HNSWIndex":
        """Build on ``device`` (default: the GPU).  ``key`` is an int seed
        for the levels (default 0); ``_levels`` ([N] int) replaces them.
        For a regions build ``_given`` may hold ``region_centroids`` and
        ``regions`` (a ``RegionQuant``), which replace the cells' k-means
        and the region fit."""
        spec, p = resolve_build_spec(
            "hnsw", spec, metric=metric,
            quant=quant_spec_from_kwargs(quantized, bits, scheme, sigmas, params),
            m=m, ef_construction=ef_construction, batch_size=batch_size,
        )
        m = int(p["m"])
        ef_construction = int(p["ef_construction"])
        batch_size = int(p["batch_size"])
        metric = spec.metric

        t0 = time.perf_counter()
        dev = resolve_device(device)
        corpus = to_tensor(corpus, device=dev, dtype=torch.float32)
        n = corpus.shape[0]

        store = (
            engine.CodeStore.dense(corpus)
            if spec.quant is None
            else spec.quant.build_store(corpus)
        )

        levels = (draw_levels(n, m, 0 if key is None else key)
                  if _levels is None else np.asarray(_levels, np.int32))
        if levels.shape != (n,):
            raise ValueError(f"_levels must have shape ({n},), got "
                             f"{levels.shape}")
        max_level = int(levels.max())

        caps = [2 * m] + [m] * max_level
        adj = [np.full((n, caps[l]), -1, np.int32) for l in range(max_level + 1)]

        score_set = engine.make_batch_score_set(store, metric)

        # ---- seed: first few points fully interconnected --------------
        seed_n = min(m + 1, n)
        for p in range(seed_n):
            for l in range(levels[p] + 1):
                others = [o for o in range(seed_n) if o != p and levels[o] >= l]
                adj[l][p, : min(len(others), caps[l])] = others[: caps[l]]
        entry = int(np.argmax(levels[:seed_n]))

        qdata = store.unpacked().cpu().numpy()
        mirror = [torch.tensor(a, device=dev) for a in adj]

        # ---- batched incremental inserts ------------------------------
        for start in range(seed_n, n, batch_size):
            stop = min(start + batch_size, n)
            ids = np.arange(start, stop)
            qs = store.take(torch.arange(start, stop, device=dev))

            # per layer from the top, every point of the batch walks every
            # layer (as the reference does); the best hit seeds the next
            cur_entry = torch.full((len(ids), 1), entry, dtype=torch.int32,
                                   device=dev)
            cand_per_layer: dict[int, tuple[np.ndarray, np.ndarray]] = {}
            for l in range(max_level, -1, -1):
                bs, bi = G.beam_search_batch(
                    qs, mirror[l], cur_entry, score_set,
                    ef=ef_construction if l == 0 else max(1, ef_construction // 4),
                )
                cand_per_layer[l] = (bs.cpu().numpy(), bi.cpu().numpy())
                cur_entry = bi[:, :1]

            # commit connections on the host
            touched: list[list[int]] = [[] for _ in adj]
            for bi_pos, p in enumerate(ids):
                for l in range(int(levels[p]), -1, -1):
                    scores_l, ids_l = cand_per_layer[l]
                    c_ids = ids_l[bi_pos]
                    c_scores = scores_l[bi_pos]
                    ok = c_ids >= 0
                    c_ids, c_scores = c_ids[ok], c_scores[ok]
                    nbrs = _prune(c_ids, c_scores, m)
                    adj[l][p, : len(nbrs)] = nbrs
                    touched[l].append(int(p))
                    # back-connections with pruning
                    for nb in nbrs:
                        row = adj[l][nb]
                        slot = np.where(row < 0)[0]
                        if len(slot):
                            adj[l][nb, slot[0]] = p
                        else:
                            # prune to cap by score-to-nb: the raw dot of
                            # the stored codes for every metric but l2
                            cand = np.concatenate([row, [p]])
                            vecs = qdata[cand].astype(np.float32)
                            target = qdata[nb].astype(np.float32)
                            if metric == "l2":
                                sc = -np.sum((vecs - target) ** 2, -1)
                            else:
                                sc = vecs @ target
                            adj[l][nb] = _prune(cand, sc, caps[l])
                        touched[l].append(int(nb))
                if levels[p] >= max_level and levels[p] > levels[entry]:
                    entry = int(p)

            for l, rows in enumerate(touched):
                if rows:
                    r = np.unique(np.asarray(rows, np.int64))
                    mirror[l][torch.from_numpy(r).to(dev)] = (
                        torch.from_numpy(adj[l][r]).to(dev))

        regions = region_store = region_cents = None
        if spec.params.get("regions"):
            # neighbourhoods: about sqrt(n) k-means cells over the corpus,
            # drawn from their own seed so the levels stay as they were
            given = dict(_given or {})
            n_regions = max(1, min(64, int(round(math.sqrt(n)))))
            region_cents = given.get("region_centroids")
            if region_cents is None:
                region_cents = IVF.kmeans(corpus, n_regions,
                                          (0 if key is None else key) + 1)
            region_cents = to_tensor(region_cents, device=dev,
                                     dtype=torch.float32)
            regions = given.get("regions")
            if regions is None:
                regions = RegionQuant.fit(
                    corpus, IVF._assign(corpus, region_cents), n_regions,
                    bits=spec.quant.bits, scheme=spec.quant.scheme,
                    sigmas=spec.quant.sigmas, device=dev)
            regions = regions.to(dev)
            region_store = engine.CodeStore.from_codes(
                regions.encode(corpus), store.params,
                pack=spec.quant.effective_packed)

        idx = HNSWIndex(
            metric=metric, m=m, store=store,
            layers=mirror,                   # equal to adj: every row is fresh
            levels=levels, entry=entry,
            rerank_store=build_rerank_store(spec, corpus),
            regions=regions, region_store=region_store,
            region_cents=region_cents,
        )
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        idx.build_seconds = time.perf_counter() - t0
        return idx

    # -- query ------------------------------------------------------------
    def placement(self, n_shards: int):
        raise NotImplementedError(
            "hnsw placement (replicated walks over a mesh) is not ported "
            "yet: ROADMAP queue A14 (dist/)")

    def plan(self, k: int, params: Optional[B.SearchParams] = None, *,
             mesh=None, placement=None):
        """Freeze (k, ef) into a layered-descent + beam runner ``queries ->
        SearchResult``: greedy ef=1 descent through the upper layers, then a
        layer-0 beam of ef = max(ef_search, k), cut to k."""
        if mesh is not None or placement is not None:
            raise NotImplementedError(
                "the replicated (mesh) hnsw plan is not ported yet: "
                "ROADMAP queue A14 (dist/)")
        sp = params or B.SearchParams()
        ef = max(sp.ef_search, k)
        # filter (DESIGN.md §16): the walk stays unfiltered (the graph's
        # connectivity must not see holes), ef widens by the filter's
        # selectivity, and the bitmap applies at the cut from ef to k
        fmask, fstats = B.filter_mask(sp, self.n, self.device)
        if fmask is not None:
            ef = max(ef, overfetch(k, sp.filter.selectivity, self.n))
        score_set = engine.make_batch_score_set(self.store, self.metric)

        rg = self.regions

        def run(queries) -> B.SearchResult:
            q = self.prepare_queries(queries)
            nq = q.shape[0]
            entry = torch.full((nq,), self.entry, dtype=torch.int32,
                               device=self.device)
            # upper layers: greedy ef=1 descent
            for l in range(len(self.layers) - 1, 0, -1):
                entry = G.greedy_descent_batch(q, self.layers[l], entry,
                                               score_set)[0]
            scores, ids = G.beam_search_batch(q, self.layers[0],
                                              entry[:, None], score_set, ef)
            # candidate bound: layer-0 beam expands <= 8*ef nodes of degree
            # <= 2m each (walks stop early on convergence)
            cand_bound = ef + 8 * ef * 2 * self.m
            stats = {"kind": "hnsw", "ef_search": ef,
                     "n_layers": len(self.layers),
                     **engine.search_stats(
                         self.store, candidates=cand_bound,
                         chunks=len(self.layers),
                         rows_read=nq * cand_bound), **fstats}
            if rg is None:
                scores, ids = G.filtered_cut(scores, ids, k, fmask)
                return B.SearchResult(scores, ids, stats)
            # re-score the beam's survivors under each row's own cell's
            # constants before the cut to k (the filter rides its mask)
            rs = engine.regional_stats(self.region_store, ids)
            scores, ids = engine.topk_among_regional(
                to_tensor(queries, device=self.device, dtype=torch.float32),
                self.region_store, rg.scale, rg.zero, rg.assign, ids, k,
                self.metric, mask=fmask)
            stats.update(regional=True, regional_candidates=rs["candidates"],
                         bytes_read=stats["bytes_read"] + rs["bytes_read"])
            return B.SearchResult(scores, ids, stats)

        return run

    def searcher(self, k: int, params: Optional[B.SearchParams] = None, **kw):
        from repro_torch.knn.searcher import Searcher

        return Searcher(self, k, params, **kw)

    def search(self, queries, k: int, params: Optional[B.SearchParams] = None,
               *, ef_search: int | None = None) -> B.SearchResult:
        """One-shot plan-and-run: layered descent + layer-0 beam."""
        from repro_torch.knn import searcher as S

        sp = (params or B.SearchParams()).merged(ef_search=ef_search)
        return S.one_shot(self, queries, k, sp)

    # -- accounting ---------------------------------------------------------
    def memory_bytes(self) -> int:
        graph = sum(int(a.numel()) * 4 for a in self.layers)  # native pointers
        total = self.store.memory_bytes() + graph
        if self.rerank_store is not None:
            total += self.rerank_store.memory_bytes()
        if self.regions is not None:
            total += self.regions.memory_bytes()
            total += self.region_store.memory_bytes()
            total += int(self.region_cents.numel()) * 4
        return total

    def region_drift(self, live_corpus):
        """Per-cell calibration drift of a live corpus against the fitted
        constants ([R] float64; +inf marks an empty cell).  Live rows are
        assigned by the build's cell centres."""
        if self.regions is None:
            raise ValueError(
                "region_drift needs a per-region build — construct the "
                "index with an '...,regions' factory (e.g. 'hnsw,lpq8,regions')"
            )
        live = to_tensor(live_corpus, device=self.device, dtype=torch.float32)
        return self.regions.drift_report(
            live, IVF._assign(live, self.region_cents))

    # -- disk round-trip ---------------------------------------------------
    def save(self, path) -> None:
        s_arrays, s_meta = self.store.state()
        if self.rerank_store is not None:
            rr_a, rr_m = self.rerank_store.state(prefix="rr_")
            s_arrays = {**s_arrays, **rr_a}
            s_meta = {**s_meta, **rr_m}
        if self.regions is not None:
            rg_a, rg_m = self.regions.state(prefix="rg_")
            rs_a, rs_m = self.region_store.state(prefix="rgs_")
            s_arrays = {**s_arrays, **rg_a, **rs_a,
                        "rg_cents": self.region_cents}
            s_meta = {**s_meta, **rg_m, **rs_m}
        arrays = {"levels": self.levels, **s_arrays}
        for l, adj in enumerate(self.layers):
            arrays[f"layer_{l}"] = adj
        B.save_state(
            path, arrays,
            {"kind": "hnsw", "metric": self.metric, "quantized": self.quantized,
             "m": self.m, "entry": self.entry, "n_layers": len(self.layers),
             "build_seconds": self.build_seconds, **s_meta},
        )

    @staticmethod
    def from_state(arrays, meta, device=None) -> "HNSWIndex":
        """Rebuild from (arrays, meta) as ``save`` writes them."""
        dev = resolve_device(device)
        regional = "rg_regions" in meta
        return HNSWIndex(
            metric=meta["metric"], m=int(meta["m"]),
            store=engine.CodeStore.from_state(arrays, meta, device=dev),
            layers=[to_tensor(arrays[f"layer_{l}"], device=dev,
                              dtype=torch.int32).contiguous()
                    for l in range(meta["n_layers"])],
            levels=np.asarray(arrays["levels"]),
            entry=int(meta["entry"]),
            build_seconds=float(meta.get("build_seconds", 0.0)),
            rerank_store=(engine.CodeStore.from_state(arrays, meta,
                                                      prefix="rr_", device=dev)
                          if "rr_store" in meta else None),
            regions=(RegionQuant.from_state(arrays, meta, prefix="rg_",
                                            device=dev) if regional else None),
            region_store=(engine.CodeStore.from_state(
                arrays, meta, prefix="rgs_", device=dev) if regional else None),
            region_cents=(to_tensor(arrays["rg_cents"], device=dev,
                                    dtype=torch.float32).contiguous()
                          if regional else None),
        )

    @staticmethod
    def load(path, device=None) -> "HNSWIndex":
        arrays, meta = B.load_state(path)
        return HNSWIndex.from_state(arrays, meta, device=device)
