"""IVF (inverted-file) index and its coarse quantizer, k-means (port of
``repro.knn.ivf``).

Two steps, both through the engine: a coarse probe, ``engine.topk`` of
the queries over the (always fp32) centroid table in the user's metric
(B2 fp32 on the card for ip / l2), and fine scoring, ``engine.topk_among``
over the probed lists' rows of the corpus store (fp32, int8 or packed
int4).  Lists are padded to a fixed length, a multiple of 128, with id -1;
the pads are gathered as row 0 and masked, and ties go to the earlier
candidate slot (probe order, then list order), as in the reference.

Fine scoring runs in blocks of queries whose gathered rows, with their
widest temporary (the float64 copy of an integer dot on CUDA), stay under
``FINE_BYTES``: each query's top-k does not depend on the others, so the
result is the one-batch result.

Random draws: the reference draws the k-means init from ``jax.random``;
here ``key`` (an int) seeds a ``torch.Generator`` on the corpus's device.
The private ``_given`` argument takes the centroids from elsewhere (the
reference's, or another device's), and then the build's lists are the
reference's.

Registered as kind ``"ivf"``; factory strings ``"ivf256"``,
``"ivf256,lpq8"``, ``"ivf256,lpq4"`` (packed int4), and
``"ivf256,lpq8,regions"``: one Eq. 1 constant set per list
(``cascade.RegionQuant``, fitted on the host CPU), each row encoded under
its own list's constants, and fine scoring through
``engine.topk_among_regional`` (fp32 queries against dequantized rows),
in query blocks sized for its fp32 temporaries.  A
``SearchParams.filter`` masks the fine scoring by row and the coarse
probe by list (a list with no allowed member is never probed).  Not
ported yet: the list-placed mesh plan (ROADMAP queue A14), which raises
naming its item.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import engine
from repro_torch.cascade.regions import RegionQuant
from repro_torch.core import distances as D
from repro_torch.core import quant as Qz
from repro_torch.device import resolve_device, to_tensor
from repro_torch.knn import base as B
from repro_torch.knn import registry
from repro_torch.knn.spec import (
    IndexSpec,
    build_rerank_store,
    quant_spec_from_kwargs,
    resolve_build_spec,
)

_MESH = ("the list-placed (mesh) ivf plan is not ported yet: ROADMAP "
         "queue A14 (dist/)")

#: bytes one block of fine scoring may gather, temporaries included
FINE_BYTES = 1 << 30

#: score-matrix entries one assignment chunk may hold ([rows, C] f32, 256 MB)
_ASSIGN_ENTRIES = 1 << 26


def _assign(x: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """Nearest centroid by L2 for every row of ``x`` ([N] int64), the
    first one on ties; [rows, C] score chunks bound the working set."""
    rows = max(1, _ASSIGN_ENTRIES // cents.shape[0])
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for s in range(0, x.shape[0], rows):
        out[s:s + rows] = torch.argmax(D.l2_scores(x[s:s + rows], cents), dim=-1)
    return out


def kmeans(x: torch.Tensor, n_clusters: int, key: int = 0,
           iters: int = 10) -> torch.Tensor:
    """Plain Lloyd k-means, random init, [N, d] -> [n_clusters, d].

    ``key`` seeds a ``torch.Generator`` on ``x``'s device, which draws the
    initial centroids (distinct rows).  Each step assigns every row to its
    nearest centroid (first index on ties) and moves each centroid to its
    rows' mean; an empty cluster keeps its old centroid.  The reference
    draws its init from ``jax.random``, so the two give different
    codebooks from the same seed; only their quality is comparable.
    """
    x = x.to(torch.float32)
    n = x.shape[0]
    g = torch.Generator(device=x.device)
    g.manual_seed(int(key))
    cents = x[torch.randperm(n, generator=g, device=x.device)[:n_clusters]]
    rows = max(1, _ASSIGN_ENTRIES // n_clusters)
    for _ in range(iters):
        a = _assign(x, cents)
        counts = torch.bincount(a, minlength=n_clusters).to(torch.float32)
        sums = torch.zeros_like(cents)
        for s in range(0, n, rows):                 # one-hot^T @ x, chunked
            one_hot = torch.nn.functional.one_hot(
                a[s:s + rows], n_clusters).to(torch.float32)
            sums += one_hot.T @ x[s:s + rows]
        new = sums / torch.clamp_min(counts[:, None], 1.0)
        cents = torch.where(counts[:, None] > 0, new, cents)
    return cents


def fine_block_rows(store: engine.CodeStore, width: int,
                    regional: bool = False) -> int:
    """Queries a block of fine scoring takes: ``FINE_BYTES`` over what one
    query gathers, its ``width`` candidate rows at full width, each byte
    with room for a float64 copy (the exact integer dot on CUDA); a
    regional block holds ``engine.scorer.REGIONAL_ELT_BYTES`` an element
    instead (the fp32 dequantized rows and the gathered constants)."""
    if regional:
        per = engine.scorer.REGIONAL_ELT_BYTES
    else:
        per = (4 if not store.quantized else 1) + 8
    return max(1, FINE_BYTES // max(1, width * store.d_eff * per))


def bucket_lists(assign: np.ndarray, nlist: int) -> np.ndarray:
    """Row ids by list, ascending within each (``np.where(assign == c)``
    for every c), padded with -1 to the longest list rounded up to a
    multiple of 128: [nlist, max_list] int32."""
    order = np.argsort(assign, kind="stable")
    a = assign[order]
    counts = np.bincount(assign, minlength=nlist)
    max_list = max(1, int(counts.max(initial=0)))
    max_list = ((max_list + 127) // 128) * 128
    starts = np.cumsum(counts) - counts
    lists = np.full((nlist, max_list), -1, np.int32)
    lists[a, np.arange(a.size) - starts[a]] = order
    return lists


@registry.register("ivf")
@dataclasses.dataclass(frozen=True)
class IVFIndex:
    metric: str
    nlist: int
    max_list: int
    centroids: torch.Tensor              # [nlist, d] f32
    lists: torch.Tensor                  # [nlist, max_list] int32, -1 pad
    store: engine.CodeStore              # corpus payload at any precision
    rerank_store: Optional[engine.CodeStore] = None
    #: per-list Eq. 1 constants (``...,regions``): the store's codes are
    #: regional and only ``topk_among_regional`` scores them; None is the
    #: global single-constant path
    regions: Optional[RegionQuant] = None
    #: build seconds by part (kmeans with the assignment, lists, the region
    #: fit, store); not saved
    build_parts: dict = dataclasses.field(default_factory=dict,
                                          compare=False)

    # -- views --------------------------------------------------------------
    @property
    def quantized(self) -> bool:
        return self.store.quantized

    @property
    def n(self) -> int:
        return self.store.n

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
        key: int | None = None,
        device=None,
        nlist: int = 64,
        metric: str = "ip",
        quantized: bool = False,
        bits: int = 8,
        scheme: str | Qz.Scheme = Qz.Scheme.GAUSSIAN,
        sigmas: float = 1.0,
        params: Optional[Qz.QuantParams] = None,
        kmeans_iters: int = 10,
        _given: Optional[dict[str, Any]] = None,
    ) -> "IVFIndex":
        """Build on ``device`` (default: the GPU).  ``key`` is an int seed
        for k-means (default 0); ``_given`` may hold ``centroids``
        ([nlist, d] f32), which replace the k-means, and for a regions
        build ``regions`` (a ``RegionQuant``), which replaces the region
        fit."""
        spec, p = resolve_build_spec(
            "ivf", spec, metric=metric,
            quant=quant_spec_from_kwargs(quantized, bits, scheme, sigmas,
                                         params),
            nlist=nlist, kmeans_iters=kmeans_iters,
        )
        nlist = int(p["nlist"])
        kmeans_iters = int(p["kmeans_iters"])
        given = dict(_given or {})

        t0 = time.perf_counter()
        dev = resolve_device(device)
        corpus = to_tensor(corpus, device=dev, dtype=torch.float32)
        cents = given.get("centroids")
        if cents is None:
            cents = kmeans(corpus, nlist, 0 if key is None else key,
                           iters=kmeans_iters)
        cents = to_tensor(cents, device=dev, dtype=torch.float32)
        assign = _assign(corpus, cents).cpu().numpy()
        t1 = time.perf_counter()
        # bucket ids into fixed-width lists (host-side; build is offline)
        lists = bucket_lists(assign, nlist)
        t2 = time.perf_counter()
        regions = None
        if p.get("regions"):
            # per-list constants, each row encoded under its own list's
            # fit (the spec guarantees an lpq fragment here)
            regions = given.get("regions")
            if regions is None:
                regions = RegionQuant.fit(
                    corpus, assign, nlist, bits=spec.quant.bits,
                    scheme=spec.quant.scheme, sigmas=spec.quant.sigmas,
                    device=dev)
            regions = regions.to(dev)
        t3 = time.perf_counter()
        if regions is not None:
            # the store keeps nominal global constants for persistence;
            # its codes are regional, and only the regional path scores
            # them
            store = engine.CodeStore.from_codes(
                regions.encode(corpus), spec.quant.learn(corpus).to(dev),
                pack=spec.quant.effective_packed)
        elif spec.quant is None:
            store = engine.CodeStore.dense(corpus)
        else:
            store = spec.quant.build_store(corpus)
        idx = IVFIndex(
            metric=spec.metric, nlist=nlist, max_list=lists.shape[1],
            centroids=cents, lists=torch.from_numpy(lists).to(dev),
            store=store, rerank_store=build_rerank_store(spec, corpus),
            regions=regions,
        )
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        idx.build_parts.update(kmeans=t1 - t0, lists=t2 - t1)
        if regions is not None:
            idx.build_parts["regions"] = t3 - t2
        idx.build_parts["store"] = time.perf_counter() - t3
        return idx

    # -- query ------------------------------------------------------------
    def prepare_queries(self, queries) -> torch.Tensor:
        return self.store.encode_queries(queries)

    def list_sizes(self):
        """Per-list member counts (host ints)."""
        return tuple(int(x) for x in (self.lists >= 0).sum(dim=1).cpu())

    def placement(self, n_shards: int):
        raise NotImplementedError(_MESH)

    def plan(self, k: int, params: Optional[B.SearchParams] = None, *,
             mesh=None, placement=None):
        """Freeze (k, nprobe) into a probe-then-fine-score runner ``queries
        -> SearchResult``."""
        if mesh is not None or placement is not None:
            raise NotImplementedError(_MESH)
        sp = params or B.SearchParams()
        nprobe = min(sp.nprobe, self.nlist)
        cent_store = engine.CodeStore.dense(self.centroids)
        width = nprobe * self.max_list
        rg = self.regions
        rows = fine_block_rows(self.store, width, regional=rg is not None)
        # filter (DESIGN.md §16): a row mask for the fine-scoring fence,
        # and a list mask that keeps lists with no allowed member out of
        # the coarse probe, so their probe slots go to lists that can
        # still contribute
        fmask, lmask, fstats = self._filter_masks(sp)

        def run(queries) -> B.SearchResult:
            qf = to_tensor(queries, device=self.device, dtype=torch.float32)
            nq = qf.shape[0]
            # 1) coarse: engine top-k over the fp32 centroid table, in the
            #    user's metric
            _cs, probe, _ = engine.topk(qf, cent_store, nprobe, self.metric,
                                        mask=lmask)
            # 2) candidate ids [Q, nprobe * max_list], probe order first; a
            #    probe slot the list mask left empty (id -1) gives -1
            #    candidates, dead at the fine-scoring fence
            probe = probe.long()
            cand = self.lists[probe.clamp_min(0)]
            if lmask is not None:
                cand = torch.where(probe[..., None] >= 0, cand, -1)
            cand = cand.reshape(nq, -1)
            # 3) fine scoring + top-k through the engine, in query blocks.
            #    A regional build dequantizes each row under its own list's
            #    constants: codes of different lists are different integer
            #    spaces
            if rg is None:
                qq = self.prepare_queries(qf)
                parts = [engine.topk_among(qq[s:s + rows], self.store,
                                           cand[s:s + rows], k, self.metric,
                                           mask=fmask)
                         for s in range(0, nq, rows)]
                stats = {"kind": "ivf", "nprobe": nprobe,
                         **engine.search_stats(self.store, candidates=width,
                                               chunks=nprobe,
                                               rows_read=nq * width)}
            else:
                parts = [engine.topk_among_regional(
                    qf[s:s + rows], self.store, rg.scale, rg.zero, rg.assign,
                    cand[s:s + rows], k, self.metric, mask=fmask)
                    for s in range(0, nq, rows)]
                stats = {"kind": "ivf", "nprobe": nprobe, "chunks": nprobe,
                         **engine.regional_stats(self.store, cand)}
            scores = torch.cat([s for s, _ in parts])
            ids = torch.cat([i for _, i in parts])
            return B.SearchResult(scores, ids, {**stats, **fstats})

        return run

    def _filter_masks(self, sp):
        """(row mask [n] | None, probe mask [nlist] | None, filter stats)
        for ``sp.filter``, on the index's device.  The probe mask marks
        lists with at least one allowed member (reference ``ivf.py``
        ``_filter_masks``)."""
        fmask, fstats = B.filter_mask(sp, self.n, self.device)
        if fmask is None:
            return None, None, {}
        memb = self.lists >= 0
        allowed = memb & fmask[self.lists.clamp_min(0).long()]
        lmask = allowed.any(dim=1)
        fstats["filter_lists_skipped"] = int((~lmask).sum())
        return fmask, lmask, fstats

    def searcher(self, k: int, params: Optional[B.SearchParams] = None, **kw):
        from repro_torch.knn.searcher import Searcher

        return Searcher(self, k, params, **kw)

    def search(self, queries, k: int, params: Optional[B.SearchParams] = None,
               *, nprobe: int | None = None) -> B.SearchResult:
        """One-shot plan-and-run: probe the nprobe best lists per query,
        exact-score the members.  Returns ``SearchResult`` [Q, k]."""
        from repro_torch.knn import searcher as S

        sp = (params or B.SearchParams()).merged(nprobe=nprobe)
        return S.one_shot(self, queries, k, sp)

    # -- accounting ---------------------------------------------------------
    def memory_bytes(self) -> int:
        base = self.store.memory_bytes()
        base += int(self.centroids.numel()) * 4 + int(self.lists.numel()) * 4
        if self.rerank_store is not None:
            base += self.rerank_store.memory_bytes()
        if self.regions is not None:
            base += self.regions.memory_bytes()
        return base

    def region_drift(self, live_corpus):
        """Per-list calibration drift of a live corpus against the fitted
        per-list constants ([nlist] float64; +inf marks an empty list on
        either side).  Live rows are assigned by the build's centroids."""
        if self.regions is None:
            raise ValueError(
                "region_drift needs a per-region build — construct the "
                "index with an '...,regions' factory (e.g. 'ivf64,lpq8,regions')"
            )
        live = to_tensor(live_corpus, device=self.device, dtype=torch.float32)
        return self.regions.drift_report(live, _assign(live, self.centroids))

    # -- disk round-trip ---------------------------------------------------
    def save(self, path) -> None:
        arrays, meta = self.store.state()
        if self.rerank_store is not None:
            rr_a, rr_m = self.rerank_store.state(prefix="rr_")
            arrays.update(rr_a)
            meta.update(rr_m)
        if self.regions is not None:
            rg_a, rg_m = self.regions.state(prefix="rg_")
            arrays.update(rg_a)
            meta.update(rg_m)
        B.save_state(
            path,
            {"centroids": self.centroids, "lists": self.lists, **arrays},
            {"kind": "ivf", "metric": self.metric, "quantized": self.quantized,
             "n": self.n, "nlist": self.nlist, "max_list": self.max_list,
             **meta},
        )

    @staticmethod
    def from_state(arrays, meta, device=None) -> "IVFIndex":
        """Rebuild from (arrays, meta) as ``save`` writes them."""
        dev = resolve_device(device)
        return IVFIndex(
            metric=meta["metric"], nlist=int(meta["nlist"]),
            max_list=int(meta["max_list"]),
            centroids=to_tensor(arrays["centroids"], device=dev,
                                dtype=torch.float32).contiguous(),
            lists=to_tensor(arrays["lists"], device=dev,
                            dtype=torch.int32).contiguous(),
            store=engine.CodeStore.from_state(arrays, meta, device=dev),
            rerank_store=(engine.CodeStore.from_state(arrays, meta,
                                                      prefix="rr_", device=dev)
                          if "rr_store" in meta else None),
            regions=(RegionQuant.from_state(arrays, meta, prefix="rg_",
                                            device=dev)
                     if "rg_regions" in meta else None),
        )

    @staticmethod
    def load(path, device=None) -> "IVFIndex":
        arrays, meta = B.load_state(path)
        return IVFIndex.from_state(arrays, meta, device=device)
