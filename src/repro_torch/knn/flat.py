"""Exact (exhaustive) nearest-neighbor search — the FAISS-IndexFlat
equivalent with the paper's low-precision storage (port of
``repro.knn.flat``): fp32 vectors, int8 codes (4x smaller) or bit-packed
int4 codes (8x smaller), all scored through ``engine.topk`` — on the card,
the fused score + top-k kernels B2 / B3.

Registered as kind ``"flat"``; factory strings ``"flat"``,
``"flat,lpq8@gaussian:3"``, ``"flat,lpq4"``, ``"flat,lpq4+r32"``.
A ``SearchParams.filter`` bitmap rides the scan's id-masking fence.  On a
mesh the scan shards in contiguous row blocks
(``knn.searcher.sharded_scan_plan``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import engine
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


@registry.register("flat")
@dataclasses.dataclass(frozen=True)
class FlatIndex:
    """Exhaustive index: a metric plus one engine ``CodeStore`` (plus an
    optional higher-precision rerank store for ``+rN`` builds)."""

    metric: str
    store: engine.CodeStore
    rerank_store: Optional[engine.CodeStore] = None

    @property
    def quantized(self) -> bool:
        return self.store.quantized

    @property
    def n(self) -> int:
        return self.store.n

    @property
    def device(self) -> torch.device:
        return self.store.device

    @property
    def params(self) -> Optional[Qz.QuantParams]:
        return self.store.params

    @property
    def codes(self) -> Optional[torch.Tensor]:
        """The quantized codes (None for an fp32 index)."""
        return self.store.data if self.store.quantized else None

    @property
    def vectors(self) -> Optional[torch.Tensor]:
        """The fp32 rows (None for a quantized index)."""
        return None if self.store.quantized else self.store.data

    # -- construction -----------------------------------------------------
    @staticmethod
    def build(
        corpus,
        spec: IndexSpec | str | None = None,
        *,
        key=None,
        device=None,
        metric: str = "ip",
        quantized: bool = False,
        bits: int = 8,
        scheme: str | Qz.Scheme = Qz.Scheme.GAUSSIAN,
        sigmas: float = 1.0,
        params: Optional[Qz.QuantParams] = None,
    ) -> "FlatIndex":
        """Build from an ``IndexSpec``/factory string or the legacy kwargs,
        on ``device`` (default: the GPU)."""
        del key  # deterministic build; accepted for protocol uniformity
        spec, _p = resolve_build_spec(
            "flat", spec, metric=metric,
            quant=quant_spec_from_kwargs(quantized, bits, scheme, sigmas, params),
        )
        if _p.get("regions"):
            raise ValueError(
                "per-region Eq. 1 constants need a partitioned kind (ivf / "
                "hnsw / graph) — the flat scan has no regions to key them on"
            )
        corpus = to_tensor(corpus, device=resolve_device(device),
                           dtype=torch.float32)
        store = (
            engine.CodeStore.dense(corpus)
            if spec.quant is None
            else spec.quant.build_store(corpus)
        )
        return FlatIndex(metric=spec.metric, store=store,
                         rerank_store=build_rerank_store(spec, corpus))

    @staticmethod
    def from_store(store: engine.CodeStore, metric: str) -> "FlatIndex":
        """Wrap an existing store (shared-payload builds, shard-local
        indexes carrying a row-id base)."""
        return FlatIndex(metric=metric, store=store)

    # -- query ------------------------------------------------------------
    def prepare_queries(self, queries) -> torch.Tensor:
        """h(q) of Definition 2: queries enter the quantized space too."""
        return self.store.encode_queries(queries)

    def placement(self, n_shards: int):
        """Contiguous row blocks: the flat scan's natural sharding."""
        from repro_torch.dist.placement import Placement

        return Placement.rows(self.n, n_shards)

    def plan(self, k: int, params: Optional[B.SearchParams] = None, *,
             mesh=None, placement=None):
        """Freeze (k, params) into a runner ``queries -> SearchResult``.

        With a mesh, the runner row-shards the store per ``placement``
        (row blocks) and merges the shard-local top-k lists once
        (``knn.searcher.sharded_scan_plan``)."""
        sp = params or B.SearchParams()
        # filter (DESIGN.md §16): external ids == row ids for a direct
        # build, so the bitmap aligns with the store as-is and rides the
        # engine's id-masking fence (B2 / B3's mask on the card)
        fmask, fstats = B.filter_mask(sp, self.n, self.device)
        if mesh is not None:
            from repro_torch.knn.searcher import sharded_scan_plan

            inner = sharded_scan_plan(self.store, self.metric, k, mesh,
                                      chunk=sp.chunk, placement=placement,
                                      mask=fmask)
            if not fstats:
                return inner

            def run_sharded(queries) -> B.SearchResult:
                res = inner(queries)
                return B.SearchResult(res.scores, res.ids,
                                      {**res.stats, **fstats})

            return run_sharded

        def run(queries) -> B.SearchResult:
            q = self.prepare_queries(queries)
            s, i, stats = engine.topk(q, self.store, k, self.metric,
                                      chunk=sp.chunk, prepared=True,
                                      mask=fmask)
            return B.SearchResult(s, i, {"kind": "flat", **stats, **fstats})

        return run

    def searcher(self, k: int, params: Optional[B.SearchParams] = None, **kw):
        from repro_torch.knn.searcher import Searcher

        return Searcher(self, k, params, **kw)

    def search(self, queries, k: int, params: Optional[B.SearchParams] = None,
               *, chunk: int | None = None) -> B.SearchResult:
        """One-shot plan-and-run (scores [Q, k] f32, ids [Q, k] i32)."""
        from repro_torch.knn import searcher as S

        sp = (params or B.SearchParams()).merged(chunk=chunk)
        return S.one_shot(self, queries, k, sp)

    # -- accounting (paper Table 1/2 memory column) -------------------------
    def memory_bytes(self) -> int:
        total = self.store.memory_bytes()
        if self.rerank_store is not None:
            total += self.rerank_store.memory_bytes()
        return total

    # -- disk round-trip ---------------------------------------------------
    def save(self, path) -> None:
        arrays, meta = self.store.state()
        if self.rerank_store is not None:
            rr_a, rr_m = self.rerank_store.state(prefix="rr_")
            arrays.update(rr_a)
            meta.update(rr_m)
        B.save_state(
            path, arrays,
            {"kind": "flat", "metric": self.metric,
             "quantized": self.quantized, "n": self.n, **meta},
        )

    @staticmethod
    def from_state(arrays, meta, device=None) -> "FlatIndex":
        """Rebuild from (arrays, meta) as ``save`` writes them."""
        dev = resolve_device(device)
        rr = (engine.CodeStore.from_state(arrays, meta, prefix="rr_",
                                          device=dev)
              if "rr_store" in meta else None)
        return FlatIndex(
            metric=meta["metric"],
            store=engine.CodeStore.from_state(arrays, meta, device=dev),
            rerank_store=rr,
        )

    @staticmethod
    def load(path, device=None) -> "FlatIndex":
        arrays, meta = B.load_state(path)
        return FlatIndex.from_state(arrays, meta, device=device)
