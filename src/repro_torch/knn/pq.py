"""Product quantization (Jégou et al.) and its composition with the paper's
low-precision scheme (port of ``repro.knn.pq``).

  * :class:`PQIndex` — classic PQ: split d into M subspaces, k-means a
    2^bits-codeword codebook per subspace (``pq<M>`` = 256 codewords,
    ``pq<M>x4`` = 16 codewords with codes bit-packed two per byte, half
    the code bytes), store codes in an ``engine.PQStore``, score by ADC
    through ``engine.topk``.
  * ``lpq_tables=True`` (``pq<M>+lpq``, ``pq<M>,lpq8``) — the paper's
    "after the codebook mapping step" composition: the ADC lookup tables
    are quantized to int8 per query, so the scan sums integers in int32.
    On the card those arms run the fused ADC kernels B4 (256 codewords)
    and B5 (16 codewords, packed), which keep the int8 LUTs in shared
    memory and never write the [Q, N] ADC matrix.

Registered as kind ``"pq"``.  On a mesh, code rows shard in contiguous
blocks like the flat scan's (``PQIndex._sharded_plan``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch import engine
from repro_torch.core import pack as PK
from repro_torch.device import resolve_device, to_tensor
from repro_torch.knn import base as B
from repro_torch.knn import registry
from repro_torch.knn.ivf import kmeans
from repro_torch.knn.spec import IndexSpec, build_rerank_store, resolve_build_spec

#: [rows, K, d/M] entries one codeword-assignment chunk may hold (256 MB)
_ASSIGN_ENTRIES = 1 << 26


def _nearest_codeword(sub: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """argmin_j |sub - cb[j]|^2 per row (first index on ties), in row
    chunks: the reference's [N, K, d/M] difference tensor is 32 GB per
    subspace at 4M rows x 256 codewords x 8 dims."""
    rows = max(1, _ASSIGN_ENTRIES // (cb.shape[0] * cb.shape[1]))
    out = torch.empty(sub.shape[0], dtype=torch.uint8, device=sub.device)
    for s in range(0, sub.shape[0], rows):
        d2 = torch.sum((sub[s:s + rows, None, :] - cb[None]) ** 2, -1)
        out[s:s + rows] = torch.argmin(d2, -1).to(torch.uint8)
    return out


@registry.register("pq")
@dataclasses.dataclass(frozen=True)
class PQIndex:
    """A metric, one ``engine.PQStore`` and an optional rerank store."""

    metric: str
    store: engine.PQStore
    rerank_store: Optional[engine.CodeStore] = None

    # -- views --------------------------------------------------------------
    @property
    def m(self) -> int:
        return self.store.m

    @property
    def bits(self) -> int:
        """Codeword index width (4 or 8)."""
        return self.store.bits

    @property
    def n(self) -> int:
        return self.store.n

    @property
    def device(self) -> torch.device:
        return self.store.device

    @property
    def codes(self) -> torch.Tensor:
        return self.store.codes

    @property
    def codebooks(self) -> torch.Tensor:
        return self.store.codebooks

    @property
    def lpq_tables(self) -> bool:
        return self.store.lpq_tables

    # -- construction -----------------------------------------------------
    @staticmethod
    def build(
        corpus,
        spec: IndexSpec | str | None = None,
        *,
        m: int = 8,
        metric: str = "ip",
        bits: int = 8,
        lpq_tables: bool = False,
        key: int | None = None,
        kmeans_iters: int = 8,
        device=None,
        _given: Optional[dict[str, Any]] = None,
    ) -> "PQIndex":
        """Build on ``device`` (default: the GPU).  ``key`` is an int seed
        for the k-means inits (default 0); subspace j seeds its own
        generator from (key, j).  ``_given`` may hold ``codebooks`` ([m,
        2^bits, d/m] f32, from another build or device), which replace the
        k-means."""
        spec, p = resolve_build_spec(
            "pq", spec, metric=metric,
            m=m, bits=bits, lpq_tables=lpq_tables, kmeans_iters=kmeans_iters,
        )
        if p.get("regions"):
            # spec parsing rejects this; guard direct-kwargs construction too
            raise ValueError(
                "per-region Eq. 1 constants need a partitioned kind (ivf / "
                "hnsw / graph) — PQ codebooks already adapt per subspace, "
                "and its codes carry no region assignment"
            )
        m = int(p["m"])
        bits = int(p["bits"] or 8)
        # "pq64+lpq" / "pq64,lpq8": int8 ADC lookup tables
        lpq_tables = bool(p["lpq_tables"]) or spec.quant is not None
        kmeans_iters = int(p["kmeans_iters"])
        metric = spec.metric
        if metric == "angular":
            raise ValueError(
                "pq supports ip and l2 only — the ADC lookup tables have "
                "no per-row norm to rescale by (engine dispatch table)"
            )
        seed = 0 if key is None else int(key)
        corpus = to_tensor(corpus, device=resolve_device(device),
                           dtype=torch.float32)
        n, d = corpus.shape
        assert d % m == 0, (d, m)
        sub = corpus.reshape(n, m, d // m)
        if bits not in engine.PQ_CODE_BITS:
            raise ValueError(
                f"pq codeword width must be one of {engine.PQ_CODE_BITS} "
                f"bits (16- or 256-codeword codebooks), got {bits}"
            )
        n_codewords = 2 ** bits

        given = (_given or {}).get("codebooks")
        books, codes = [], []
        for j in range(m):
            sj = sub[:, j].contiguous()
            if given is not None:
                cb = to_tensor(given[j], device=corpus.device,
                               dtype=torch.float32)
            else:
                cb = kmeans(sj, min(n_codewords, n), seed * 1_000_003 + j,
                            iters=kmeans_iters)
            if cb.shape[0] < n_codewords:   # tiny corpora: pad codebook
                cb = torch.nn.functional.pad(
                    cb, (0, 0, 0, n_codewords - cb.shape[0]))
            books.append(cb)
            codes.append(_nearest_codeword(sj, cb))

        code_mat = torch.stack(codes, 1)
        if bits == 4:                        # honest width: two per byte
            code_mat = PK.pack_uint4(code_mat)
        store = engine.PQStore(
            n=n, m=m, bits=bits, lpq_tables=lpq_tables,
            codes=code_mat.contiguous(), codebooks=torch.stack(books),
        )
        return PQIndex(metric=metric, store=store,
                       rerank_store=build_rerank_store(spec, corpus))

    # -- query ------------------------------------------------------------
    def placement(self, n_shards: int):
        """Contiguous code-row blocks: ADC scans shard like flat scans."""
        from repro_torch.dist.placement import Placement

        return Placement.rows(self.n, n_shards)

    def plan(self, k: int, params: Optional[B.SearchParams] = None, *,
             mesh=None, placement=None):
        """Freeze (k, chunk) into an ADC-scan runner ``queries ->
        SearchResult``.  A rerank tail over a ``"pq16+lpq,r32"`` build is
        the classic PQ + refine pattern (the Searcher runs it).  With a
        mesh, code rows shard in contiguous blocks (``_sharded_plan``)."""
        if mesh is not None:
            return self._sharded_plan(k, params, mesh, placement)
        sp = params or B.SearchParams()
        # filter (DESIGN.md §16): the bitmap joins the ADC scan's fence
        # (B4 / B5's mask on the card; the fp32-LUT scan's otherwise)
        fmask, fstats = B.filter_mask(sp, self.n, self.device)

        def run(queries) -> B.SearchResult:
            s, i, stats = engine.topk(queries, self.store, k, self.metric,
                                      chunk=sp.chunk, mask=fmask)
            return B.SearchResult(
                s, i, {"kind": "pq", "m": self.m,
                       "lpq_tables": self.lpq_tables, **stats, **fstats},
            )

        return run

    def _sharded_plan(self, k, params, mesh, placement):
        """Row-block ADC scan over a mesh (DESIGN.md §15).

        The per-query LUT is built once, replicated (it is O(Q * M * K),
        the thing ADC keeps small; for ``lpq_tables`` Eq. 1-quantized per
        query), and each shard scans its block of code rows with its copy
        through ``engine.topk_from_lut``: on the card B4 (``pq*+lpq``) or
        B5 (``pq*x4,lpq8``) for the int8-LUT arms, the streaming scan for
        the fp32-LUT arms, as unsharded.  The filter bitmap is sliced with
        the rows.  Block order is id order and each shard's list breaks
        ties to its lowest row, so the shard-order merge reproduces the
        unsharded scan bit for bit.  A shard with no rows launches
        nothing and contributes ``(NEG, -1)``.
        """
        from repro_torch.dist.sharding import (corpus_shards, row_blocks,
                                               rows_placement, run_row_shards)

        sp = params or B.SearchParams()
        _axes, n_shards = corpus_shards(mesh)
        store = self.store
        n = store.n
        placement = rows_placement(placement, n, n_shards, "a pq plan")
        k_local = min(k, n, max(placement.unit_sizes, default=0))
        fmask, fstats = B.filter_mask(sp, n, self.device)
        blocks = row_blocks(placement, mesh)
        shards = []
        for lo, hi, dev in blocks:
            view = None if hi == lo else (
                dataclasses.replace(store, n=hi - lo,
                                    codes=store.codes[lo:hi].to(dev)),
                None if fmask is None else fmask[lo:hi].to(dev))
            shards.append((view, dev))
        merge_wire = n_shards * min(k, n) * 8

        def run(queries) -> B.SearchResult:
            lut = engine.scorer.pq_lut(queries, store, self.metric)

            def scan(view, dev):
                return engine.topk_from_lut(lut.to(dev), view[0], k_local,
                                            self.metric, chunk=sp.chunk,
                                            mask=view[1])

            s, i, agg = run_row_shards(shards, scan, lut.shape[0], k_local,
                                       k, n, [b[0] for b in blocks])
            stats = engine.search_stats(store, candidates=n,
                                        chunks=agg["chunks"], rows_read=0)
            stats.update(bytes_read=agg["bytes_read"], tuned=agg["tuned"])
            return B.SearchResult(s, i, {
                "kind": "pq", "m": self.m, "lpq_tables": self.lpq_tables,
                **stats, **fstats, "placement": placement.kind,
                "merge_wire_bytes": int(lut.shape[0]) * merge_wire,
            })

        return run

    def searcher(self, k: int, params: Optional[B.SearchParams] = None, **kw):
        from repro_torch.knn.searcher import Searcher

        return Searcher(self, k, params, **kw)

    def search(self, queries, k: int,
               params: Optional[B.SearchParams] = None) -> B.SearchResult:
        """One-shot plan-and-run ADC scan.  ``SearchParams.chunk`` sizes
        the scan tiles; PQ has no other search-time knob."""
        from repro_torch.knn import searcher as S

        return S.one_shot(self, queries, k, params)

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
            arrays = {**arrays, **rr_a}
            meta = {**meta, **rr_m}
        B.save_state(
            path, arrays,
            {"kind": "pq", "metric": self.metric, "m": self.m, "n": self.n,
             "lpq_tables": self.lpq_tables, **meta},
        )

    @staticmethod
    def from_state(arrays, meta, device=None) -> "PQIndex":
        """Rebuild from (arrays, meta) as ``save`` writes them."""
        dev = resolve_device(device)
        return PQIndex(
            metric=meta["metric"],
            store=engine.PQStore.from_state(arrays, meta, device=dev),
            rerank_store=(engine.CodeStore.from_state(arrays, meta,
                                                      prefix="rr_", device=dev)
                          if "rr_store" in meta else None),
        )

    @staticmethod
    def load(path, device=None) -> "PQIndex":
        arrays, meta = B.load_state(path)
        return PQIndex.from_state(arrays, meta, device=device)
