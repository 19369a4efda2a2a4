"""The N-stage scoring cascade, kind ``"cascade"`` (port of
``repro.cascade.index``).

``cascade(pq16x4|lpq8|r32)`` generalizes the ``+rN`` rerank tail: the
*head* (any non-stream factory) prunes the corpus to a candidate budget,
each later stage re-scores the survivors at its own precision through
``engine.refine_among`` (the rerank tail's body), and the final stage
settles the top-k.  A final ``r32`` stage at budget n therefore equals the
exact fp32 search.

Budgets are plan-time knobs: ``SearchParams.budgets[i]`` candidates enter
refinement stage i; without them the final budget is the rerank depth the
Searcher resolves and each earlier stage fetches 4x more, clamped to the
corpus.  Explicit budgets must be non-increasing and at least k (a
``ValueError`` says which stage breaks it).  A filter reaches the head's
plan as given and is applied again at every stage.

Per-stage stats ride in ``SearchResult.stats["stages"]`` as a tuple of
``(label, candidates, bytes_read, bits)`` rows.  Refinement stages score
with plain torch (``topk_among``), as the reference does: no TPU kernel
stands behind them; the head runs its kind's kernels.  A cascade shards
wherever its head shards: on a mesh the head plans on it, and the stages
gather by id against their stores on the cascade's device.
"""

from __future__ import annotations

import io
import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import engine
from repro_torch.core.quant import QuantParams
from repro_torch.device import resolve_device, to_tensor
from repro_torch.knn import base as B
from repro_torch.knn import registry
from repro_torch.knn.spec import (
    _QUANT_RE,
    _RERANK_RE,
    IndexSpec,
    QuantSpec,
    parse_factory,
    resolve_build_spec,
)


def _build_stage_store(frag: str, corpus,
                       params: Optional[QuantParams] = None
                       ) -> engine.CodeStore:
    """One refinement stage's store from its normalized fragment: ``r32``
    keeps the corpus as is; ``r8`` and ``lpq<bits>`` learn their own Eq. 1
    constants (a stage does not inherit the head's clamp), or take
    ``params``."""
    mr = _RERANK_RE.match(frag)
    if mr:
        if int(mr.group(1)) == 32:
            return engine.CodeStore.dense(corpus)
        quant = QuantSpec(bits=8)
    else:
        mq = _QUANT_RE.match(frag)
        assert mq is not None, f"unparseable cascade stage {frag!r}"
        quant = QuantSpec(
            bits=int(mq.group(1)),
            scheme=mq.group(2) or "gaussian",
            sigmas=float(mq.group(3)) if mq.group(3) else 1.0,
        )
    if params is not None:
        quant = quant.with_params(params)
    return quant.build_store(corpus)


def _stage_label(frag: str, store: engine.CodeStore) -> str:
    return frag if store.bits < 32 else "r32"


@registry.register("cascade")
class CascadeIndex:
    """Head index + ordered refinement stores over one id space."""

    handles_rerank = True   # the plan owns every re-scoring pass

    def __init__(self, metric: str, head, stage_specs: tuple[str, ...],
                 stage_stores: tuple[engine.CodeStore, ...],
                 head_factory: Optional[str] = None):
        if not stage_stores:
            raise ValueError("a cascade needs at least one refinement stage")
        self.metric = metric
        self.head = head
        self.stage_specs = tuple(stage_specs)
        self.stage_stores = tuple(stage_stores)
        self._head_factory = head_factory

    # -- protocol surface --------------------------------------------------
    @property
    def n(self) -> int:
        return int(self.head.n)

    @property
    def d(self) -> Optional[int]:
        from repro_torch.knn.searcher import _query_dim

        return _query_dim(self.head)

    @property
    def device(self):
        return self.stage_stores[-1].device

    @property
    def rerank_bits(self) -> int:
        """Precision of the final (settling) stage: its presence makes the
        Searcher hand a rerank depth to ``plan``."""
        return int(self.stage_stores[-1].bits)

    @property
    def stages(self) -> str:
        """The normalized '|'-joined stage list (head first)."""
        head_factory = getattr(self.head, "factory", None) or self._head_factory
        return "|".join((head_factory, *self.stage_specs))

    # -- construction ------------------------------------------------------
    @staticmethod
    def build(corpus, spec: IndexSpec | str | None = None, *,
              key: int | None = None, device=None, metric: str = "ip",
              _given: Optional[dict[str, Any]] = None,
              **overrides) -> "CascadeIndex":
        """Build the head (with ``overrides`` and ``key``) and every stage
        store on ``device`` (default: the GPU).  ``_given`` may hold
        ``head_params`` (the head's Eq. 1 constants), ``head`` (the head
        kind's own ``_given``: centroids, codebooks ...) and
        ``stage_params`` (one ``QuantParams`` or None a refinement stage),
        made once elsewhere (another device's, or the reference's)."""
        spec, params = resolve_build_spec("cascade", spec, metric=metric)
        stages = str(params["stages"]).split("|")
        given = dict(_given or {})
        head_spec = parse_factory(stages[0], metric=spec.metric)
        head_factory = head_spec.to_factory()
        if given.get("head_params") is not None:
            head_spec = dataclasses.replace(head_spec, quant=head_spec.quant
                                            .with_params(given["head_params"]))
        # head build overrides (kmeans_iters, ef_construction ...) pass
        # through; 'stages' is the cascade's own parameter
        head_overrides = {k: v for k, v in overrides.items() if k != "stages"}
        if head_overrides:
            head_spec = head_spec.with_overrides(**head_overrides)
        dev = resolve_device(device)
        corpus = to_tensor(corpus, device=dev, dtype=torch.float32)
        head_kw = {"_given": given["head"]} if "head" in given else {}
        head = registry.get_impl(head_spec.kind).build(
            corpus, head_spec, key=key, device=dev, **head_kw)
        stage_params = given.get("stage_params") or (None,) * (len(stages) - 1)
        return CascadeIndex(
            metric=spec.metric, head=head, stage_specs=tuple(stages[1:]),
            stage_stores=tuple(_build_stage_store(f, corpus, p)
                               for f, p in zip(stages[1:], stage_params)),
            head_factory=head_factory,
        )

    # -- budgets -----------------------------------------------------------
    def resolve_budgets(self, k: int, explicit: Optional[tuple[int, ...]],
                        rerank_depth: Optional[int]) -> tuple[int, ...]:
        """Per-stage fetch depths: ``out[i]`` candidates enter refinement
        stage i (``out[0]`` is what the head returns); the final stage
        emits k.  Explicit budgets are checked to be non-increasing and at
        least k; derived ones are so by construction (final = the rerank
        depth, each earlier stage 4x wider, clamped to the corpus)."""
        n_stages = len(self.stage_stores)
        n, cap = self.n, max(self.n, k)
        if explicit is not None:
            if len(explicit) != n_stages:
                raise ValueError(
                    f"cascade has {n_stages} refinement stage(s) "
                    f"({'|'.join(self.stage_specs)}) but SearchParams.budgets "
                    f"has {len(explicit)} entries: {explicit!r} — one fetch "
                    "depth per refinement stage"
                )
            seq = tuple(int(b) for b in explicit) + (k,)
            for i in range(len(seq) - 1):
                if seq[i] < seq[i + 1]:
                    raise ValueError(
                        f"cascade budgets must be non-increasing and >= k: "
                        f"stage {i} fetches {seq[i]} candidates but the next "
                        f"stage needs {seq[i + 1]} (budgets={tuple(explicit)}, "
                        f"k={k}) — a refinement stage can only prune "
                        "candidates, never invent them"
                    )
            return tuple(min(b, cap) for b in seq[:-1])
        from repro_torch.knn.searcher import DEFAULT_RERANK_DEPTH

        last = (max(k, min(int(rerank_depth), cap))
                if rerank_depth is not None else DEFAULT_RERANK_DEPTH(k, n))
        out = [last]
        for _ in range(n_stages - 1):
            out.append(min(cap, out[-1] * 4))
        return tuple(reversed(out))

    # -- query -------------------------------------------------------------
    def placement(self, n_shards: int):
        """A cascade shards wherever its head shards: refinement stages
        gather by id against their stores."""
        from repro_torch.dist import placement as dplacement

        return dplacement.for_index(self.head, n_shards)

    def plan(self, k: int, params: Optional[B.SearchParams] = None, *,
             mesh=None, placement=None, rerank_depth: Optional[int] = None):
        """Freeze budgets and per-stage stores into one runner ``queries ->
        SearchResult``: the head prunes to ``budgets[0]``, each stage
        refines through ``engine.refine_among``."""
        sp = (params or B.SearchParams()).validate()
        budgets = self.resolve_budgets(k, sp.budgets, rerank_depth)
        # the head prunes under the filter (it gets sp as is) and every
        # stage masks its candidate slots again: a stage can only prune,
        # but the re-apply keeps that independent of the head's kind
        fmask, fstats = B.filter_mask(sp, self.n, self.device)
        head_runner = self.head.plan(budgets[0], sp, mesh=mesh,
                                     placement=placement)
        outs = tuple(budgets[1:]) + (k,)
        labels = tuple(_stage_label(f, st)
                       for f, st in zip(self.stage_specs, self.stage_stores))
        head_label = f"head:{self.head.kind}"

        def run(queries) -> B.SearchResult:
            q = to_tensor(queries, device=self.device, dtype=torch.float32)
            res = head_runner(q)
            stats = dict(res.stats)
            s, ids = res.scores, res.ids
            total_bytes = int(stats.get("bytes_read", 0))
            stage_rows = [(head_label, int(budgets[0]), total_bytes,
                           int(stats.get("bits", 32)))]
            for store, out_k, label in zip(self.stage_stores, outs, labels):
                s, ids, sst = engine.refine_among(q, store, ids, out_k,
                                                  self.metric, mask=fmask)
                total_bytes += sst["bytes_read"]
                stage_rows.append((label, sst["candidates"],
                                   sst["bytes_read"], sst["bits"]))
            stats.update(
                kind="cascade",
                bytes_read=total_bytes,
                stages=tuple(stage_rows),
                cascade_stages=1 + len(self.stage_stores),
                reranked=int(budgets[-1]),
                rerank_bits=self.rerank_bits,
                **fstats,
            )
            return B.SearchResult(s, ids, stats)

        return run

    def searcher(self, k: int, params: Optional[B.SearchParams] = None, **kw):
        from repro_torch.knn.searcher import Searcher

        return Searcher(self, k, params, **kw)

    def search(self, queries, k: int,
               params: Optional[B.SearchParams] = None) -> B.SearchResult:
        from repro_torch.knn import searcher as S

        return S.one_shot(self, queries, k, params)

    # -- accounting --------------------------------------------------------
    def memory_bytes(self) -> int:
        return int(self.head.memory_bytes()) + sum(
            st.memory_bytes() for st in self.stage_stores)

    # -- disk round-trip ---------------------------------------------------
    def save(self, path) -> None:
        buf = io.BytesIO()
        self.head.save(buf)
        arrays = {"cs_blob": np.frombuffer(buf.getvalue(), np.uint8)}
        meta = {"kind": "cascade", "metric": self.metric, "n": self.n,
                "stages": self.stages, "head_kind": self.head.kind}
        for i, st in enumerate(self.stage_stores):
            a, m = st.state(prefix=f"cs{i}_")
            arrays.update(a)
            meta.update(m)
        B.save_state(path, arrays, meta)

    @staticmethod
    def from_state(arrays, meta, device=None) -> "CascadeIndex":
        """Rebuild from (arrays, meta) as ``save`` writes them: the head
        from its nested npz (``cs_blob``), the stage stores from their
        ``cs<i>_`` fragments."""
        dev = resolve_device(device)
        blob = io.BytesIO(np.asarray(arrays["cs_blob"]).tobytes())
        head = registry.get_impl(meta["head_kind"]).load(blob, device=dev)
        stages = str(meta["stages"]).split("|")
        return CascadeIndex(
            metric=meta["metric"], head=head, stage_specs=tuple(stages[1:]),
            stage_stores=tuple(
                engine.CodeStore.from_state(arrays, meta, prefix=f"cs{i}_",
                                            device=dev)
                for i in range(len(stages) - 1)),
            head_factory=stages[0],
        )

    @staticmethod
    def load(path, device=None) -> "CascadeIndex":
        arrays, meta = B.load_state(path)
        return CascadeIndex.from_state(arrays, meta, device=device)
