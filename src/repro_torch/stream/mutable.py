"""``MutableIndex`` — LSM-style upsert/delete behind every ported index
kind (port of ``repro.stream.mutable``).

Registered as kind ``"stream"`` with factory grammar
``stream(<inner factory>)[+rN]``: the inner factory names the kind each
sealed segment is built as (``stream(flat,lpq4)``, ``stream(ivf256,lpq8)``,
``stream(hnsw32,lpq8)+r32`` ...).  Writes go to a host fp32 ``Memtable``;
reaching the seal threshold freezes the buffered rows into an immutable
``Segment`` (an inner index on the index's device, with its own row-id
base and Eq. 1 constants); deletes tombstone rows wherever they live; the
``Compactor`` merges small segments, drops tombstones and re-quantizes
when ``calibration_drift`` against the ``StreamingStats`` insert tracker
exceeds the policy threshold (DESIGN.md §10).

Search is a ``multi_source_plan`` (knn/searcher.py): every segment's own
plan plus a flat fp32 memtable scan, tombstones (and a filter) masked at
merge level, candidates from differently calibrated segments re-scored in
one space against the raw payloads (which is also the ``+rN`` rerank
tail), and internal row ids mapped back to external ids.  A plan, and so
a ``Searcher``, snapshots the index at plan time; mutations become
visible to the next plan.

Exact-parity invariant: surviving rows keep arrival order through seal
and compaction, and full compaction re-learns constants from exactly
those rows, so ``compact(full=True)`` leaves one segment bit-identical
to a from-scratch inner build on ``live_items()``, and single-source
search passes the inner plan's scores and ids straight through.

Keys: the reference keeps a ``jax.random`` key and splits it for every
seal and compaction.  The port keeps a ``uint32[2]`` key, saved as
``rng_key`` with the reference's dtype and shape, and derives each
build's int seed by its own split (blake2b of the key: two words are the
next key, a third the seed), so the same key gives the same seeds on every
device, though not the reference's draws.  Statistics (``live_stats``,
segment calibrations) are reduced on the host CPU whatever the device.

Every kind but ``stream`` may be the inner kind, a cascade too
(``stream(cascade(flat,lpq8|r32))``: each sealed segment is a cascade).
Not ported yet: ``placement`` and a ``mesh=`` plan (ROADMAP queue A14),
which raise naming their item.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch import engine
from repro_torch.core import stats as St
from repro_torch.device import resolve_device, to_tensor
from repro_torch.knn import base as B
from repro_torch.knn import registry
from repro_torch.knn.spec import (
    IndexSpec,
    QuantSpec,
    parse_factory,
    resolve_build_spec,
)
from repro_torch.stream.compactor import CompactionPolicy, Compactor
from repro_torch.stream.manifest import Manifest
from repro_torch.stream.memtable import Memtable, as_id_array
from repro_torch.stream.segment import Segment

DEFAULT_SEAL_THRESHOLD = 4096

_MESH = ("stream placement and mesh plans are not ported yet: ROADMAP "
         "queue A14 (dist/)")


def as_key(key) -> np.ndarray:
    """None -> [0, 0]; an int s -> [0, s] (the raw form of the reference's
    ``PRNGKey(s)`` for 0 <= s < 2^32); anything else as a uint32[2]."""
    if key is None:
        return np.zeros(2, np.uint32)
    if isinstance(key, (int, np.integer)):
        return np.array([0, int(key) & 0xFFFFFFFF], np.uint32)
    out = np.asarray(key).astype(np.uint32).reshape(-1)
    if out.shape != (2,):
        raise ValueError(f"a stream key is uint32[2], got shape {out.shape}")
    return out


def split_key(key: np.ndarray) -> tuple[np.ndarray, int]:
    """(next key, int seed) from a uint32[2] key: blake2b of its bytes,
    words 0-1 the next key, word 2 (31 bits) the seed."""
    h = hashlib.blake2b(np.asarray(key, "<u4").tobytes(), digest_size=16)
    words = np.frombuffer(h.digest(), "<u4")
    return words[:2].astype(np.uint32), int(words[2]) & 0x7FFFFFFF


@dataclasses.dataclass
class PendingCompaction:
    """A compaction prepared off-lock, awaiting its atomic swap.

    ``group`` holds the identity of the input segments (the swap refuses
    to apply if any has since been replaced), ``live_snapshot`` their
    tombstone bitmaps at snapshot time (deletes that land during the
    build are re-applied to ``merged`` at swap time), ``merged`` the
    built replacement (None = everything was dead), ``epoch`` the
    manifest epoch of the snapshot.
    """

    group: list
    live_snapshot: list[np.ndarray]
    merged: Optional[Segment]
    recalibrated: bool
    epoch: int
    full: bool = False


@registry.register("stream")
class MutableIndex:
    """A mutable, segmented wrapper around any ported index kind."""

    #: the Searcher resolves rerank to a depth and passes it to ``plan``;
    #: the multi-source merge re-scores against the raw payloads itself
    #: (searcher.Rerank with store=None)
    handles_rerank = True

    def __init__(
        self,
        *,
        d: int,
        metric: str,
        inner_factory: str,
        seal_threshold: int = DEFAULT_SEAL_THRESHOLD,
        rerank_bits: Optional[int] = None,
        policy: Optional[CompactionPolicy] = None,
        auto_compact: bool = True,
        key=None,
        manifest: Optional[Manifest] = None,
        memtable: Optional[Memtable] = None,
        live_stats: Optional[St.StreamingStats] = None,
        inner_overrides: Optional[dict] = None,
        device=None,
    ):
        inner = parse_factory(inner_factory, metric=metric)
        if inner.kind == "stream":
            raise ValueError("stream cannot wrap stream")
        if inner.rerank_bits is not None:
            raise ValueError(
                "per-segment rerank stores are redundant — the wrapper "
                "keeps raw payloads; put +rN on the stream spec"
            )
        self.d = int(d)
        self.metric = inner.metric
        self.inner_factory = inner.to_factory()
        self.inner_overrides = dict(inner_overrides or {})
        self.seal_threshold = int(seal_threshold)
        self.rerank_bits = rerank_bits
        self.policy = policy or CompactionPolicy(small_rows=seal_threshold)
        self.auto_compact = bool(auto_compact)
        self.device = resolve_device(device)
        self.manifest = manifest or Manifest()
        self.memtable = memtable or Memtable(d, seal_threshold)
        self.live_stats = live_stats or St.StreamingStats(d)
        self.compactor = Compactor(self.inner_factory, self.metric,
                                   self.policy, self.inner_overrides,
                                   device=self.device)
        self._key = as_key(key)
        self.counters = {"seals": 0, "compactions": 0, "recalibrations": 0,
                         "upserts": 0, "deletes": 0, "swap_conflicts": 0,
                         "rerank_refreshes": 0}
        # (key, CodeStore) memo of the merge re-score store: its payload
        # changes only when the segment set swaps (manifest epoch) or the
        # memtable ingests (upsert counter); deletes flip bitmaps only
        self._merge_cache: Optional[tuple[tuple[int, int],
                                          engine.CodeStore]] = None
        # serializes writes, seals and compaction swaps against each other
        # and against plan-time snapshot assembly; reentrant because
        # compact -> _seal -> maybe_compact nests
        self._lock = threading.RLock()

    # -- construction ------------------------------------------------------
    @staticmethod
    def build(
        corpus,
        spec: IndexSpec | str | None = None,
        *,
        key=None,
        device=None,
        metric: str = "ip",
    ) -> "MutableIndex":
        """Bulk-load ``corpus`` (external ids 0..n-1) into one sealed
        segment on ``device`` (default: the GPU), so a fresh ``stream(X)``
        build scores exactly like a plain ``X`` build until the first
        mutation.

        Build params (via spec / overrides): ``inner`` (inner factory,
        default ``"flat"``), ``seal_threshold``, ``max_segments``,
        ``drift_threshold``, ``auto_compact``; every other one rides
        through to each inner segment build.  ``key``: None, an int or a
        uint32[2] key (see the module docstring).
        """
        spec, p = resolve_build_spec(
            "stream", spec, metric=metric, inner="flat",
            seal_threshold=DEFAULT_SEAL_THRESHOLD, max_segments=8,
            drift_threshold=0.5, auto_compact=True,
        )
        corpus = to_tensor(corpus, dtype=torch.float32).cpu().numpy()
        seal_threshold = int(p["seal_threshold"])
        own = {"inner", "seal_threshold", "max_segments", "drift_threshold",
               "auto_compact", "small_rows"}
        idx = MutableIndex(
            d=corpus.shape[1],
            metric=spec.metric,
            inner_factory=p["inner"],
            seal_threshold=seal_threshold,
            rerank_bits=spec.rerank_bits,
            policy=CompactionPolicy(
                max_segments=int(p["max_segments"]),
                small_rows=int(p.get("small_rows") or seal_threshold),
                drift_threshold=float(p["drift_threshold"]),
            ),
            auto_compact=bool(p["auto_compact"]),
            key=key,
            inner_overrides={k: v for k, v in p.items() if k not in own},
            device=device,
        )
        if corpus.shape[0]:
            idx.live_stats.update(torch.from_numpy(corpus))
            idx.manifest.add(
                Segment.seal(corpus, np.arange(corpus.shape[0]),
                             idx._inner_spec(), key=idx._next_key(),
                             device=idx.device)
            )
            idx.counters["seals"] += 1
        return idx

    def _inner_spec(self, params=None) -> IndexSpec:
        spec = parse_factory(self.inner_factory, metric=self.metric)
        if self.inner_overrides:
            spec = spec.with_overrides(**self.inner_overrides)
        if params is not None:
            spec = dataclasses.replace(spec,
                                       quant=spec.quant.with_params(params))
        return spec

    def _next_key(self) -> int:
        self._key, seed = split_key(self._key)
        return seed

    # -- accounting --------------------------------------------------------
    @property
    def n(self) -> int:
        """Live (searchable) rows."""
        return self.manifest.live_rows + self.memtable.live_count

    @property
    def epoch(self) -> int:
        """Manifest epoch: bumps on every structural change (seal,
        compaction swap, a delete that hits a segment)."""
        return self.manifest.epoch

    @property
    def quantized(self) -> bool:
        return "lpq" in self.inner_factory

    @property
    def params(self):
        """The first segment's Eq. 1 constants (per-segment constants are
        the point of the subsystem: see ``stats()``)."""
        segs = self.manifest.segments
        return getattr(segs[0].index, "params", None) if segs else None

    @property
    def data(self):
        """The first segment's code payload."""
        segs = self.manifest.segments
        if not segs:
            return None
        store = getattr(segs[0].index, "store", None)
        return store.data if store is not None else None

    @property
    def codes(self):
        return self.data if self.quantized else None

    def memory_bytes(self) -> int:
        return self.manifest.memory_bytes() + self.memtable.memory_bytes()

    def _drifts(self) -> tuple[list[float], float]:
        live = self.live_stats.stats
        drifts = [seg.drift(live) for seg in self.manifest.segments]
        finite = [x for x in drifts if np.isfinite(x)]
        return drifts, (max(finite) if finite else 0.0)

    def stats(self) -> dict:
        """Manifest-level accounting incl. the per-segment drift metric."""
        drifts, max_drift = self._drifts()
        return {
            "kind": "stream",
            "inner": self.inner_factory,
            "segments": len(self.manifest.segments),
            "segment_rows": [seg.n for seg in self.manifest.segments],
            "rows": self.manifest.total_rows + self.memtable.live_count,
            "live": self.n,
            "tombstones": self.manifest.tombstones,
            "memtable_rows": self.memtable.live_count,
            "epoch": self.manifest.epoch,
            "drift": drifts,
            "max_drift": max_drift,
            **self.counters,
        }

    # -- writes ------------------------------------------------------------
    def upsert(self, ids, vectors) -> int:
        """Insert-or-replace rows by external id; returns rows written.
        Replaced copies in sealed segments become tombstones; the new
        rows are searchable from the next plan."""
        with self._lock:
            vectors = to_tensor(vectors, dtype=torch.float32).cpu().numpy()
            ids = self.memtable.upsert(ids, vectors)
            self.manifest.delete(ids)            # shadow sealed copies
            self.live_stats.update(torch.from_numpy(vectors))
            self.counters["upserts"] += int(ids.size)
            while self.memtable.full:
                self._seal()
            return int(ids.size)

    def delete(self, ids) -> int:
        """Tombstone rows by external id wherever they live; returns how
        many live rows were deleted."""
        with self._lock:
            ids = as_id_array(ids)
            hit = self.memtable.delete(ids) + self.manifest.delete(ids)
            self.counters["deletes"] += hit
            return hit

    def _seal(self) -> None:
        with self._lock:
            vecs, ids = self.memtable.snapshot()
            self.memtable.clear()
            if not vecs.shape[0]:
                return
            self.manifest.add(
                Segment.seal(vecs, ids, self._inner_spec(),
                             key=self._next_key(), device=self.device)
            )
            self.counters["seals"] += 1
            if self.auto_compact:
                self.maybe_compact()

    # -- compaction --------------------------------------------------------
    def seal(self) -> None:
        """Flush the memtable into a segment now (below-threshold seal)."""
        self._seal()

    def maybe_compact(self) -> bool:
        """One policy-driven compaction round, if the manifest calls for
        it (> max_segments).  Returns whether a merge ran."""
        if not self.compactor.should_compact(self.manifest.segments):
            return False
        return self.compact()

    def compact(self, full: bool = False,
                recalibrate: Optional[bool] = None) -> bool:
        """Merge segments: the picked group (policy), or with ``full`` the
        memtable plus every segment into one.

        ``recalibrate`` None lets the drift policy decide (full compaction
        defaults to True: re-learn Eq. 1 constants from exactly the
        surviving rows, the from-scratch-parity path); False forces
        constant reuse.  Returns whether anything changed.  Synchronous;
        :meth:`compact_snapshot` + :meth:`apply_compaction` run the build
        off the lock."""
        with self._lock:
            if full:
                self._seal()
                group = list(self.manifest.segments)
                if not group:
                    return False
                merged, recal = self.compactor.merge(
                    group, live_stats=self.live_stats.stats,
                    key=self._next_key(),
                    recalibrate=True if recalibrate is None else recalibrate,
                )
            else:
                group = self.compactor.pick_group(self.manifest.segments)
                if not group:
                    return False
                merged, recal = self.compactor.merge(
                    group, live_stats=self.live_stats.stats,
                    key=self._next_key(), recalibrate=recalibrate,
                )
            self.manifest.replace(group, [merged] if merged else [])
            self.counters["compactions"] += 1
            self.counters["recalibrations"] += int(recal)
            return True

    # -- background compaction (snapshot -> build off-lock -> atomic swap) -
    def compact_snapshot(
        self, full: bool = False, recalibrate: Optional[bool] = None
    ) -> Optional[PendingCompaction]:
        """Under the write lock, pick the group and freeze its surviving
        rows (with the recalibrate verdict, tombstone bitmaps and epoch);
        then, with the lock released, build the merged segment.  Returns a
        :class:`PendingCompaction` for :meth:`apply_compaction`, or None
        when there is nothing to do."""
        with self._lock:
            if full:
                self._seal()
                group = list(self.manifest.segments)
                recal = True if recalibrate is None else recalibrate
            else:
                group = self.compactor.pick_group(self.manifest.segments)
                recal = recalibrate
            if not group:
                return None
            live_snapshot = [seg.live.copy() for seg in group]
            frozen = self.compactor.freeze(
                group, live_stats=self.live_stats.stats, recalibrate=recal
            )
            epoch = self.manifest.epoch
            key = self._next_key()
        # -- off-lock: the expensive part (inner build / Eq. 1 re-fit) ----
        if frozen is None:
            merged, recalibrated = None, bool(recal)
        else:
            merged = self.compactor.build(frozen, key=key)
            recalibrated = frozen.recalibrated
        return PendingCompaction(group=group, live_snapshot=live_snapshot,
                                 merged=merged, recalibrated=recalibrated,
                                 epoch=epoch, full=bool(full))

    def apply_compaction(self, pending: PendingCompaction) -> bool:
        """The atomic manifest swap.  Under the write lock: refuse (a
        ``swap_conflict``, False) if an input segment is gone, re-apply
        tombstones that landed during the build, then swap the group for
        the merged segment in one ``manifest.replace``."""
        with self._lock:
            current = self.manifest.segments
            if any(seg not in current for seg in pending.group):
                self.counters["swap_conflicts"] += 1
                return False
            merged = pending.merged
            if merged is not None:
                newly_dead = [
                    seg.ext_ids[snap & ~seg.live]
                    for seg, snap in zip(pending.group, pending.live_snapshot)
                ]
                dead_ids = np.concatenate(newly_dead) if newly_dead else None
                if dead_ids is not None and dead_ids.size:
                    merged.delete(dead_ids)
            self.manifest.replace(pending.group, [merged] if merged else [])
            self.counters["compactions"] += 1
            self.counters["recalibrations"] += int(pending.recalibrated)
            return True

    def live_items(self) -> tuple[np.ndarray, np.ndarray]:
        """(ext_ids [n], vectors [n, d]) of every live row in internal
        id-space (arrival) order: the corpus an equivalent from-scratch
        build would be given."""
        parts_v, parts_i = [], []
        for seg in self.manifest.segments:
            v, i = seg.survivors()
            parts_v.append(v)
            parts_i.append(i)
        mv, mi = self.memtable.snapshot()
        parts_v.append(mv)
        parts_i.append(mi)
        return np.concatenate(parts_i), np.concatenate(parts_v)

    # -- merge re-score store (cached) --------------------------------------
    def _merge_store_key(self) -> tuple[int, int]:
        return (int(self.manifest.epoch), int(self.counters["upserts"]))

    def _build_merge_store(self, mvecs, m: int) -> engine.CodeStore:
        """The merge re-score store over every raw payload (sealed
        segments + memtable tail) on the index's device.  Caller holds
        the lock."""
        if self.rerank_bits == 8:
            # int8 merge codes need constants learned over the union
            parts = ([self.manifest.raw_concat()]
                     if self.manifest.segments else [])
            if m:
                parts.append(mvecs)
            return QuantSpec(bits=8).build_store(
                to_tensor(np.concatenate(parts), device=self.device))
        # None / 32 -> exact fp32
        return engine.CodeStore.concat(
            [engine.CodeStore.dense(seg.raw, device=self.device)
             for seg in self.manifest.segments]
            + ([engine.CodeStore.dense(mvecs, device=self.device)]
               if m else [])
        )

    def _merge_store_cached(self, mvecs, m: int) -> engine.CodeStore:
        key = self._merge_store_key()
        if self._merge_cache is not None and self._merge_cache[0] == key:
            return self._merge_cache[1]
        self._merge_cache = None             # free the stale store first
        store = self._build_merge_store(mvecs, m)
        self._merge_cache = (key, store)
        self.counters["rerank_refreshes"] += 1
        return store

    def refresh_rerank_store(self) -> bool:
        """Rebuild the merge re-score store now if it is stale, so the
        cost lands here and not in the next plan.  Returns True when a
        rebuild happened."""
        with self._lock:
            key = self._merge_store_key()
            if self._merge_cache is not None and self._merge_cache[0] == key:
                return False
            mvecs, _mids = self.memtable.snapshot()
            m = int(mvecs.shape[0])
            if not self.manifest.segments and not m:
                return False
            self._merge_cache = None
            self._merge_cache = (key, self._build_merge_store(mvecs, m))
            self.counters["rerank_refreshes"] += 1
            return True

    # -- query -------------------------------------------------------------
    def placement(self, n_shards: int):
        raise NotImplementedError(_MESH)

    def plan(
        self,
        k: int,
        params: Optional[B.SearchParams] = None,
        *,
        mesh=None,
        placement=None,
        rerank_depth: Optional[int] = None,
    ):
        """Snapshot the manifest + memtable into a multi-source runner.

        Each sealed segment contributes its inner kind's own plan at depth
        ``(rerank_depth or k) + masked rows of the segment`` (tombstones
        and filtered-out rows), the memtable a flat fp32 scan; the merge
        re-scores candidates against the raw payloads at ``rerank_bits``
        precision whenever there is more than one source or an explicit
        rerank depth (``knn.searcher.multi_source_plan``).
        """
        from repro_torch.knn.flat import FlatIndex
        from repro_torch.knn.searcher import multi_source_plan

        if mesh is not None or placement is not None:
            raise NotImplementedError(_MESH)
        sp = (params or B.SearchParams()).validate()
        depth = rerank_depth or k
        # the whole snapshot assembly holds the write lock: a compaction
        # swap must never interleave between reading the segment list and
        # the concatenated id / live / raw views
        with self._lock:
            mvecs, mids = self.memtable.snapshot()
            m = int(mvecs.shape[0])
            id_map_np = self.manifest.id_map()
            live_np = self.manifest.live_map()
            if m:
                id_map_np = np.concatenate([id_map_np, mids])
                live_np = np.concatenate([live_np, np.ones(m, bool)])

            # filter (DESIGN.md §16): the predicate is over EXTERNAL ids,
            # but segment plans speak segment-local rows, so it is taken
            # off the inner plans and composed with the tombstone bitmap
            # here (live & filter, one internal-space bitmap: a filtered
            # row is masked exactly like a dead one)
            fstats = {}
            if sp.filter is not None:
                horizon = (int(id_map_np.max()) + 1 if id_map_np.size else 0)
                ext_mask = np.asarray(sp.filter.aligned(horizon))
                if id_map_np.size:
                    live_np = live_np & ext_mask[id_map_np]
                fstats = {"filter_selectivity":
                          round(sp.filter.selectivity, 6)}
                sp_inner = dataclasses.replace(sp, filter=None)
            else:
                sp_inner = sp

            sources = []
            for seg, base in zip(self.manifest.segments,
                                 self.manifest.bases()):
                # over-fetch by this segment's masked rows (tombstones AND
                # filtered-out rows), so k surviving rows reach the merge
                # on exact sources
                masked = int(seg.n - live_np[base:base + seg.n].sum())
                kj = min(seg.n, depth + masked)
                sources.append((seg.index.plan(kj, sp_inner), base, kj))
            if m:
                base_m = self.manifest.total_rows
                masked_m = int(m - live_np[base_m:base_m + m].sum())
                k_mem = min(m, depth + masked_m)
                mem_index = FlatIndex(
                    metric=self.metric,
                    store=engine.CodeStore.dense(mvecs, device=self.device),
                )
                sources.append((mem_index.plan(k_mem, sp_inner), base_m,
                                k_mem))

            rescore = len(sources) > 1 or rerank_depth is not None
            merge_store = None
            if rescore and sources:
                merge_store = self._merge_store_cached(mvecs, m)

            _drifts, max_drift = self._drifts()
            stats_extra = {
                "segments": len(self.manifest.segments),
                "memtable_rows": m,
                "tombstones": self.manifest.tombstones,
                "epoch": self.manifest.epoch,
                "max_drift": max_drift,
                **fstats,
            }
        return multi_source_plan(
            sources,
            k=k,
            metric=self.metric,
            id_map=torch.from_numpy(id_map_np.astype(np.int32)).to(
                self.device),
            live=torch.from_numpy(live_np).to(self.device),
            merge_store=merge_store,
            rescore=rescore and merge_store is not None,
            stats_extra=stats_extra,
        )

    def searcher(self, k: int, params: Optional[B.SearchParams] = None, **kw):
        from repro_torch.knn.searcher import Searcher

        return Searcher(self, k, params, **kw)

    def search(self, queries, k: int,
               params: Optional[B.SearchParams] = None) -> B.SearchResult:
        """One-shot plan-and-run over the current state (scores [Q, k]
        f32, external ids [Q, k] i32, -1 = no hit)."""
        from repro_torch.knn import searcher as S

        return S.one_shot(self, queries, k, params)

    # -- disk round-trip ---------------------------------------------------
    def save(self, path) -> None:
        """The reference's npz layout: segments with their inner blobs,
        the memtable, the live stats and ``rng_key`` (uint32[2])."""
        arrays, meta = self.manifest.state()
        mvecs, mids = self.memtable.snapshot()
        arrays.update({"mem_vecs": mvecs, "mem_ids": mids})
        arrays.update(St.stats_arrays("ls_", self.live_stats.stats))
        arrays["rng_key"] = np.asarray(self._key, np.uint32)
        B.save_state(path, arrays, {
            "kind": "stream",
            "metric": self.metric,
            "inner": self.inner_factory,
            "d": self.d,
            "n": self.n,
            "seal_threshold": self.seal_threshold,
            "rerank_bits": self.rerank_bits,
            "auto_compact": self.auto_compact,
            "policy": dataclasses.asdict(self.policy),
            "counters": self.counters,
            "inner_overrides": self.inner_overrides,
            **meta,
        })

    @staticmethod
    def from_state(arrays, meta, device=None) -> "MutableIndex":
        """Rebuild from (arrays, meta) as either package's ``save`` writes
        them; each segment's inner blob loads through its kind's port."""
        dev = resolve_device(device)
        d = int(meta["d"])
        idx = MutableIndex(
            d=d,
            metric=meta["metric"],
            inner_factory=meta["inner"],
            seal_threshold=int(meta["seal_threshold"]),
            rerank_bits=meta["rerank_bits"],
            policy=CompactionPolicy(**meta["policy"]),
            auto_compact=bool(meta["auto_compact"]),
            key=np.asarray(arrays["rng_key"], np.uint32),
            manifest=Manifest.from_state(arrays, meta, device=dev),
            live_stats=St.StreamingStats(d).merge(
                St.stats_from_arrays("ls_", arrays)),
            inner_overrides=meta.get("inner_overrides") or {},
            device=dev,
        )
        mvecs = np.asarray(arrays["mem_vecs"], np.float32)
        if mvecs.shape[0]:
            idx.memtable.upsert(np.asarray(arrays["mem_ids"]), mvecs)
        idx.counters.update(meta["counters"])
        return idx

    @staticmethod
    def load(path, device=None) -> "MutableIndex":
        arrays, meta = B.load_state(path)
        return MutableIndex.from_state(arrays, meta, device=device)
