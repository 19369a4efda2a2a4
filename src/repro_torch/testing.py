"""Oracles for filtered search and the stream kind, shared by the port's
tests and ``chip_smoke.py`` so that one copy of each exists.

  * ``post_filter``: an index's own full ranking cut to the allowed rows.
  * ``tie_groups_equal`` / ``fp32_near_equal``: integer results equal up to
    order inside runs of equal scores; fp32 results within a relative
    tolerance of the row scale, ids equal outside near-ties.
  * ``build_with_writes``: a stream arm with upserts and deletes after its
    bulk load (works on any index object with ``upsert`` / ``delete``).
  * ``stream_lifecycle`` / ``lifecycles_equal``: one write sequence logged
    at eight checkpoints, and the comparison of two such logs (one device
    against another).
  * ``build_draws``: the random draws and float reductions of a cascade
    or regions arm built on the CPU, so that a build on the card starts
    from the same inputs.

Pure numpy on the host: results come in as numpy arrays.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

NEG = float(np.finfo(np.float32).min)


def post_filter(scores: np.ndarray, ids: np.ndarray, allow: np.ndarray,
                k: int) -> tuple[np.ndarray, np.ndarray]:
    """The filter oracle: each row's ranking cut to its first ``k`` allowed
    ids, padded with (float32 min, -1)."""
    out_s = np.full((scores.shape[0], k), NEG, np.float32)
    out_i = np.full((scores.shape[0], k), -1, np.int32)
    for r in range(scores.shape[0]):
        keep = (ids[r] >= 0) & allow[np.clip(ids[r], 0, None)]
        s, i = scores[r][keep][:k], ids[r][keep][:k]
        out_s[r, :s.size], out_i[r, :i.size] = s, i
    return out_s, out_i


def tie_groups_equal(scores: np.ndarray, ids: np.ndarray,
                     oids: np.ndarray) -> bool:
    """ids equal up to order inside each run of equal scores."""
    for r in range(scores.shape[0]):
        s, start = scores[r], 0
        while start < len(s):
            stop = start
            while stop < len(s) and s[stop] == s[start]:
                stop += 1
            if sorted(ids[r][start:stop].tolist()) != \
                    sorted(oids[r][start:stop].tolist()):
                return False
            start = stop
    return True


def fp32_near_equal(scores: np.ndarray, ids: np.ndarray,
                    rscores: np.ndarray, rids: np.ndarray,
                    rtol: float) -> tuple[bool, int]:
    """fp32 results against others: the same padded slots, scores within
    ``rtol`` of the row scale (max |score| + 1) at every rank, and ids
    equal wherever the other score is not within twice that of a
    neighbour's (outside near-ties).  Returns (held, scores bit-equal)."""
    if not np.array_equal(ids >= 0, rids >= 0):
        return False, 0
    live = rids >= 0
    scale = np.abs(rscores).max(axis=1, keepdims=True) + 1.0
    if not (np.abs(scores - rscores)[live] <= rtol * np.broadcast_to(
            scale, scores.shape)[live]).all():
        return False, 0
    for r, c in zip(*np.nonzero(ids != rids)):
        near = np.abs(rscores[r] - rscores[r, c]) <= 2 * rtol * scale[r, 0]
        if ids[r, c] not in rids[r][near]:
            return False, 0
    return True, int((scores == rscores)[live].sum())


def build_with_writes(make: Callable, factory, corpus: np.ndarray, *,
                      bulk: int, chunk: int, dead: np.ndarray,
                      revive: bool = False, **kw):
    """A stream arm with writes after its bulk load: ``corpus[:bulk]``
    bulk-loaded, the rest upserted in chunks of ``chunk`` rows (seals and
    a memtable tail), then the ids ``dead`` deleted and, with ``revive``,
    upserted back with their own rows (they land at the memtable's tail).
    ``make`` is a package's ``make_index``."""
    n = corpus.shape[0]
    idx = make(factory, corpus[:bulk], **kw)
    for a in range(bulk, n, chunk):
        idx.upsert(np.arange(a, min(a + chunk, n)), corpus[a:a + chunk])
    idx.delete(dead)
    if revive:
        idx.upsert(dead, corpus[dead])
    return idx


def stream_lifecycle(make: Callable, factory, corpus: np.ndarray,
                     queries: np.ndarray, allow: np.ndarray,
                     requests: tuple, *, bulk: int, k: int = 10,
                     searcher_kw: Optional[dict] = None, **kw) -> list:
    """One write sequence on a stream index, logged at eight checkpoints:
    after the bulk load of ``corpus[:bulk]``; after each of six rounds
    (``bulk // 10`` upserts over random live ids, ``bulk // 8`` new ids,
    round 4's shifted by 1.5 so drift can force a recalibration, and
    ``bulk * 3 // 50`` deletes of random ids below ``bulk``); and after
    ``compact(full=True)``.  At each a Searcher filtered by ``allow`` (over
    external ids, at least ``2 * bulk + 7 * (bulk // 8)`` long) answers
    ``queries`` in requests of the sizes ``requests``.  ``corpus`` needs
    ``bulk * 3 // 2 + 6 * (bulk // 20) + bulk // 8`` rows.

    Returns one entry a checkpoint: ([(rows, external ids, live bitmap)
    of each segment], counters, epoch, scores, ids, ``reranked``)."""
    from repro_torch.filter import Filter
    from repro_torch.knn import SearchParams

    idx = make(factory, corpus[:bulk], **kw)
    rng = np.random.default_rng(10)
    rep, new, step = bulk // 10, bulk // 8, bulk // 20
    log = []
    for r in range(8):
        if r == 7:
            idx.compact(full=True)
        elif r:
            idx.upsert(rng.choice(bulk, rep, replace=False),
                       corpus[bulk + rep * r:bulk + rep * (r + 1)])
            start = bulk * 3 // 2 + step * r
            idx.upsert(np.arange(2 * bulk + new * r, 2 * bulk + new * (r + 1)),
                       corpus[start:start + new] + (1.5 if r == 4 else 0.0))
            idx.delete(rng.choice(bulk, bulk * 3 // 50, replace=False))
        s = idx.searcher(k, SearchParams(filter=Filter.from_mask(allow)),
                         **(searcher_kw or {}))
        parts, start = [], 0
        for b in requests:
            parts.append(s(queries[start:start + b]))
            start += b
        log.append((
            [(x.n, x.ext_ids.tolist(), x.live.tolist())
             for x in idx.manifest.segments],
            dict(idx.counters), idx.epoch,
            np.concatenate([p.scores.cpu().numpy() for p in parts]),
            np.concatenate([p.ids.cpu().numpy() for p in parts]),
            parts[-1].stats["reranked"]))
    return log


def lifecycles_equal(a: list, b: list, allow: np.ndarray,
                     rtol: float = 1e-5, integer_sources: bool = True
                     ) -> tuple[Optional[str], int, int]:
    """Two ``stream_lifecycle`` logs of one sequence (say, card and CPU):
    segments, external ids, live bitmaps, counters and epoch equal at every
    checkpoint; no disallowed id; results bit-equal where one integer
    source passed through (``reranked`` 0), else (the merge re-scores in
    fp32 on each device) ``fp32_near_equal`` at ``rtol``.  With
    ``integer_sources=False`` (an inner kind whose own results are fp32,
    such as a cascade ending in ``r32``) a passed-through source is held
    at ``rtol`` too.  Returns (the first difference, or None; checkpoints
    bit-equal; fp32 scores bit-equal)."""
    exact = same = 0
    for j, ((sa, ca, ea, gs, gi, rr), (sb, cb, eb, ws, wi, _)) in \
            enumerate(zip(a, b)):
        if not (sa == sb and ca == cb and ea == eb):
            return f"checkpoint {j}: manifest, counters or epoch differ", 0, 0
        if not allow[gi[gi >= 0]].all():
            return f"checkpoint {j}: a disallowed id came back", 0, 0
        if rr == 0 and integer_sources:
            if not (np.array_equal(gi, wi) and np.array_equal(gs, ws)):
                return f"checkpoint {j}: single-source results differ", 0, 0
            exact += 1
            continue
        ok, eq = fp32_near_equal(gs, gi, ws, wi, rtol)
        if not ok:
            return (f"checkpoint {j}: fp32 merge results differ beyond rtol "
                    f"{rtol}"), 0, 0
        same += eq
    if len(a) != len(b):
        return "the logs differ in length", 0, 0
    return None, exact, same


def build_draws(f: str, metric: str, idx, corpus: np.ndarray) -> tuple:
    """The draws and float reductions of ``idx``, arm ``f`` as built on the
    CPU: (spec, build keyword arguments) that make
    ``get_impl(spec.kind).build`` on another device start from the same
    inputs.

    Each device would otherwise draw its own k-means inits (ivf lists,
    graph seeds, HNSW cells, a PQ head's codebooks) and reduce its own Eq.
    1 statistics (a few ulps apart, then a few codes).  The region fits
    are not passed on: ``RegionQuant.fit`` reduces on the host whatever the
    device, and the comparison holds one device's fit to the other's.
    ``corpus`` gives the graph kind's ip augmentation column, which the
    index does not keep."""
    import dataclasses

    import torch

    from repro_torch.engine import CodeStore
    from repro_torch.knn import as_spec
    from repro_torch.knn.graph_index import mip_column

    def params(store):
        return (store.params if isinstance(store, CodeStore)
                and store.quantized else None)

    def given(i) -> dict:
        """The kind's own ``_given``: its k-means or codebook draws."""
        if i.kind == "pq":
            return {"codebooks": i.store.codebooks}
        if i.kind == "ivf":
            return {"centroids": i.centroids}
        if i.kind == "graph":
            out = {"centroids": i.seeds, "params": params(i.store)}
            if i.aug:
                out["extra"] = mip_column(torch.from_numpy(
                    np.ascontiguousarray(corpus, dtype=np.float32)))
            return out
        if i.kind == "hnsw" and i.region_cents is not None:
            return {"region_centroids": i.region_cents}
        return {}

    spec = as_spec(f, metric=metric)
    if spec.kind == "cascade":
        draws = {"head_params": params(idx.head.store),
                 "stage_params": tuple(params(s) for s in idx.stage_stores)}
        if given(idx.head):
            draws["head"] = given(idx.head)
        return spec, {"_given": draws}
    kw = {"_given": given(idx)}
    if spec.kind == "hnsw":
        kw["_levels"] = idx.levels
    if spec.kind != "graph" and params(idx.store) is not None:
        spec = dataclasses.replace(
            spec, quant=spec.quant.with_params(params(idx.store)))
    return spec, kw

