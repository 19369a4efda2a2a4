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
  * ``scale_err``: an LM result's largest difference over its scale.
  * ``moe_routing`` / ``c10_strikes`` / ``moe_naive``: the top-1 MoE's
    capacity routing, whether the reference's fault C10 (a dropped token
    overwriting the last expert's last slot) strikes on an input, and the
    per-token top-1 oracle.
  * ``grad_scales`` / ``adam_first_step``: a gradient tree's per-leaf
    scales, and one first AdamW step's parameters held against another
    run's, with the elements whose gradient is near 0 set aside.

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



def scale_err(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| / max |want|: an LM result's error at its scale
    (logits, caches, attention outputs)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def moe_routing(x: np.ndarray, router_w: np.ndarray, n_experts: int,
                capacity_factor: float):
    """Top-1 capacity routing of tokens x [T, d]: (assign, pos, keep, C)
    with pos a token's rank inside its expert and C = max(8, ceil(T * cf /
    E)) (first-index argmax over float32 router logits)."""
    x = np.asarray(x, np.float32).reshape(-1, router_w.shape[0])
    T = x.shape[0]
    C = max(8, int(-(-T * capacity_factor // n_experts)))
    assign = np.argmax(x @ np.asarray(router_w, np.float32), axis=-1)
    pos = np.zeros(T, np.int64)
    seen = np.zeros(n_experts, np.int64)
    for t, e in enumerate(assign):
        pos[t] = seen[e]
        seen[e] += 1
    return assign, pos, pos < C, C


def c10_strikes(x: np.ndarray, router_w: np.ndarray, n_experts: int,
                capacity_factor: float) -> bool:
    """Does the reference's ``moe_apply`` zero a kept token on x?  It does
    when a token holds the last expert's last slot [E-1, C-1] and any
    later token is dropped: the drop's sentinel overwrites that slot."""
    assign, pos, keep, C = moe_routing(x, router_w, n_experts,
                                       capacity_factor)
    held = np.flatnonzero(keep & (assign == n_experts - 1) & (pos == C - 1))
    return bool(held.size and (~keep[held[0] + 1:]).any())


def _act(h: np.ndarray, act: str) -> np.ndarray:
    if act == "silu":
        return h / (1.0 + np.exp(-h))
    return 0.5 * h * (1.0 + np.tanh(np.sqrt(2.0 / np.pi)
                                    * (h + 0.044715 * h ** 3)))


def moe_naive(params: dict, x: np.ndarray, n_experts: int,
              capacity_factor: float, act: str = "silu") -> np.ndarray:
    """The MoE FFN token by token in float64: a kept token's routed expert
    times its router probability, 0 for a dropped one, plus the shared
    expert; x [B, S, d] -> [B, S, d].  ``params`` is a (numpy) MoE tree."""
    B, S, d = x.shape
    xt = np.asarray(x, np.float64).reshape(B * S, d)
    rw = np.asarray(params["router"]["w"], np.float32)
    assign, _pos, keep, _C = moe_routing(xt.astype(np.float32), rw,
                                         n_experts, capacity_factor)
    logits = xt @ rw.astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)

    def glu(gw, uw, dw, v):
        return (_act(v @ gw, act) * (v @ uw)) @ dw

    w = {k: np.asarray(params[k], np.float64)
         for k in ("gate_w", "up_w", "down_w")}
    out = np.zeros_like(xt)
    for t, e in enumerate(assign):
        if keep[t]:
            out[t] = probs[t, e] * glu(w["gate_w"][e], w["up_w"][e],
                                       w["down_w"][e], xt[t])
    if "shared" in params:
        sh = params["shared"]
        out += glu(*(np.asarray(sh[k]["w"], np.float64)
                     for k in ("gate", "up", "down")), xt)
    return out.reshape(B, S, d)


def grad_scales(grads: list, floor: float = 0.0) -> list:
    """Each gradient leaf's scale: its max |value|, at least ``floor``
    times the largest over all leaves (a leaf whose gradient is 0 in exact
    arithmetic, or far below the rest, carries float32 cancellation noise
    of the tree's scale)."""
    top = max(float(np.abs(np.asarray(g)).max()) for g in grads)
    return [max(float(np.abs(np.asarray(g)).max()), floor * top, 1e-30)
            for g in grads]


def adam_first_step(new: list, want: list, old: list, grads: list, *,
                    lr: float, weight_decay: float, eps: float,
                    param_tol: float, grad_tol: float,
                    floor: float = 0.0, rounding: float = 0.0) -> dict:
    """Hold one AdamW step from a zero state (``new``) against another
    run's (``want``) from the same parameters ``old``; ``grads`` is the
    other run's gradient, each a list of leaves in one order.

    Adam's first step moves an element by lr * g / (|g| + eps) plus the
    decay, close to lr * sign(g), so an element whose gradient lies within
    the gradient tolerance (``grad_tol`` times its leaf's scale,
    ``grad_scales``) of 0, but is not 0, may move either way in a faithful
    run: it is set aside, counted and held to Adam's bound |new - old| <=
    lr (1 + weight_decay |old|), plus ``rounding`` (the parameters'
    dtype's relative rounding, 2^-8 for bf16; 0 for float32) times the
    moved value's size, since a bf16 parameter rounds its new value once
    and its ulp can exceed lr.  Every other element is held within
    ``param_tol`` of its leaf's scale plus what a gradient difference of
    the tolerance moves that step by, lr * eps * tol / ((|g| + eps)
    (|g| - tol + eps)) (0 where the gradient is exactly 0: both runs'
    step is the decay alone).  Returns {"away": the largest ratio of a
    held element's difference to its allowance, "near": the largest
    ratio of a set-aside element's move to Adam's bound (both at most 1
    to pass), "n_near": the count set aside, "n": the element count}."""
    out = {"away": 0.0, "near": 0.0, "n_near": 0, "n": 0}
    for p, r, p0, g, gs in zip(new, want, old, grads,
                               grad_scales(grads, floor), strict=True):
        p, r, p0 = (np.asarray(a, np.float64) for a in (p, r, p0))
        g = np.abs(np.asarray(g, np.float64))
        tol = grad_tol * gs
        zero = (g <= tol) & (g > 0)
        out["n_near"] += int(zero.sum())
        out["n"] += g.size
        step = lr * (1 + weight_decay * np.abs(p0))
        bound = step * (1 + 1e-6) + rounding * (np.abs(p0) + step)
        moved = np.where(g > 0, lr * eps * tol / (
            (g + eps) * np.maximum(g - tol + eps, eps)), 0.0)
        allowed = param_tol * max(float(np.abs(r).max()), 1e-30) + moved
        out["away"] = max(out["away"], float(
            (np.abs(p - r) / allowed)[~zero].max(initial=0.0)))
        out["near"] = max(out["near"], float(
            (np.abs(p - p0) / bound)[zero].max(initial=0.0)))
    return out
