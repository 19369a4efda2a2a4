"""Graph beam search (HNSW SEARCH-LAYER) as a batched torch loop (port of
``repro.knn.graph``).

The reference walks one query with a ``lax.while_loop`` and ``vmap``s it
over a batch: a query whose loop condition is false keeps its state while
the others run on.  Here one loop runs the whole batch on the index's
device over [Q, ef] state (beam ids, scores, ``expanded``) plus a [Q, N]
visited mask, an iteration count ``it [Q]`` and an ``active [Q]`` flag.
Each step updates a query only while it is active, and counts ``it`` only
for active queries, so every query's result equals its one-query walk.
The host reads ``active.any()`` once every ``CHECK_EVERY`` steps: one
sync a chunk.  Steps past a query's end change nothing.

One step, as in the reference: expand the best unexpanded beam entry
(first maximum on ties), gather its adjacency row, score the unvisited
neighbours (computed before the visited update, so an id listed twice in a
row is scored twice), mark them visited (an OR: a ``-1`` pad never clears
a mark), and keep the best ``ef`` of beam + neighbours with
``lax.top_k``'s order (score descending, lowest position first).

Score sets: ``beam_search`` and ``greedy_descent`` take the reference's
one-query ``(q [d], ids [m]) -> [m] f32`` (``engine.make_score_set``);
the batched walks take ``(q [Q, d], ids [Q, W]) -> [Q, W] f32``
(``engine.make_batch_score_set``).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.ref import NEG, stable_desc

#: (query [d], ids [m]) -> [m] f32
ScoreSet = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
#: (queries [Q, d], ids [Q, W]) -> [Q, W] f32
BatchScoreSet = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

#: steps between two host reads of ``active.any()``
CHECK_EVERY = 16

#: walk accounting since the last ``reset_steps()``: batched loop steps run
#: (``beam``, ``greedy``; each is the same few launches whatever the batch)
#: and the per-query iterations they advanced (``beam_iters``)
STEPS = {"beam": 0, "beam_iters": 0, "greedy": 0}


def reset_steps() -> None:
    for key in STEPS:
        STEPS[key] = 0


def _one_query(score_set: ScoreSet) -> BatchScoreSet:
    """A one-query score set as a batch-of-one score set."""
    return lambda q, ids: score_set(q[0], ids[0])[None]


def beam_search_batch(
    queries: torch.Tensor,
    adj: torch.Tensor,
    entry_ids: torch.Tensor,
    score_set: BatchScoreSet,
    ef: int,
    max_iters: int | None = None,
):
    """Beam search over one graph layer for a [Q, d] query batch.

    Args:
      queries: [Q, d] queries (codes or fp32, whatever score_set expects).
      adj: [N, M] int32 adjacency, -1 padded, on the walk's device.
      entry_ids: [E] shared or [Q, E] per-query int32 entry points (-1
        padded allowed).
      score_set: the batched score set.
      ef: beam width (W-set size).
      max_iters: expansion cap per query; defaults to 8 * ef.

    Returns (beam_scores [Q, ef] f32, beam_ids [Q, ef] int32), best first.
    """
    dev = adj.device
    n_nodes = adj.shape[0]
    nq = queries.shape[0]
    if max_iters is None:
        max_iters = 8 * ef
    entry_ids = torch.as_tensor(entry_ids, device=dev).to(torch.int32)
    if entry_ids.dim() == 1:
        entry_ids = entry_ids[None].expand(nq, -1)
    e = entry_ids.shape[1]

    valid_e = entry_ids >= 0
    safe_e = torch.clamp(entry_ids, min=0)
    e_scores = torch.where(valid_e, score_set(queries, safe_e), NEG)

    pad = max(ef - e, 0)
    beam_ids = torch.cat([entry_ids, torch.full((nq, pad), -1, dtype=torch.int32,
                                                device=dev)], 1)[:, :ef]
    beam_scores = torch.cat([e_scores, torch.full((nq, pad), NEG,
                                                  device=dev)], 1)[:, :ef]
    if e > ef:
        pos = stable_desc(e_scores, ef)
        beam_scores = torch.gather(e_scores, 1, pos)
        beam_ids = torch.where(beam_scores > NEG,
                               torch.gather(entry_ids, 1, pos), -1)
    # invalid slots count as already expanded so they are never picked
    expanded = beam_ids < 0

    # column n_nodes is a sink: writes that must not mark anything go there
    # (a scatter of one value, True, so duplicate indices cannot race)
    visited = torch.zeros((nq, n_nodes + 1), dtype=torch.bool, device=dev)
    sink = torch.full_like(safe_e, n_nodes)
    visited.scatter_(1, torch.where(valid_e, safe_e, sink).long(), True)

    it = torch.zeros(nq, dtype=torch.int32, device=dev)
    active = (it < max_iters) & torch.any(~expanded, 1)
    while bool(active.any()):
        for _ in range(CHECK_EVERY):
            pick = torch.where(expanded, NEG, beam_scores)
            pos = torch.argmax(pick, 1, keepdim=True)              # [Q, 1]
            node = torch.gather(beam_ids, 1, pos)[:, 0]
            now_expanded = expanded.scatter(1, pos, True)

            nbrs = adj[torch.clamp(node, min=0).long()]            # [Q, M]
            safe = torch.clamp(nbrs, min=0).long()
            fresh = (nbrs >= 0) & ~torch.gather(visited, 1, safe)
            visited.scatter_(1, torch.where(fresh & active[:, None], safe,
                                            n_nodes), True)

            n_scores = torch.where(fresh, score_set(queries, safe), NEG)
            n_ids = torch.where(fresh, nbrs, -1)
            all_s = torch.cat([beam_scores, n_scores], 1)
            all_i = torch.cat([beam_ids, n_ids], 1)
            all_e = torch.cat([now_expanded, ~fresh], 1)
            top = stable_desc(all_s, ef)
            top_s = torch.gather(all_s, 1, top)
            keep = top_s > NEG

            on = active[:, None]
            beam_ids = torch.where(on & keep, torch.gather(all_i, 1, top),
                                   torch.where(on, -1, beam_ids))
            beam_scores = torch.where(on, top_s, beam_scores)
            expanded = torch.where(on, ~keep | torch.gather(all_e, 1, top),
                                   expanded)
            it = it + active.to(torch.int32)
            active = (it < max_iters) & torch.any(~expanded, 1)
        STEPS["beam"] += CHECK_EVERY
    STEPS["beam_iters"] += int(it.sum())
    return beam_scores, beam_ids



def filtered_cut(scores: torch.Tensor, ids: torch.Tensor, k: int,
                 mask: torch.Tensor | None):
    """Cut a walk's [Q, ef] beam to k.  With a filter ``mask`` ([N] bool
    over row ids), disallowed and empty slots become (NEG, -1) first and
    the cut is stable, so allowed rows keep the beam's order (reference
    ``hnsw.py`` / ``graph_index.py``: ``lax.top_k`` of the masked beam)."""
    if mask is None:
        return scores[:, :k], ids[:, :k]
    ok = (ids >= 0) & mask[ids.clamp_min(0).long()]
    s = torch.where(ok, scores.to(torch.float32), NEG)
    i = torch.where(ok, ids, -1)
    pos = stable_desc(s, k)
    return torch.gather(s, 1, pos), torch.gather(i, 1, pos)

def beam_search(
    q: torch.Tensor,
    adj: torch.Tensor,
    entry_ids: torch.Tensor,
    score_set: ScoreSet,
    ef: int,
    max_iters: int | None = None,
):
    """Single-query beam search over one graph layer (the reference's
    signature: q [d], entry_ids [E], the one-query score set).

    Returns (beam_scores [ef], beam_ids [ef]) sorted best-first.
    """
    entry_ids = torch.as_tensor(entry_ids, device=adj.device)
    s, i = beam_search_batch(q[None], adj, entry_ids[None],
                             _one_query(score_set), ef, max_iters)
    return s[0], i[0]


def greedy_descent_batch(
    queries: torch.Tensor,
    adj: torch.Tensor,
    entry: torch.Tensor,
    score_set: BatchScoreSet,
    max_iters: int = 64,
):
    """ef=1 hill-climb used on HNSW's upper layers, for a [Q, d] batch from
    entries [Q]: each query moves to its best neighbour while that one
    scores strictly higher, at most ``max_iters`` times.

    Returns (nodes [Q] int32, scores [Q] f32).
    """
    dev = adj.device
    node = torch.as_tensor(entry, device=dev).to(torch.int32)
    score = score_set(queries, node[:, None])[:, 0]
    it = torch.zeros_like(node)
    improved = torch.ones_like(node, dtype=torch.bool)
    active = it < max_iters
    while bool(active.any()):
        for _ in range(CHECK_EVERY):
            nbrs = adj[node.long()]                                # [Q, M]
            n_scores = torch.where(
                nbrs >= 0, score_set(queries, torch.clamp(nbrs, min=0).long()),
                NEG)
            best = torch.argmax(n_scores, 1, keepdim=True)
            best_s = torch.gather(n_scores, 1, best)[:, 0]
            better = best_s > score
            node = torch.where(active & better,
                               torch.gather(nbrs, 1, best)[:, 0], node)
            score = torch.where(active, torch.maximum(best_s, score), score)
            improved = torch.where(active, better, improved)
            it = it + active.to(torch.int32)
            active = (it < max_iters) & improved
        STEPS["greedy"] += CHECK_EVERY
    return node, score


def greedy_descent(
    q: torch.Tensor,
    adj: torch.Tensor,
    entry,
    score_set: ScoreSet,
    max_iters: int = 64,
):
    """ef=1 hill-climb from one entry (the reference's signature): walk to
    a local maximum.  Returns (node, score) as 0-d tensors."""
    entry = torch.as_tensor(entry, device=adj.device).reshape(1)
    node, score = greedy_descent_batch(q[None], adj, entry,
                                       _one_query(score_set), max_iters)
    return node[0], score[0]
