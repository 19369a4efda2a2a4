"""Empirical validators for Definition 2 (partial distance preservation)
and recall@k, the paper's §5.3 quality metric (port of
``repro.core.preserve``).

Definition 2: if d1(a, q) < d1(b, q) then d2(Q(a), h(q)) <= d2(Q(b), h(q)).
``order_agreement`` samples (a, b, q) triples and measures the fraction of
strict orderings that survive quantization (ties in the quantized domain
are allowed: the paper's "equality relaxation").

Random draws: the reference samples its triples from ``jax.random``; here
``key`` (an int) seeds a ``torch.Generator`` on the CPU.  The private
``_triples`` argument takes the (a, b, q) index arrays from elsewhere (the
reference's), and then the fraction is the reference's.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import distances as D
from repro_torch.core import quant as Qz
from repro_torch.device import to_tensor


def order_agreement(corpus, queries, params: Qz.QuantParams, metric: str,
                    n_triples: int = 4096, key: int | None = None,
                    margin_quantile: float = 0.0,
                    _triples: Optional[tuple] = None) -> float:
    """Fraction of sampled (a, b, q) triples whose strict order is kept.

    ``margin_quantile`` > 0 keeps only triples whose original score gap is
    at least that quantile of the gaps: near neighbours should be
    preserved while far-apart aliasing is acceptable, so agreement should
    rise with the margin."""
    corpus = torch.as_tensor(corpus, dtype=torch.float32)
    queries = torch.as_tensor(queries, dtype=torch.float32,
                              device=corpus.device)
    if _triples is None:
        g = torch.Generator()
        g.manual_seed(0 if key is None else int(key))
        n, nq = corpus.shape[0], queries.shape[0]
        _triples = (torch.randint(0, n, (n_triples,), generator=g),
                    torch.randint(0, n, (n_triples,), generator=g),
                    torch.randint(0, nq, (n_triples,), generator=g))
    ia, ib, iq = (to_tensor(t, device=corpus.device).long()
                  for t in _triples)
    p = params.to(corpus.device)
    a, b, q = corpus[ia], corpus[ib], queries[iq]
    qa, qb, qq = Qz.quantize(a, p), Qz.quantize(b, p), Qz.quantize(q, p)

    # larger-is-closer scores, one triple at a time: row i of q against
    # row i of a / b (the per-candidate scorer with one candidate)
    def pair(u, v, quantized):
        return D.scores_among(u, v[:, None, :], metric,
                              quantized=quantized)[:, 0].to(torch.float32)

    s_a, s_b = pair(q, a, False), pair(q, b, False)
    t_a, t_b = pair(qq, qa, True), pair(qq, qb, True)
    gap = torch.abs(s_a - s_b)
    strict = gap > 0
    if margin_quantile > 0.0:
        strict = strict & (gap >= torch.quantile(gap, margin_quantile))
    # Definition 2: a strict original order must map to <= (ties allowed)
    ok = torch.where(s_a > s_b, t_a >= t_b,
                     torch.where(s_b > s_a, t_b >= t_a, True))
    return float(torch.sum(ok & strict) / max(int(torch.sum(strict)), 1))


def recall_at_k(exact_ids: torch.Tensor, approx_ids: torch.Tensor) -> float:
    """|S_E ∩ S_A| / |S_E| averaged over queries; both [Q, k] int ids."""
    exact_ids = torch.as_tensor(exact_ids)
    approx_ids = torch.as_tensor(approx_ids).to(exact_ids.device)
    hits = (exact_ids[:, :, None] == approx_ids[:, None, :]).any(-1)
    return float(torch.mean(hits.sum(-1).to(torch.float64)
                            / exact_ids.shape[1]))


def knn_recall(corpus, queries, params: Qz.QuantParams, metric: str,
               k: int = 100) -> float:
    """End-to-end exact-scan recall: fp32 top-k against quantized top-k
    (the paper's Table 2 protocol on whatever corpus is passed in); ties
    go to the lower row id on both sides, as ``lax.top_k``."""
    from repro_torch.kernels.ref import stable_desc

    corpus = torch.as_tensor(corpus, dtype=torch.float32)
    queries = torch.as_tensor(queries, dtype=torch.float32,
                              device=corpus.device)
    p = params.to(corpus.device)
    ids_fp = stable_desc(D.scores(queries, corpus, metric), k)
    s_q = D.scores(Qz.quantize(queries, p), Qz.quantize(corpus, p), metric,
                   quantized=True)
    ids_q = stable_desc(s_q.to(torch.float32), k)
    return recall_at_k(ids_fp, ids_q)
