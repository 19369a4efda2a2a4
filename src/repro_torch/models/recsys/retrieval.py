"""Retrieval-candidate scoring (port of ``repro.models.recsys.retrieval``):
the ``retrieval_cand`` cell, one query embedding scored against 10^6
candidate item embeddings, which is the paper's MIP search problem.

The candidate table is stored as int8 codes (``QuantizedTable``), the
query is quantized with Eq. 1 (B1, ``kernels.ops.quantize``) and scored
with the int8 score-matrix kernel (B6, ``kernels.ops.qmip``).  The fp32
arm is the baseline: a plain fp32 product (TF32 is off, see
``repro_torch/__init__.py``).

Both arms end in :func:`top_k`, which keeps ``lax.top_k``'s order: score
descending, ties to the lowest column.  ``torch.topk`` promises no order
among equal values, and integer scores over 10^6 candidates tie often at
the k-th place.  Its values are exact all the same (equal elements have
equal values), so ``top_k`` takes the k-th best value from it, keeps every
element at or above that value (in column order, ``torch.nonzero``) and
orders those few by a stable sort.  A ``torch.topk`` over unique int64
(score key, ``N - 1 - column``) keys gives the same order in one call but
was slower on the H100 at Q=512, N=10^6 (PERF.md);
``kernels.ref.stable_desc`` sorts whole rows.
"""

from __future__ import annotations

import torch

from repro_torch.core import quant as Qz
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as R


def top_k(s: torch.Tensor, k: int):
    """Best ``k`` of each row of [Q, N] f32 scores: ([Q, k] f32, [Q, k]
    int32 columns), score descending under the IEEE total order (-0.0
    below +0.0, NaN above +inf), ties to the lowest column.  A NaN never
    passes ``s >= thr``, so where a row holds NaN (``torch.topk`` ranks it
    first) the threshold and the comparison are taken on the order key
    instead, and every row still keeps exactly k entries; without NaN the
    float comparison keeps the one pass it needs over the matrix."""
    top = torch.topk(s, k, dim=-1).values
    if bool(torch.isnan(top[:, 0]).any()):
        key = R.order_key(s)
        sel = key >= torch.topk(key, k, dim=-1).values[:, -1:]
    else:
        sel = s >= top[:, -1:]                          # the k-th best value
    rows, cols = torch.nonzero(sel, as_tuple=True)      # columns ascending
    vals = s[rows, cols]
    # (row asc, score desc, column asc): stable sorts, innermost key first
    o = torch.sort(R.order_key(vals), descending=True, stable=True).indices
    o = o[torch.sort(rows[o], stable=True).indices]
    counts = torch.bincount(rows, minlength=s.shape[0])
    start = torch.cumsum(counts, 0) - counts
    pick = o[(start[:, None] + torch.arange(k, device=s.device)).reshape(-1)]
    return vals[pick].view(-1, k), cols[pick].view(-1, k).to(torch.int32)


def retrieve_fp32(query_emb: torch.Tensor, cand_table: torch.Tensor,
                  k: int = 100):
    """Baseline: [Q, d] x [N, d] fp32 -> top-k (scores, ids)."""
    s = torch.matmul(query_emb.to(torch.float32),
                     cand_table.to(torch.float32).T)
    return top_k(s, k)


def retrieve_quantized(query_emb: torch.Tensor, cand_codes: torch.Tensor,
                       params: Qz.QuantParams, k: int = 100):
    """Paper path: quantize h(q) (B1), int8 MIP (B6), cast, top-k.  The
    cast is exact while |s| < 2^24 (int8 codes: d < 1024)."""
    q_codes = K.quantize(query_emb, params.lo, params.hi, params.zero,
                         bits=params.bits)
    s = K.qmip(q_codes, cand_codes).to(torch.float32)
    return top_k(s, k)
