"""The comparison that decides ``correct``: the plain reference worked out
again from the inputs, against what the timed path returned.

The reference draws the corpus again from the seed (``lpqbench.data``),
works out Eq. 1's constants in float64, encodes the corpus and the
sampled requests' queries (``eq1``), scans every code for each query's
best ``depth`` (``scan``; ties to the lowest id) and, for a ``+r32``
configuration, re-scores those candidates in float64 and keeps the best k.
It takes nothing from the program but what it judges: the answers of the
sampled requests, and from the set-up's state the constants and the
codes.  It encodes with its own constants only.

Float32 constants of a correct program may differ from float64's in their
last bits (moments such as ``gaussian``'s are sums; order statistics such
as ``global_minmax``'s are exact), so where Eq. 1's value lies that close
to a rounding boundary either neighbouring code is a correct float32
answer.  The reference allows constants within ``CONST_REL`` of the span
of its own (about 8 float32 ulps), which moves Eq. 1's value by at most
``2^(B+1) * CONST_REL``: a code whose value lies within that band of a
boundary is ambiguous, and either neighbour is accepted there.  The
reference decides this alone, from its own values.  A query is excused
from ``cand_miss`` and ``rank_gap`` (and, with no rerank, ``score_err``)
where one of its own codes is ambiguous, or where an ambiguous row could
move across its best ``depth``'s edge by a code step (or, with no rerank,
could stand among its answers at all); ``excused`` counts them.

Numbers (each one the worst over what it covers):

    const_err  the constants' largest gap from the reference's, over the
               reference's span
    code_err   the share of stored codes that differ from Eq. 1's
    cand_miss  the share of answer slots whose row is not among the
               reference's best ``depth`` of the quantized scan
    rank_gap   how far an answer's true score lies below the reference's
               score at that rank, over the query's best score: the true
               score is the int code score (no rerank) or the float64
               score of the fp32 row (rerank); an invalid or repeated id
               reads ``BIG``
    score_err  the gap between the score an answer states and its true
               score, over the query's best score
"""

from __future__ import annotations

import contextlib

import torch

from lpqbench import data
from lpqbench.reference import eq1, scan

BIG = 1e30
#: the share of the span by which a correct program's float32 constants
#: may differ from the reference's float64 ones
CONST_REL = 1e-6
#: corpus rows a step of the reference's scan
STEP = 1 << 18


@contextlib.contextmanager
def full_float32():
    """float32 products in float32 (no TF32) while the reference runs."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def corpus(config: dict, seed: int, dev) -> torch.Tensor:
    draw = data.sampler(config, seed, dev)
    return data.fill(draw, int(config["rows"]), int(config["dim"]), seed,
                     "corpus", dev)


def _true_scores(config, x, q, qc, ids, consts, bits):
    """The true score of each answered id: [Q, k] float64 (rows gathered
    from the fp32 corpus; ``ids`` already valid)."""
    rows = x[ids]                                          # [Q, k, d]
    if config.get("rerank"):
        return (rows.double() * q.double()[:, None, :]).sum(2)
    codes = eq1.encode(rows.reshape(-1, rows.shape[-1]), *consts, bits)
    codes = codes.reshape(rows.shape).long()
    qcl = qc.long()
    dot = (codes * qcl[:, None, :]).sum(2)          # int64: exact anywhere
    if config["metric"] == "ip":
        return dot.double()
    return (2 * dot - (qcl ** 2).sum(1)[:, None]
            - (codes ** 2).sum(2)).double()


def _excused(x, nq, qc, consts, bits, metric, edge, rows, amb, rerank):
    """[Q] bool: the queries where an ambiguous row (``rows``; ``amb``
    marks its ambiguous codes) scores within those codes' reach of the
    query's ``edge`` (the reference's ``depth``-th score); with no rerank,
    anywhere above it less that reach."""
    if rows.numel() == 0:
        return torch.zeros(nq, dtype=torch.bool, device=qc.device)
    codes = eq1.encode(x[rows], *consts, bits)
    a, qa = amb.to(torch.float32), qc.to(torch.float32).abs()
    # a code step in dim j moves an ip score by |q_j| and an l2 one by
    # |2 (q_j - c_j) -+ 1|, at most 2 |q_j| + 2 |c_j| + 1
    if metric == "ip":
        reach = qa @ a.T
    else:
        per_row = (a * (2 * codes.to(torch.float32).abs() + 1)).sum(1)
        reach = 2 * (qa @ a.T) + per_row[None, :]
    s = scan.int_scores(qc, codes, metric)
    near = s >= edge[:, None] - reach
    if rerank:
        near &= s <= edge[:, None] + reach
    return near.any(1)


def judge(config: dict, seed: int, dev, queries: torch.Tensor,
          scores: torch.Tensor, ids: torch.Tensor, state) -> dict:
    """Every number above, and ``recall``, for the sampled ``queries``
    ([Q, d] fp32) and the program's answers ``scores`` / ``ids`` ([Q, k]);
    ``state`` gives the set-up's ``constants()`` and ``code_rows(lo, hi)``
    (int8 code values, unpacked)."""
    with full_float32():
        return _judge(config, seed, dev, queries, scores, ids, state)


def _judge(config, seed, dev, queries, scores, ids, state):
    n, d, k = int(config["rows"]), int(config["dim"]), int(config["k"])
    metric, qspec = config["metric"], config["quant"]
    bits = int(qspec["bits"])
    depth = int(config["rerank"]["depth"]) if config.get("rerank") else k
    x = corpus(config, seed, dev)
    ref = eq1.constants(x.split(data.SLAB), d, qspec["scheme"],
                        float(qspec.get("sigmas", 1.0)), dev)
    prog = [c.to(device=dev, dtype=torch.float64) for c in state.constants()]
    span = ref[1] - ref[0]
    const_err = max(float(torch.max(torch.abs(p - r) / span))
                    for p, r in zip(prog, ref))
    consts = [c.float() for c in ref]

    q = queries.to(dev, torch.float32)
    band = 2.0 ** (bits + 1) * CONST_REL
    vq = eq1.value(q, *consts, bits)
    qc = eq1.to_code(vq, bits)
    amb_q = (eq1.to_code(vq - band, bits)
             != eq1.to_code(vq + band, bits)).any(1)
    top, truth = scan.TopD(q.shape[0], depth, dev), scan.FloatTopK(
        q.shape[0], k, dev)
    mismatched, amb_rows, amb_masks = 0, [], []
    for start in range(0, n, STEP):
        xs = x[start:start + STEP]
        v = eq1.value(xs, *consts, bits)
        codes = eq1.to_code(v, bits)
        below, above = eq1.to_code(v - band, bits), eq1.to_code(v + band, bits)
        amb = below != above
        stored = state.code_rows(start, start + xs.shape[0]).to(dev)
        either = amb & ((stored == below) | (stored == above))
        mismatched += int(torch.sum((stored != codes) & ~either))
        rows = torch.nonzero(amb.any(1)).flatten()
        amb_rows.append(rows + start)
        amb_masks.append(amb[rows])
        del v, below, above, amb, stored, either
        top.add(scan.int_scores(qc, codes, metric), start)
        truth.add(scan.float_scores(q, xs, metric), start)
    cand_s, cand_i = top.result()
    excused = _excused(x, q.shape[0], qc, consts, bits, metric, cand_s[:, -1],
                       torch.cat(amb_rows), torch.cat(amb_masks),
                       bool(config.get("rerank"))) | amb_q

    if config.get("rerank"):
        rs = (x[cand_i].double() * q.double()[:, None, :]).sum(2)
        order = torch.sort(rs, dim=1, descending=True, stable=True).indices
        ref_s = torch.gather(rs, 1, order)[:, :k]
    else:
        ref_s = cand_s[:, :k].double()
    scale = torch.clamp_min(torch.maximum(ref_s[:, 0].abs(),
                                          ref_s[:, -1].abs()), 1e-30)

    nums = {"const_err": const_err, "code_err": mismatched / (n * d),
            "excused": int(excused.sum())}
    ids = ids.to(dev).long()
    scores = scores.to(dev).double()
    shape_ok = ids.shape == (q.shape[0], k) and scores.shape == ids.shape
    if not shape_ok:
        nums.update(cand_miss=1.0, rank_gap=BIG, score_err=BIG, recall=0.0)
        return nums
    srt = torch.sort(ids, dim=1).values
    valid = ((ids >= 0) & (ids < n)).all(1) & (srt[:, 1:] != srt[:, :-1]).all(1)
    safe = torch.where(valid[:, None], ids, 0)
    true = _true_scores(config, x, q, qc, safe, consts, bits)
    gap = torch.where(valid[:, None], (ref_s - true) / scale[:, None], BIG)
    err = torch.where(valid[:, None],
                      (scores - true).abs() / scale[:, None], BIG)
    hit = (safe[:, :, None] == cand_i[:, None, :]).any(2) & valid[:, None]
    ex = (excused & valid)[:, None]
    gap, hit = torch.where(ex, 0.0, gap), hit | ex
    if not config.get("rerank"):      # a reranked score reads no code
        err = torch.where(ex, 0.0, err)
    gt = (ids[:, :, None] == truth.i[:, None, :]).any(2)
    nums.update(cand_miss=int((~hit).sum()) / hit.numel(),
                rank_gap=float(gap.max()), score_err=float(err.max()),
                recall=float(gt.double().mean()))
    return nums
