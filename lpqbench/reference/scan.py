"""Exact top-D over integer codes, and exact float32 top-k, in plain
PyTorch.

Integer scores (inner product, or negated squared L2, of int8 / int4
codes) are exact in a float32 product: every partial sum is an integer
below 2^24 in magnitude (at most 128 * 128 * 128 for d <= 128 int8 codes,
200 * 64 for d = 200 int4 codes), so any summation order gives the same
value.  Selection is by (score desc, id asc): each score and row id are
packed into one int64 key.
"""

from __future__ import annotations

import torch

_LOW = (1 << 32) - 1


def int_scores(qc: torch.Tensor, xc: torch.Tensor, metric: str) -> torch.Tensor:
    """[Q, d] x [r, d] int codes -> [Q, r] int64 larger-is-closer scores."""
    dot = torch.round(qc.to(torch.float32) @ xc.to(torch.float32).T).long()
    if metric == "ip":
        return dot
    if metric != "l2":
        raise ValueError(f"reference: metric {metric!r}")
    qn = torch.sum(qc.long() ** 2, dim=1)
    xn = torch.sum(xc.long() ** 2, dim=1)
    return 2 * dot - qn[:, None] - xn[None, :]


def _keys(s: torch.Tensor, start: int) -> torch.Tensor:
    ids = torch.arange(start, start + s.shape[1], device=s.device)
    return s * (1 << 32) + (_LOW - ids)[None, :]


def _unkey(key: torch.Tensor):
    return key >> 32, _LOW - (key & _LOW)


class TopD:
    """The running best ``depth`` (score desc, id asc) of each query."""

    def __init__(self, q: int, depth: int, dev):
        self.depth = depth
        self.key = torch.full((q, 0), 0, dtype=torch.int64, device=dev)

    def add(self, s: torch.Tensor, start: int) -> None:
        key = torch.cat([self.key, _keys(s, start)], dim=1)
        self.key = torch.topk(key, min(self.depth, key.shape[1]), dim=1).values

    def result(self):
        """(scores [Q, D] int64, ids [Q, D] int64), best first."""
        return _unkey(self.key)


class FloatTopK:
    """The running exact float32 top-k (ground truth for recall)."""

    def __init__(self, q: int, k: int, dev):
        self.k = k
        self.s = torch.empty((q, 0), dtype=torch.float32, device=dev)
        self.i = torch.empty((q, 0), dtype=torch.int64, device=dev)

    def add(self, s: torch.Tensor, start: int) -> None:
        ids = torch.arange(start, start + s.shape[1], device=s.device)
        s = torch.cat([self.s, s], dim=1)
        i = torch.cat([self.i, ids[None, :].expand(s.shape[0], -1)], dim=1)
        top = torch.topk(s, min(self.k, s.shape[1]), dim=1)
        self.s, self.i = top.values, torch.gather(i, 1, top.indices)


def float_scores(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    """[Q, d] x [r, d] float32 -> [Q, r] larger-is-closer float32 scores."""
    dot = q @ x.T
    if metric == "ip":
        return dot
    return 2 * dot - torch.sum(q * q, 1)[:, None] - torch.sum(x * x, 1)[None, :]
