"""Distance functions phi — full-precision references and their integer
counterparts (paper §3.1); port of ``repro.core.distances``.

All ``*_scores`` functions are batched [Q, d] x [N, d] -> [Q, N] and return
larger-is-closer scores (inner product; negated squared L2; cosine).

Integer dots are exact on both devices: int32 matmul on the CPU; on CUDA,
which has no int32 matmul, a float64 product cast back to int32 (exact
while |score| < 2^53, far above any int8/int4 code dot).
"""

from __future__ import annotations

from typing import Callable

import torch

Metric = str  # "ip" | "l2" | "angular"

_VALID_METRICS = ("ip", "l2", "angular")

#: corpus rows per float64 slab on CUDA (bounds the exact-dot temporaries)
_F64_ROWS = 1 << 20


# --------------------------------------------------------------------------
# Full-precision references
# --------------------------------------------------------------------------

def ip_scores(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Maximum-inner-product scores, [Q, N] f32."""
    return q.to(torch.float32) @ x.to(torch.float32).T


def l2_scores(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Negated squared L2 (larger = closer), [Q, N] f32."""
    q = q.to(torch.float32)
    x = x.to(torch.float32)
    qq = torch.sum(q * q, dim=-1, keepdim=True)
    xx = torch.sum(x * x, dim=-1)[None, :]
    return -(qq + xx - 2.0 * (q @ x.T))


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True),
                               1e-12)


def angular_scores(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Cosine similarity, [Q, N] f32."""
    return _unit(q.to(torch.float32)) @ _unit(x.to(torch.float32)).T


# --------------------------------------------------------------------------
# Quantized (integer-domain) counterparts
# --------------------------------------------------------------------------

def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[Q, d] int x [N, d] int -> [Q, N] int32, exact on CPU and CUDA."""
    if a.device.type == "cpu":
        return a.to(torch.int32) @ b.to(torch.int32).T
    a64 = a.to(torch.float64)
    out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.int32,
                      device=a.device)
    for s in range(0, b.shape[0], _F64_ROWS):
        blk = b[s:s + _F64_ROWS].to(torch.float64)
        out[:, s:s + blk.shape[0]] = (a64 @ blk.T).to(torch.int32)
    return out


def _sqrt32(v: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt (torch's vectorized CPU sqrt is not
    always; the root of a float64 rounds to the same f32 as IEEE sqrtf)."""
    return torch.sqrt(v.to(torch.float64)).to(torch.float32)


def _int_norms(v: torch.Tensor) -> torch.Tensor:
    vi = v.to(torch.int32)
    return torch.sum(vi * vi, dim=-1, dtype=torch.int32)


def qip_scores(qc: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """phi_IP over codes: int32 inner product, [Q, N]."""
    return int_matmul(qc, xc)


def ql2_scores(qc: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """Negated squared L2 over codes, int32 [Q, N]."""
    qq = _int_norms(qc)[:, None]
    xx = _int_norms(xc)[None, :]
    return -(qq + xx - 2 * int_matmul(qc, xc))


def qangular_scores(qc: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """Cosine over codes: exact int dot, f32 norm rescale, [Q, N] f32."""
    dot = int_matmul(qc, xc).to(torch.float32)
    qn = _sqrt32(torch.sum(qc.to(torch.float32) ** 2, dim=-1, keepdim=True))
    xn = _sqrt32(torch.sum(xc.to(torch.float32) ** 2, dim=-1))[None, :]
    return dot / torch.clamp_min(qn * xn, 1e-12)


_FP: dict[str, Callable] = {"ip": ip_scores, "l2": l2_scores,
                            "angular": angular_scores}
_Q: dict[str, Callable] = {"ip": qip_scores, "l2": ql2_scores,
                           "angular": qangular_scores}


def scores(q: torch.Tensor, x: torch.Tensor, metric: Metric,
           quantized: bool = False) -> torch.Tensor:
    """Batched larger-is-closer scores for any supported metric."""
    if metric not in _VALID_METRICS:
        raise ValueError(f"metric must be one of {_VALID_METRICS}, got {metric!r}")
    return (_Q if quantized else _FP)[metric](q, x)


# --------------------------------------------------------------------------
# Per-query candidate scoring (q [Q, d] against gathered rows [Q, W, d])
# --------------------------------------------------------------------------

def _int_bmm(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Exact int batched row dot, [Q, W] int32."""
    if q.device.type == "cpu":
        return torch.bmm(rows.to(torch.int32),
                         q.to(torch.int32)[:, :, None])[:, :, 0]
    return torch.bmm(rows.to(torch.float64),
                     q.to(torch.float64)[:, :, None])[:, :, 0].to(torch.int32)


def _bmm(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """f32 batched row dot, [Q, W]."""
    return torch.bmm(rows, q[:, :, None])[:, :, 0]


def scores_among(q: torch.Tensor, rows: torch.Tensor, metric: Metric,
                 quantized: bool = False) -> torch.Tensor:
    """Per-query candidate scores: q [Q, d] vs rows [Q, W, d] -> [Q, W]."""
    if metric not in _VALID_METRICS:
        raise ValueError(f"metric must be one of {_VALID_METRICS}, got {metric!r}")
    if quantized:
        if metric == "ip":
            return _int_bmm(q, rows)
        if metric == "l2":
            qq = _int_norms(q)[:, None]
            xx = _int_norms(rows)
            return -(qq + xx - 2 * _int_bmm(q, rows))
        dot = _int_bmm(q, rows).to(torch.float32)
        qn = _sqrt32(torch.sum(q.to(torch.float32) ** 2, dim=-1,
                               keepdim=True))
        xn = _sqrt32(torch.sum(rows.to(torch.float32) ** 2, dim=-1))
        return dot / torch.clamp_min(qn * xn, 1e-12)
    qf = q.to(torch.float32)
    xf = rows.to(torch.float32)
    if metric == "ip":
        return _bmm(qf, xf)
    if metric == "l2":
        qq = torch.sum(qf * qf, dim=-1, keepdim=True)
        xx = torch.sum(xf * xf, dim=-1)
        return -(qq + xx - 2.0 * _bmm(qf, xf))
    return _bmm(_unit(qf), _unit(xf))


def pairwise_distance(a: torch.Tensor, b: torch.Tensor, metric: Metric,
                      quantized: bool = False) -> torch.Tensor:
    """Single-pair convenience wrapper: the larger-is-closer score of two
    [d] vectors (a 0-dim tensor)."""
    return scores(a[None, :], b[None, :], metric, quantized)[0, 0]
