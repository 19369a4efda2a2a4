"""Criteo-style synthetic recsys batches (port of
``repro.data.recsys_data``): dense floats + sparse categorical ids with a
power-law id distribution (the regime that makes embedding-table sharding
and the paper's int8 tables interesting).

Draws come from an explicit ``torch.Generator`` on the target device
(default: the GPU), so the numbers differ from the reference's
``jax.random`` draws; the id map itself (``powerlaw_ids``) is the
reference's, and equal to it on the same uniforms.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

#: the uniforms' lower bound (the reference's ``minval``)
U_MIN = 1e-6


def _f32(v: float) -> float:
    """``v`` rounded to float32 (the constants below are float32 ones)."""
    return float(np.float32(v))


def _fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once (the product of two float32 values
    is exact in float64)."""
    b = _f32(b) if isinstance(b, float) else b
    c = _f32(c) if isinstance(c, float) else c
    return (a.to(torch.float64) * b + c).to(torch.float32)


def _exp32(x: torch.Tensor) -> torch.Tensor:
    """float32 exp as XLA's CPU backend computes it (Cephes' range
    reduction and degree-5 polynomial, each step a fused multiply-add):
    bit-equal to the reference's ``jnp.exp`` on [0, 88], where
    ``torch.exp`` differs from it by an ulp in about one value in ten."""
    x = x.clamp(_f32(-88.3762626647949), _f32(88.3762626647950))
    fx = torch.floor(_fma32(x, 1.44269504088896341, 0.5))
    r = _fma32(fx, -0.693359375, x)
    r = _fma32(fx, 2.12194440e-4, r)
    z = r * r
    y = torch.full_like(r, _f32(1.9875691500e-4))
    for p in (1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
              1.6666665459e-1, 5.0000001201e-1):
        y = _fma32(y, r, p)
    y = _fma32(y, z, r) + 1.0
    return torch.ldexp(y, fx.to(torch.int32))


def powerlaw_ids(u: torch.Tensor, vocab: int) -> torch.Tensor:
    """Zipf-ish ids from uniforms ``u`` in [U_MIN, 1): the inverse CDF of
    p(i) ~ 1/(i+1), i = vocab^u - 1, truncated to int32 and clipped to
    [0, vocab), equal to the reference's on the same ``u``.

    The reference computes ``expm1(u * log(vocab))`` in float32; XLA's
    expm1 there is exp(x) - 1 from x = 0.5 on, and below 0.5 the result
    is under 1 and truncates to id 0 either way, so ``exp(x) - 1`` with
    XLA's exp gives its ids."""
    log_v = float(np.log(np.float32(vocab)))        # float32, as jnp.log
    x = u.to(torch.float32) * torch.tensor(log_v, dtype=torch.float32,
                                           device=u.device)
    ids = _exp32(x) - 1.0
    return torch.clamp(ids.to(torch.int32), 0, vocab - 1)


def _uniform(generator, shape, dev) -> torch.Tensor:
    return U_MIN + (1.0 - U_MIN) * torch.rand(shape, generator=generator,
                                               device=dev)


def ctr_batch(
    generator: torch.Generator,
    batch: int,
    n_dense: int,
    vocab_sizes: Sequence[int],
    seq_len: int = 0,
    device=None,
) -> dict[str, torch.Tensor]:
    """One CTR batch drawn from ``generator`` (on ``device``; ``None``: the
    GPU).

    Returns dense [B, n_dense] f32, sparse ids [B, F] i32, label [B] f32,
    and optionally a behaviour-sequence hist_ids [B, seq_len] with its
    all-ones hist_mask (DIEN).
    """
    dev = resolve_device(device)
    dense = (torch.randn((batch, n_dense), generator=generator, device=dev)
             if n_dense else torch.zeros((batch, 0), device=dev))
    label = (torch.rand(batch, generator=generator, device=dev)
             < 0.25).to(torch.float32)
    sparse = torch.stack(
        [powerlaw_ids(_uniform(generator, (batch,), dev), v)
         for v in vocab_sizes],
        dim=1,
    )
    out = {"dense": dense.to(torch.float32), "sparse": sparse, "label": label}
    if seq_len:
        out["hist_ids"] = powerlaw_ids(
            _uniform(generator, (batch, seq_len), dev), int(vocab_sizes[0]))
        out["hist_mask"] = torch.ones((batch, seq_len), dtype=torch.float32,
                                      device=dev)
    return out


def batch_iterator(
    batch: int,
    n_dense: int,
    vocab_sizes: Sequence[int],
    seq_len: int = 0,
    seed: int = 0,
    device=None,
    start_step: int = 0,
) -> Iterator[dict[str, torch.Tensor]]:
    """Endless batches; step s draws from its own generator seeded from
    (seed, s), so a restart at ``start_step`` replays the same stream (the
    reference's ``fold_in``).  Batches land on ``device`` (the reference's
    ``sharding`` argument has no counterpart)."""
    dev = resolve_device(device)
    step = start_step
    while True:
        g = torch.Generator(device=dev).manual_seed(
            (int(seed) << 32) + int(step))
        yield ctr_batch(g, batch, n_dense, vocab_sizes, seq_len, device=dev)
        step += 1
