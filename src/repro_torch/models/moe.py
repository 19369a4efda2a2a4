"""Mixture-of-Experts FFN (port of ``repro.models.moe``): llama4-style top-1
routed experts plus a shared expert, with static-shape capacity dispatch.

Dispatch is gather-based, not one-hot-matmul: tokens are ranked within
their expert by a cumsum over the [T, E] assignment one-hot, dropped past
capacity C = max(8, ceil(T * cf / E)), and gathered into [E, C, d] for
batched per-expert products, O(T·E) dispatch bookkeeping instead of the
O(T·E·C) dense dispatch tensor.

A dropped token writes nothing: its routed output is 0 and only the
shared expert reaches it.  The reference writes every dropped token's
sentinel into slot [E-1, C-1] (``moe.py:100-104``), which overwrites the
token that legitimately holds that slot whenever a later token is
dropped (ROADMAP queue C, C10); the port follows the docstring's "dropped
past capacity" instead.  The reference's mesh constraints
(``_ambient_axes`` / ``_constrain``) have no counterpart: the port runs a
layer on one device.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int = 1
    d_ff: int = 8192
    capacity_factor: float = 1.25
    shared_expert: bool = True


def moe_init(generator, d_model: int, cfg: MoEConfig, dtype=torch.float32,
             device=None, lead=()):
    """Router (float32), stacked expert weights [*lead, E, ...] and the
    shared expert, drawn from ``generator`` on ``device``."""
    E, Fd = cfg.n_experts, cfg.d_ff
    s = 1.0 / (d_model ** 0.5)
    p = {
        "router": L.dense_init(generator, d_model, E, torch.float32,
                               device=device, lead=lead),
        "gate_w": L._normal(generator, (*lead, E, d_model, Fd), dtype,
                            device) * s,
        "up_w": L._normal(generator, (*lead, E, d_model, Fd), dtype,
                          device) * s,
        "down_w": L._normal(generator, (*lead, E, Fd, d_model), dtype,
                            device) * (1.0 / (Fd ** 0.5)),
    }
    if cfg.shared_expert:
        p["shared"] = L.glu_mlp_init(generator, d_model, Fd, dtype,
                                     device=device, lead=lead)
    return p


def capacity(cfg: MoEConfig, n_tokens: int) -> int:
    """Slots an expert holds for ``n_tokens`` tokens (the reference's C)."""
    return max(8, int(-(-n_tokens * cfg.capacity_factor // cfg.n_experts)))


def _act(h: torch.Tensor, act: str) -> torch.Tensor:
    return F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")


def moe_apply(params, x: torch.Tensor, cfg: MoEConfig, act: str = "silu"):
    """x: [B, S, d] -> ([B, S, d], aux) with aux ``lb_loss``, ``z_loss``
    and ``drop_frac`` as 0-dim float32 tensors."""
    B, S, d = x.shape
    T = B * S
    E = cfg.n_experts
    C = capacity(cfg, T)
    dev = x.device

    xt = x.reshape(T, d)
    logits = L.dot_f32(xt.to(torch.float32), params["router"]["w"])   # [T, E]
    probs = torch.softmax(logits, dim=-1)
    assign = torch.argmax(logits, dim=-1)               # top-1, first index
    gate = probs.gather(1, assign[:, None])[:, 0]

    # rank within expert + capacity drop
    onehot = F.one_hot(assign, E)                                  # [T, E]
    pos = onehot.cumsum(0).gather(1, assign[:, None])[:, 0] - 1
    keep = pos < C

    # [E, C] token index table; sentinel T points at an appended zero row.
    # Only kept tokens reach the table (C10: a drop writes nothing); drops
    # go to one spare slot past its end, cut off before use.
    slot = torch.where(keep, assign * C + pos, E * C)
    idx = torch.full((E * C + 1,), T, dtype=torch.int64, device=dev)
    idx.scatter_(0, slot, torch.arange(T, device=dev))
    idx = idx[:E * C].reshape(E, C)

    xpad = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    xe = xpad[idx]                                       # [E, C, d]

    h = _act(L.dot_f32(xe, params["gate_w"]), act).to(xe.dtype)
    u = L.dot_f32(xe, params["up_w"]).to(xe.dtype)
    y = L.dot_f32(h * u, params["down_w"]).to(xe.dtype)

    # combine: each kept token written once, the sentinel row dropped
    out = torch.zeros((T + 1, d), dtype=y.dtype, device=dev)
    out.index_add_(0, idx.reshape(-1), y.reshape(E * C, d))
    out = out[:T] * gate[:, None].to(y.dtype)

    if "shared" in params:
        out = out + L.glu_mlp(params["shared"], xt, act=act)

    # aux: load-balance loss (Switch) + router z-loss
    me = torch.mean(onehot.to(torch.float32), dim=0)
    ce = torch.mean(probs, dim=0)
    aux = {
        "lb_loss": E * torch.sum(me * ce),
        "z_loss": torch.mean(torch.square(torch.logsumexp(logits, dim=-1))),
        "drop_frac": 1.0 - torch.mean(keep.to(torch.float32)),
    }
    return out.reshape(B, S, d), aux
