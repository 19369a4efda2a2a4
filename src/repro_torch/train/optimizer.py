"""Optimizers + LR schedules (port of ``repro.train.optimizer``), with no
optimizer library: no ``torch.optim`` class, no fused or foreach kernel.

AdamW with decoupled weight decay and global-norm clipping; schedules:
linear-warmup cosine, constant, and WSD (warmup-stable-decay: the
minicpm-2b schedule, arXiv:2404.06395).  The arithmetic is the
reference's, in float32 tensors: ``lr_at`` agrees with it within an ulp
(the cosine taken correctly rounded), and ``adamw_update`` reports
the gradient norm before the clip, as the reference does.

State is a params-shaped nest of float32 tensors (``mu``, ``nu``) and an
int32 ``step``.  ``adamw_update`` works leaf by leaf: each gradient is cast
to float32, scaled, folded into its moments and the parameter written back
in its own dtype, so the float32 transients are never a float32 copy of
the whole tree; each leaf is updated a block of its leading rows at a
time, up to ``_CHUNK`` elements a block, so they stay a block's even for
a large leaf (at gemma2-9b's width its 917 M-element embedding table).
It returns new tensors and leaves its arguments as they were, as the
reference's jitted update does.  Its constants enter as Python numbers,
so a step on the card never waits for the host.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: str = "cosine"        # cosine | wsd | const
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1         # WSD: final fraction of steps that decay
    min_lr_ratio: float = 0.1


#: elements a leaf is updated in at a time: the update is elementwise, so
#: a leaf is cut into blocks of its leading rows (one block for a small
#: leaf) and its float32 transients stay a block's size
_CHUNK = 1 << 24


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _cos32(x: torch.Tensor) -> torch.Tensor:
    """float32 cos, correctly rounded (through float64): torch's float32
    ``cos`` can be an ulp off, and near cos = -1 the schedule's 1 + cos
    turns that ulp into several of the learning rate."""
    return torch.cos(x.to(torch.float64)).to(torch.float32)


def lr_at(step, cfg: OptConfig) -> torch.Tensor:
    """Schedule value at ``step`` (an int or a tensor), a 0-dim float32
    tensor on the step's device."""
    step = _f32(step, step.device if torch.is_tensor(step) else None)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "const":
        return cfg.lr * warm
    if cfg.schedule == "cosine":
        t = torch.clamp(
            (step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + _cos32(math.pi * t))
        return cfg.lr * warm * (cfg.min_lr_ratio
                                + (1 - cfg.min_lr_ratio) * cos)
    if cfg.schedule == "wsd":
        decay_steps = int(cfg.total_steps * cfg.decay_frac)
        stable_end = cfg.total_steps - decay_steps
        t = torch.clamp((step - stable_end) / max(decay_steps, 1), 0.0, 1.0)
        decay = 1.0 - (1.0 - cfg.min_lr_ratio) * t
        return cfg.lr * warm * torch.where(step < stable_end,
                                           torch.ones_like(decay), decay)
    raise ValueError(cfg.schedule)


def _map(fn, *trees):
    """``fn`` over the leaves of nests of dicts that share one structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def adamw_init(params):
    """Zero float32 moments shaped like ``params`` and step 0 (int32), on
    the parameters' devices."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    first = next(_leaves(params))
    return {"mu": _map(zeros, params), "nu": _map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares."""
    sums = [torch.sum(torch.square(g.to(torch.float32)))
            for g in _leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def adamw_update(grads, state, params, cfg: OptConfig):
    """Returns (new_params, new_state, metrics {"grad_norm", "lr"})."""
    step = state["step"] + 1
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(cfg.b1, stepf)
    bc2 = 1 - torch.pow(cfg.b2, stepf)
    lr = lr_at(step, cfg)

    def part(g, m, n, p):
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        n = cfg.b2 * n + (1 - cfg.b2) * g * g
        pf = p.to(torch.float32)
        update = (m / bc1) / (torch.sqrt(n / bc2) + cfg.eps)
        update = update + cfg.weight_decay * pf
        return (pf - lr * update).to(p.dtype), m, n

    def one(g, m, n, p):
        if p.dim() == 0:
            return part(g, m, n, p)
        outs = (torch.empty_like(p), torch.empty_like(m), torch.empty_like(n))
        rows = max(1, _CHUNK // max(p[0].numel(), 1))
        for i in range(0, p.shape[0], rows):
            cut = slice(i, i + rows)
            for o, v in zip(outs, part(g[cut], m[cut], n[cut], p[cut])):
                o[cut] = v
        return outs

    out = _map(one, grads, state["mu"], state["nu"], params)
    new_params = _unzip(out, 0)
    new_state = {"mu": _unzip(out, 1), "nu": _unzip(out, 2), "step": step}
    return new_params, new_state, {"grad_norm": gn, "lr": lr}


def _unzip(tree, i: int):
    if isinstance(tree, dict):
        return {k: _unzip(v, i) for k, v in tree.items()}
    return tree[i]
