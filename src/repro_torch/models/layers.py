"""Shared model layers (port of ``repro.models.layers``): plain functions
on nested dicts of tensors, so every model is a function of its
parameter tree.

Initializers take an explicit ``torch.Generator`` (in place of a
``jax.random`` key) that must live on ``device`` (``None``: the GPU, as
every entry point; ``"meta"`` gives shapes only).  The two packages draw
different numbers from one seed: tests carry the reference's parameters
across (``convert.recsys_params_from_reference``,
``convert.lm_params_from_reference``).  Every product accumulates in
float32 and casts back to the input's dtype, as the reference's
``preferred_element_type`` does: float32 operands multiply in float32;
two bf16 (or fp16) operands multiply in that dtype with float32
accumulation and one rounding (``_dot``).  The initializers take a
``lead`` shape for stacked layer weights (``[n_blocks, ...]``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device


def _normal(generator, shape, dtype, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=resolve_device(device))


_HALF = (torch.bfloat16, torch.float16)


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with float32 accumulation, in x's dtype.

    Two bf16 (or two fp16) operands: one product in that dtype (the
    card's tensor cores accumulate in float32 and round once, as
    ``jnp.dot(..., preferred_element_type=f32).astype(bf16)``; the
    package switches off reduced-precision reductions at import).  Any
    other pair: both operands in float32, cast back to x's dtype.
    """
    if x.dtype in _HALF and w.dtype == x.dtype:
        return torch.matmul(x, w)
    return torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(x.dtype)


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w as float32 (``jnp.dot(x, w, preferred_element_type=f32)``
    without the cast back).  x: [..., k], w: [k, n] or a batch [E, k, n]
    beside x [E, m, k].  Two bf16 / fp16 operands on the card multiply in
    their dtype with a float32 output (``aten::mm.dtype`` /
    ``bmm.dtype``, differentiable through ``_HalfDotF32``), never through a
    float32 copy of w in the forward; elsewhere (float32 operands, or the
    CPU) both operands go to float32.  Both branches have one backward."""
    if x.dtype in _HALF and w.dtype == x.dtype and x.is_cuda:
        return _HalfDotF32.apply(x, w)
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def _half_mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if w.dim() == 3:
        return torch.bmm(x, w, out_dtype=torch.float32)
    out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
    return out.reshape(*x.shape[:-1], w.shape[-1])


class _HalfDotF32(torch.autograd.Function):
    """``dot_f32``'s card branch with a backward: ``aten::mm.dtype`` /
    ``bmm.dtype`` have no derivative.  The backward is the float32
    branch's: the float32 cotangent stays float32 (as the reference's)
    and meets float32 copies of the operands, each gradient cast back to
    its operand's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _half_mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        f32 = torch.float32
        dx = torch.matmul(g, w.to(f32).transpose(-1, -2)).to(x.dtype)
        if w.dim() == 3:
            dw = torch.matmul(x.to(f32).transpose(-1, -2), g)
        else:
            dw = torch.matmul(x.reshape(-1, x.shape[-1]).to(f32).T,
                              g.reshape(-1, g.shape[-1]))
        return dx, dw.to(w.dtype)


def dense_init(generator, in_dim: int, out_dim: int, dtype=torch.float32,
               scale: float | None = None, device=None, lead=()):
    if scale is None:
        scale = 1.0 / (in_dim ** 0.5)
    return {"w": _normal(generator, (*lead, in_dim, out_dim), dtype,
                         device) * scale}


def dense(params, x):
    return _dot(x, params["w"])


def embed_init(generator, vocab: int, dim: int, dtype=torch.float32,
               device=None):
    return {"table": _normal(generator, (vocab, dim), dtype, device) * 0.02}


def embed(params, ids):
    table = params["table"]
    ids = torch.as_tensor(ids, device=table.device).to(torch.int64)
    return table.index_select(0, ids.reshape(-1)).reshape(
        *ids.shape, table.shape[1])


def rmsnorm_init(dim: int, dtype=torch.float32, device=None, lead=()):
    return {"scale": torch.zeros((*lead, dim), dtype=dtype,
                                 device=resolve_device(device))}


def rmsnorm(params, x, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + params["scale"].to(torch.float32))).to(x.dtype)


# -- gated MLPs -------------------------------------------------------------

def glu_mlp_init(generator, d_model: int, d_ff: int, dtype=torch.float32,
                 device=None, lead=()):
    return {
        "gate": dense_init(generator, d_model, d_ff, dtype, device=device,
                           lead=lead),
        "up": dense_init(generator, d_model, d_ff, dtype, device=device,
                         lead=lead),
        "down": dense_init(generator, d_ff, d_model, dtype, device=device,
                           lead=lead),
    }


def glu_mlp(params, x, act: str = "gelu"):
    g = dense(params["gate"], x)
    # jax.nn.gelu's default is the tanh approximation
    g = F.gelu(g, approximate="tanh") if act == "gelu" else F.silu(g)
    return dense(params["down"], g * dense(params["up"], x))


def mlp_init(generator, dims: list[int], dtype=torch.float32, device=None):
    """Plain MLP stack (recsys towers): dims = [in, h1, ..., out]."""
    return {
        f"l{i}": {
            **dense_init(generator, dims[i], dims[i + 1], dtype,
                         device=device),
            "b": torch.zeros((dims[i + 1],), dtype=dtype,
                             device=resolve_device(device)),
        }
        for i in range(len(dims) - 1)
    }


def mlp(params, x, act=torch.relu, final_act: bool = False):
    n = len(params)
    for i in range(n):
        p = params[f"l{i}"]
        x = _dot(x, p["w"]) + p["b"]
        if i < n - 1 or final_act:
            x = act(x)
    return x


def unstack(tree, n: int) -> list:
    """The n layers of a tree whose leaves are stacked [n, ...] (the
    reference's ``vmap``-built layer stacks), each leaf unbound once: a
    backward through them stacks the layers' gradients in one pass."""
    if isinstance(tree, dict):
        subs = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: subs[k][i] for k in subs} for i in range(n)]
    return tree.unbind(0)


# -- rotary position embeddings ---------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, base: float = 10000.0):
    """Apply RoPE. x: [B, S, H, hd], positions: [B, S]."""
    hd = x.shape[-1]
    half = hd // 2
    freq = base ** (-torch.arange(0, half, dtype=torch.float32,
                                  device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freq   # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None):
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def shifted_softplus(x):
    """SchNet's ssp activation: ln(0.5 e^x + 0.5)."""
    return torch.logaddexp(x, torch.zeros_like(x)) - math.log(2.0)
