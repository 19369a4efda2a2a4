"""Feature-interaction operators (port of
``repro.models.recsys.interactions``): dot (DLRM), cross-net v2 (DCN-v2),
field self-attention (AutoInt), and GRU / AUGRU (DIEN).

Under the paper's quantization all of these reduce to inner products over
(possibly int8) embeddings, which is why Definition-2 order preservation
carries CTR model quality.  No Pallas kernel stands behind them in the
reference: they are ``torch.matmul`` / ``einsum`` here as they are XLA
products there.  The reference's ``lax.scan`` over the sequence is a loop
over T.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import _normal


# -- DLRM dot interaction ---------------------------------------------------

def dot_interaction(feats: torch.Tensor, keep_diag: bool = False
                    ) -> torch.Tensor:
    """feats [B, F, d] -> upper-triangle pairwise dots [B, F*(F-1)/2], in
    row-major order (``jnp.triu_indices``'s: the top MLP's input order)."""
    _B, F, _ = feats.shape
    gram = torch.einsum("bfd,bgd->bfg", feats, feats)
    iu, ju = torch.triu_indices(F, F, offset=0 if keep_diag else 1,
                                device=feats.device)
    return gram[:, iu, ju]


# -- DCN-v2 cross network ---------------------------------------------------

def cross_init(generator, dim: int, n_layers: int, dtype=torch.float32,
               device=None):
    return {
        f"c{i}": {
            "w": _normal(generator, (dim, dim), dtype, device) * (dim ** -0.5),
            "b": torch.zeros((dim,), dtype=dtype,
                             device=resolve_device(device)),
        }
        for i in range(n_layers)
    }


def cross_apply(params, x0: torch.Tensor) -> torch.Tensor:
    """x_{l+1} = x0 * (W x_l + b) + x_l   (full-rank DCN-v2)."""
    x = x0
    for i in range(len(params)):
        p = params[f"c{i}"]
        x = x0 * (L._dot(x, p["w"]) + p["b"]) + x
    return x


# -- AutoInt field self-attention -------------------------------------------

def autoint_layer_init(generator, d_in: int, n_heads: int, d_head: int,
                       dtype=torch.float32, device=None):
    return {name: L.dense_init(generator, d_in, n_heads * d_head, dtype,
                               device=device)
            for name in ("wq", "wk", "wv", "wres")}


def autoint_layer(params, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Interacting layer: softmax self-attn over the field axis.
    x: [B, F, d_in] -> [B, F, n_heads * d_head], ReLU(residual + attn)."""
    B, F, _ = x.shape
    q = L.dense(params["wq"], x).reshape(B, F, n_heads, -1)
    k = L.dense(params["wk"], x).reshape(B, F, n_heads, -1)
    v = L.dense(params["wv"], x).reshape(B, F, n_heads, -1)
    s = torch.einsum("bfhd,bghd->bhfg", q, k)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhfg,bghd->bfhd", p, v).reshape(B, F, -1)
    return torch.relu(o + L.dense(params["wres"], x))


# -- GRU + AUGRU (DIEN) -----------------------------------------------------

def gru_init(generator, d_in: int, d_hidden: int, dtype=torch.float32,
             device=None):
    s = (d_in + d_hidden) ** -0.5
    return {
        "wx": _normal(generator, (d_in, 3 * d_hidden), dtype, device) * s,
        "wh": _normal(generator, (d_hidden, 3 * d_hidden), dtype, device) * s,
        "b": torch.zeros((3 * d_hidden,), dtype=dtype,
                         device=resolve_device(device)),
    }


def _gru_cell(p, h, x, att=None):
    """Standard GRU cell, gates in the order z, r, h:
    h~ = tanh(Wx x + r * (Wh h)); AUGRU scales the update gate z by att."""
    xz, xr, xh = torch.chunk(torch.matmul(x, p["wx"]), 3, dim=-1)
    hz, hr2, hh2 = torch.chunk(torch.matmul(h, p["wh"]), 3, dim=-1)
    bz, br, bh = torch.chunk(p["b"], 3)
    z = torch.sigmoid(xz + hz + bz)
    r = torch.sigmoid(xr + hr2 + br)
    hh = torch.tanh(xh + r * hh2 + bh)
    if att is not None:
        z = z * att[:, None]          # AUGRU: attention scales the update gate
    return (1.0 - z) * h + z * hh


def gru_scan(p, xs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """xs [B, T, d_in], mask [B, T] -> hidden states [B, T, d_hidden]; a
    step whose mask is 0 keeps the previous state."""
    B, T = xs.shape[:2]
    h = torch.zeros((B, p["wh"].shape[0]), dtype=xs.dtype, device=xs.device)
    hs = []
    for t in range(T):
        h = torch.where(mask[:, t, None] > 0, _gru_cell(p, h, xs[:, t]), h)
        hs.append(h)
    return torch.stack(hs, dim=1)


def augru_scan(p, xs: torch.Tensor, att: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Interest-evolution pass: attention-gated GRU. Returns the final
    state [B, d_hidden]."""
    B, T = xs.shape[:2]
    h = torch.zeros((B, p["wh"].shape[0]), dtype=xs.dtype, device=xs.device)
    for t in range(T):
        h = torch.where(mask[:, t, None] > 0,
                        _gru_cell(p, h, xs[:, t], att=att[:, t]), h)
    return h
