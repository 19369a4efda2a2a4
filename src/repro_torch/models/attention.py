"""Attention (port of ``repro.models.attention``): GQA / MQA with RoPE,
logit soft-cap, and three sparsity patterns (global causal, sliding
window, chunked-local) given as per-layer window / chunk integers, so one
layer body serves gemma-2b (MQA global), gemma2-9b (alternating local /
global + soft-cap), minicpm (MHA global) and llama4 (chunked local,
iRoPE-style).

Prefill uses the blockwise online softmax of ``models.flash``, whose live
intermediate is one [B, block_q, H, block_kv] tile instead of [S, S].
Decode attends a 1-token query against the cache (the int8 cache is
``quantized.qkv_cache``).  Query head h reads kv head h // g (g = H / Hkv),
as the reference's ``reshape(B, Hkv, g, hd)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import flash as FL
from repro_torch.models import layers as L

NEG_INF = -2.0e38
# sentinel meaning "no locality constraint" for window/chunk scalars
GLOBAL = 2**30


def attn_init(generator, d_model: int, n_heads: int, n_kv: int,
              head_dim: int, dtype=torch.float32, device=None, lead=()):
    return {
        "wq": L.dense_init(generator, d_model, n_heads * head_dim, dtype,
                           device=device, lead=lead),
        "wk": L.dense_init(generator, d_model, n_kv * head_dim, dtype,
                           device=device, lead=lead),
        "wv": L.dense_init(generator, d_model, n_kv * head_dim, dtype,
                           device=device, lead=lead),
        "wo": L.dense_init(generator, n_heads * head_dim, d_model, dtype,
                           device=device, lead=lead),
    }


def blockwise_attention(q, k, v, qpos, window=GLOBAL, chunk=GLOBAL,
                        cap: float | None = None, block_q: int = 1024,
                        block_kv: int = 1024, n_heads: int | None = None):
    """Flash-style attention: q [B, Sq, H, hd], k / v [B, Sk, Hkv, hd],
    qpos [Sq] absolute positions -> [B, Sq, H, hd].  q and kv are padded
    to multiples of the block sizes (padded keys masked, padded query rows
    cut off), as the reference does."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    bq = min(block_q, Sq)
    bkv = min(block_kv, Sk)
    qpos = FL.positions(qpos, q.device)

    n_valid_k = Sk
    if Sk % bkv:
        pad = bkv - Sk % bkv
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    n_valid_q = Sq
    if Sq % bq:
        padq = bq - Sq % bq
        q = F.pad(q, (0, 0, 0, 0, 0, padq))
        qpos = F.pad(qpos, (0, padq))
    out = FL.flash_attention(q, k, v, qpos, (int(window), int(chunk)), cap,
                             bq, bkv, n_valid_k)
    return out[:, :n_valid_q]


def decode_attention(q, k_cache, v_cache, cur_len, window=GLOBAL,
                     chunk=GLOBAL, cap: float | None = None):
    """Single-token decode: q [B, 1, H, hd] against a cache [B, S, Hkv, hd]
    whose first ``cur_len`` positions (a scalar or one per row) are
    valid."""
    B, _, H, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    g = H // Hkv
    scale = hd ** -0.5

    qf = (q.to(torch.float32) * scale).reshape(B, Hkv, g, hd)
    s = L.softcap(torch.matmul(qf, heads_f32(k_cache).transpose(-1, -2)),
                  cap)                                       # [B, Hkv, g, S]
    s = s.masked_fill(~_decode_valid(cur_len, S, window, chunk, q.device),
                      NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p, heads_f32(v_cache))
    return out.reshape(B, 1, H, hd).to(q.dtype)


def heads_f32(x):
    """[B, S, Hkv, hd] (any dtype) -> a float32 [B, Hkv, S, hd] copy, made
    in one pass: a batch of matrices the products read as they lie."""
    return x.transpose(1, 2).to(torch.float32,
                                memory_format=torch.contiguous_format)


def _decode_valid(cur_len, S: int, window, chunk, device):
    """[1 or B, 1, 1, S] mask of the positions a query at ``cur_len - 1``
    attends."""
    kpos = torch.arange(S, device=device)
    qpos = torch.as_tensor(cur_len, device=device).reshape(-1) - 1
    return FL.valid_mask(qpos, kpos, window, chunk)[:, None, None, :]


def attention_block(params, x, qpos, n_heads: int, n_kv: int, head_dim: int,
                    window=GLOBAL, chunk=GLOBAL, cap: float | None = None,
                    rope_base: float = 10000.0, block_q: int = 1024,
                    block_kv: int = 1024):
    """Full prefill attention block (projections + blockwise attention):
    x [B, S, d_model] -> (out [B, S, d_model], (k, v) after RoPE)."""
    B, S, _ = x.shape
    q = L.dense(params["wq"], x).reshape(B, S, n_heads, head_dim)
    k = L.dense(params["wk"], x).reshape(B, S, n_kv, head_dim)
    v = L.dense(params["wv"], x).reshape(B, S, n_kv, head_dim)
    pos2d = torch.as_tensor(qpos, device=x.device)[None, :].expand(B, S)
    q = L.rope(q, pos2d, rope_base)
    k = L.rope(k, pos2d, rope_base)
    o = blockwise_attention(q, k, v, qpos, window=window, chunk=chunk,
                            cap=cap, block_q=block_q, block_kv=block_kv)
    return L.dense(params["wo"], o.reshape(B, S, n_heads * head_dim)), (k, v)
