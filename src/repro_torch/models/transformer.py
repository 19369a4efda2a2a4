"""Decoder-only LM covering the five LM architectures through one layer
body (port of ``repro.models.transformer``).

Architecture features are config data, not code forks:
  * GQA / MQA (n_kv), explicit head_dim (gemma's 256 != d_model / n_heads),
  * GeGLU / SwiGLU MLPs, embedding scaling by sqrt(d_model),
  * attention / final logit soft-capping (gemma-2),
  * per-layer locality pattern: 'g' global, 'l' sliding-window, 'c'
    chunked-local (llama4 iRoPE-style), as per-layer window / chunk ints,
  * optional MoE FFN (llama4: 16 / 128 experts, top-1 + shared), with
    ``moe_every=2`` interleaving dense and MoE layers (llama4-maverick)
    as homogeneous layer *blocks*,
  * vocabulary padding to a multiple of 256 (minicpm's 122753 -> 122880);
    padded logit columns are masked to NEG_INF.

Layer parameters are stacked along a leading [n_blocks, ...] axis, as the
reference's, so a reference tree converts leaf by leaf
(``convert.lm_params_from_reference``); the forward loops over blocks
(each stacked leaf unbound once a call, so a backward stacks the blocks'
gradients in one pass).  With ``remat`` (the reference's default) and a
graph to build, each block's body runs under
``torch.utils.checkpoint.checkpoint``, the reference's ``jax.checkpoint``:
only its input is kept, and the backward recomputes the rest.
Numerics follow the reference: bf16 products accumulate in float32 and
round once (``layers._dot``), the final logits are a product with float32
output (``layers.dot_f32``), and the embedding scale is rounded to the
model dtype before the multiply (``jnp.asarray(d**0.5, dtype)``: sqrt(3584) =
59.866 is 59.75 in bf16).

Decode writes the new token's k / v into the carried caches in place.  At
``cur_len >= max_len`` it raises ``ValueError``, where the reference's
clamped ``dynamic_update_slice`` silently overwrites the last slot
(ROADMAP queue C, port notes).  ``lm_loss`` is the training objective:
masked next-token cross-entropy, plus MoE's load-balance and router
z-losses.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "gelu"                      # geglu -> "gelu", swiglu -> "silu"
    rope_base: float = 10000.0
    layer_pattern: str = "g"               # tiled to n_layers: g/l/c
    window: int = 4096                     # for 'l' layers
    chunk: int = 8192                      # for 'c' layers
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    scale_embed: bool = True
    moe: Optional[M.MoEConfig] = None
    moe_every: int = 1                     # 2 = dense/MoE interleave (maverick)
    dense_d_ff: Optional[int] = None       # dense-layer d_ff in interleave mode
    dtype: str = "bfloat16"
    block_q: int = 1024
    block_kv: int = 1024
    remat: bool = True
    pad_vocab_multiple: int = 256

    @property
    def tdtype(self) -> torch.dtype:
        """The torch dtype named by ``dtype``."""
        return getattr(torch, self.dtype)

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_multiple
        return ((self.vocab + m - 1) // m) * m

    @property
    def block_layers(self) -> int:
        """Layers per block (1 unless MoE interleaving)."""
        return self.moe_every if self.moe is not None else 1

    @property
    def n_blocks(self) -> int:
        if self.n_layers % self.block_layers:
            raise ValueError(f"{self.n_layers} layers do not split into "
                             f"blocks of {self.block_layers}")
        return self.n_layers // self.block_layers

    def sub_uses_moe(self, j: int) -> bool:
        """Does sub-layer j of a block use the MoE FFN?"""
        return self.moe is not None and j == self.block_layers - 1

    def sub_d_ff(self, j: int) -> int:
        if self.moe is not None and not self.sub_uses_moe(j):
            return self.dense_d_ff or self.d_ff
        return self.d_ff

    def layer_locality(self):
        """Per-layer (window, chunk) int32 tensors [n_blocks, block_layers]
        (on the CPU) from the pattern string."""
        pat = (self.layer_pattern * self.n_layers)[: self.n_layers]
        win = [self.window if c == "l" else A.GLOBAL for c in pat]
        chk = [self.chunk if c == "c" else A.GLOBAL for c in pat]
        shape = (self.n_blocks, self.block_layers)
        return (torch.tensor(win, dtype=torch.int32).reshape(shape),
                torch.tensor(chk, dtype=torch.int32).reshape(shape))

    def param_count(self) -> int:
        return self._count(self.moe.n_experts if self.moe else 0)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts + shared)."""
        if self.moe is None:
            return self.param_count()
        return self._count(self.moe.top_k)

    def _count(self, experts: int) -> int:
        d, v = self.d_model, self.vocab
        attn = (d * self.n_heads * self.head_dim * 2
                + d * self.n_kv * self.head_dim * 2)
        total = v * d + d
        for i in range(self.n_layers):
            j = i % self.block_layers
            total += attn + 2 * d
            if self.sub_uses_moe(j):
                total += (3 * d * self.moe.d_ff * experts
                          + d * self.moe.n_experts)
                if self.moe.shared_expert:
                    total += 3 * d * self.moe.d_ff
            else:
                total += 3 * d * self.sub_d_ff(j)
        return total


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _sub_layer_init(generator, cfg: LMConfig, j: int, device, lead):
    dt = cfg.tdtype
    p = {
        "attn": A.attn_init(generator, cfg.d_model, cfg.n_heads, cfg.n_kv,
                            cfg.head_dim, dt, device=device, lead=lead),
        "ln1": L.rmsnorm_init(cfg.d_model, dt, device=device, lead=lead),
        "ln2": L.rmsnorm_init(cfg.d_model, dt, device=device, lead=lead),
    }
    if cfg.sub_uses_moe(j):
        p["moe"] = M.moe_init(generator, cfg.d_model, cfg.moe, dt,
                              device=device, lead=lead)
    else:
        p["mlp"] = L.glu_mlp_init(generator, cfg.d_model, cfg.sub_d_ff(j), dt,
                                  device=device, lead=lead)
    return p


def init_params(generator: torch.Generator, cfg: LMConfig, device=None):
    """The parameter tree of ``cfg`` (layers stacked [n_blocks, ...]),
    drawn from ``generator``, which must live on ``device`` (``None``: the
    GPU).  The reference's ``jax.random`` draws cannot be reproduced, so
    tests carry its parameters across instead."""
    lead = (cfg.n_blocks,)
    return {
        "embed": L.embed_init(generator, cfg.padded_vocab, cfg.d_model,
                              cfg.tdtype, device=device),
        "layers": {f"sub{j}": _sub_layer_init(generator, cfg, j, device, lead)
                   for j in range(cfg.block_layers)},
        "final_norm": L.rmsnorm_init(cfg.d_model, cfg.tdtype, device=device),
    }


def abstract_params(cfg: LMConfig):
    """The parameter tree's shapes and dtypes, as tensors on the meta
    device (nothing is allocated)."""
    return init_params(torch.Generator(), cfg, device="meta")


# --------------------------------------------------------------------------
# forward (train / prefill)
# --------------------------------------------------------------------------

def _block(tree, i: int):
    """Block i's parameters: each stacked leaf indexed at i (views)."""
    if isinstance(tree, dict):
        return {k: _block(v, i) for k, v in tree.items()}
    return tree[i]


def _embed(params, tokens, cfg: LMConfig):
    x = L.embed(params["embed"], tokens).to(cfg.tdtype)
    if cfg.scale_embed:
        # the reference rounds the scale to the model dtype first
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.tdtype).item()
    return x


def _no_aux(device):
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"lb_loss": z, "z_loss": z, "drop_frac": z}


def _ffn(cfg: LMConfig, lp, x, j: int):
    """x + the sub-layer's MLP (or MoE) on its normed input, and the aux."""
    m_in = L.rmsnorm(lp["ln2"], x)
    if cfg.sub_uses_moe(j):
        m_out, aux = M.moe_apply(lp["moe"], m_in, cfg.moe, act=cfg.act)
    else:
        m_out, aux = L.glu_mlp(lp["mlp"], m_in, act=cfg.act), _no_aux(x.device)
    return x + m_out, aux


def _logits(params, x, cfg: LMConfig):
    """Final norm and the tied-embedding logits, float32 [..., padded_vocab]."""
    x = L.rmsnorm(params["final_norm"], x)
    logits = L.dot_f32(x, params["embed"]["table"].T)
    logits = L.softcap(logits, cfg.final_softcap)
    return _mask_padded_logits(logits, cfg)


def _mask_padded_logits(logits, cfg: LMConfig):
    if cfg.padded_vocab == cfg.vocab:
        return logits
    valid = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
    return torch.where(valid, logits, A.NEG_INF)


def _tracked(tree, x) -> bool:
    """Does autograd record this block (grad mode on, and the block's
    input or a parameter requires grad)?"""
    if not torch.is_grad_enabled():
        return False
    if x.requires_grad:
        return True
    if isinstance(tree, dict):
        return any(_tracked(v, x) for v in tree.values())
    return tree.requires_grad


def _run_block(cfg: LMConfig, bp, x, qpos, win, chk, kvs, i: int):
    """Block i on x: its block_layers sub-layers (attention, then MLP or
    MoE); (x, the aux means), the caches written where ``kvs`` is given."""
    auxs = []
    for j in range(cfg.block_layers):
        lp = bp[f"sub{j}"]
        a_out, (k, v) = A.attention_block(
            lp["attn"], L.rmsnorm(lp["ln1"], x), qpos,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
            window=win[j], chunk=chk[j], cap=cfg.attn_softcap,
            rope_base=cfg.rope_base, block_q=cfg.block_q,
            block_kv=cfg.block_kv)
        if kvs is not None:
            kvs[0][i, j] = k
            kvs[1][i, j] = v
        x, aux = _ffn(cfg, lp, x + a_out, j)
        auxs.append(aux)
    return x, {name: torch.stack([a[name] for a in auxs]).mean()
               for name in auxs[0]}


def forward(params, tokens, cfg: LMConfig, collect_kv: bool = False,
            logits_mode: str = "full"):
    """tokens [B, S] -> logits [B, S, padded_vocab] float32 (``"last"``:
    [B, 1, ...]) and the aux means; with ``collect_kv`` also the caches
    (k, v), each [n_blocks, block_layers, B, S, Hkv, hd] after RoPE."""
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    dev = x.device
    # on the meta device the positions stay on the host (flash.positions)
    qpos = torch.arange(S, device="cpu" if dev.type == "meta" else dev)
    win, chk = (t.tolist() for t in cfg.layer_locality())
    kvs = None
    if collect_kv:
        shape = cache_shape(cfg, B, S)
        kvs = (torch.empty(shape, dtype=x.dtype, device=dev),
               torch.empty(shape, dtype=x.dtype, device=dev))

    block_aux = []
    for i, bp in enumerate(L.unstack(params["layers"], cfg.n_blocks)):
        if cfg.remat and not collect_kv and _tracked(bp, x):
            x, aux = checkpoint(_run_block, cfg, bp, x, qpos, win[i], chk[i],
                                None, i, use_reentrant=False)
        else:
            x, aux = _run_block(cfg, bp, x, qpos, win[i], chk[i], kvs, i)
        block_aux.append(aux)

    if logits_mode == "last":
        x = x[:, -1:]                # avoid the [B, S, vocab] materialization
    logits = _logits(params, x, cfg)
    aux = {name: torch.stack([a[name] for a in block_aux]).mean()
           for name in block_aux[0]}
    if collect_kv:
        return logits, kvs, aux
    return logits, aux


def lm_loss(params, batch, cfg: LMConfig):
    """Masked next-token cross-entropy of ``batch`` (``tokens``,
    ``targets``, ``mask`` [B, S]), in float32; MoE configs add 0.01 x the
    load-balance loss and 1e-3 x the router z-loss.  Returns (loss, aux)."""
    logits, aux = forward(params, batch["tokens"], cfg)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, batch["targets"].to(torch.int64)[..., None])
    nll = lse - tgt[..., 0]
    mask = batch["mask"]
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    if cfg.moe is not None:
        loss = loss + 0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
    return loss, aux


# --------------------------------------------------------------------------
# prefill + decode (serving)
# --------------------------------------------------------------------------

def prefill(params, tokens, cfg: LMConfig):
    """Run the prompt, return (last-position logits [B, padded_vocab], kv
    caches (k, v) [n_blocks, block_layers, B, S, Hkv, hd])."""
    logits, kvs, _ = forward(params, tokens, cfg, collect_kv=True,
                             logits_mode="last")
    return logits[:, -1], kvs


def _position(cur_len, max_len: int) -> int:
    """``cur_len`` (an int or a 0-dim tensor) as an int, checked against the
    cache's length: the write at ``cur_len`` must land inside it."""
    cur = int(cur_len)
    if not 0 <= cur < max_len:
        raise ValueError(f"cur_len {cur} is outside the cache of max_len "
                         f"{max_len}: the token at position {cur} has no slot "
                         "(the reference would overwrite the last one)")
    return cur


def _decode_qkv(cfg: LMConfig, lp, x, pos2d, B: int):
    """The sub-layer's normed input projected to q, k, v [B, 1, heads, hd],
    q and k after RoPE at ``pos2d``."""
    a_in = L.rmsnorm(lp["ln1"], x)
    q = L.dense(lp["attn"]["wq"], a_in).reshape(B, 1, cfg.n_heads,
                                                cfg.head_dim)
    k = L.dense(lp["attn"]["wk"], a_in).reshape(B, 1, cfg.n_kv, cfg.head_dim)
    v = L.dense(lp["attn"]["wv"], a_in).reshape(B, 1, cfg.n_kv, cfg.head_dim)
    return (L.rope(q, pos2d, cfg.rope_base), L.rope(k, pos2d, cfg.rope_base),
            v)


def _decode_out(cfg: LMConfig, lp, x, o, j: int, B: int):
    x = x + L.dense(lp["attn"]["wo"],
                    o.reshape(B, 1, cfg.n_heads * cfg.head_dim))
    return _ffn(cfg, lp, x, j)[0]


def decode_step(params, caches, token, cur_len, cfg: LMConfig):
    """One decode step.

    caches: (k_cache, v_cache) each [n_blocks, block_layers, B, Smax, Hkv,
    hd], updated in place at position ``cur_len`` (the tokens already in
    the cache; an int or 0-dim tensor); token: [B, 1] int.  Returns
    (logits [B, padded_vocab] float32, caches).  The int8 cache is
    ``quantized.qkv_cache.decode_step_q8``.
    """
    kb, vb = caches
    cur = _position(cur_len, kb.shape[3])
    B = token.shape[0]
    x = _embed(params, token, cfg)
    win, chk = (t.tolist() for t in cfg.layer_locality())
    pos2d = torch.full((B, 1), cur, dtype=torch.int64, device=x.device)

    for i in range(cfg.n_blocks):
        bp = _block(params["layers"], i)
        for j in range(cfg.block_layers):
            lp = bp[f"sub{j}"]
            q, k, v = _decode_qkv(cfg, lp, x, pos2d, B)
            kc, vc = kb[i, j], vb[i, j]                     # views
            kc[:, cur] = k[:, 0].to(kc.dtype)
            vc[:, cur] = v[:, 0].to(vc.dtype)
            o = A.decode_attention(q, kc, vc, cur + 1, window=win[i][j],
                                   chunk=chk[i][j], cap=cfg.attn_softcap)
            x = _decode_out(cfg, lp, x, o, j, B)
    return _logits(params, x, cfg)[:, 0], (kb, vb)


def cache_shape(cfg: LMConfig, batch: int, max_len: int) -> tuple:
    """Canonical (block-major) KV cache shape."""
    return (cfg.n_blocks, cfg.block_layers, batch, max_len, cfg.n_kv,
            cfg.head_dim)


def make_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device=None):
    """Empty fp KV cache [n_blocks, block_layers, B, Smax, Hkv, hd] x2 on
    ``device`` (``None``: the GPU)."""
    from repro_torch.device import resolve_device

    dtype = dtype or cfg.tdtype
    shape = cache_shape(cfg, batch, max_len)
    dev = resolve_device(device)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def write_prefix(cache, prefix, start: int = 0):
    """Write prefill kv (same layout, shorter S at axis 3) into ``cache`` at
    ``start``, in place; returns the cache.  Raises ``ValueError`` where
    the prefix would not fit (the reference clamps ``start``)."""
    n = prefix.shape[3]
    if not 0 <= start <= cache.shape[3] - n:
        raise ValueError(f"a prefix of {n} positions at {start} does not fit "
                         f"a cache of max_len {cache.shape[3]}")
    cache[:, :, :, start:start + n] = prefix.to(cache.dtype)
    return cache
