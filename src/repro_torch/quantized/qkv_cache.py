"""int8 KV cache: the paper's quantization applied to LM decode (port of
``repro.quantized.qkv_cache``).

Decode attention logits are inner products q·K over the cache: the
paper's MIP problem, with the cache as the corpus and Definition 2
guaranteeing top-k (attention-weight ordering) preservation.  Eq. 1 is
applied per (layer, kv-head, head-dim) with abs-max constants, codes int8:

    K ≈ scale_k ⊙ K_codes        V ≈ scale_v ⊙ V_codes

Scoring never dequantizes the cache: the per-dim k scale folds into the
single query vector (q' = q ⊙ scale_k) and the v scale into the O(1)-sized
attention output.  Codes round half to even and clip to [-128, 127], as
the reference's ``jnp.round`` / ``jnp.clip``.  The reference computes the
codes and scores with ``jnp`` ops (no Pallas kernel), and so does the
port, in plain PyTorch.  ``decode_step_q8`` writes the new token's codes
into the cache in place and raises ``ValueError`` at ``cur_len >=
max_len`` (the reference overwrites the last slot).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.models.transformer import LMConfig


@dataclasses.dataclass(frozen=True)
class QuantizedCache:
    """int8 KV cache with per (layer, kv-head, dim) scales.

    Block-major layout matching ``transformer.cache_shape``:
    codes [n_blocks, block_layers, B, S, Hkv, hd] int8, scales [nb, bl,
    Hkv, hd] float32.
    """

    k_codes: torch.Tensor
    v_codes: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k_codes.shape[3]


def make_quantized_cache(cfg: LMConfig, batch: int, max_len: int,
                         device=None) -> QuantizedCache:
    """Empty codes and unit scales on ``device`` (``None``: the GPU)."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    shape = TF.cache_shape(cfg, batch, max_len)
    sshape = (cfg.n_blocks, cfg.block_layers, cfg.n_kv, cfg.head_dim)
    return QuantizedCache(
        k_codes=torch.zeros(shape, dtype=torch.int8, device=dev),
        v_codes=torch.zeros(shape, dtype=torch.int8, device=dev),
        k_scale=torch.ones(sshape, dtype=torch.float32, device=dev),
        v_scale=torch.ones(sshape, dtype=torch.float32, device=dev),
    )


def _absmax_scale(x: torch.Tensor) -> torch.Tensor:
    """abs-max per (block, sub, kv-head, dim) over batch and sequence."""
    amax = torch.amax(torch.abs(x.to(torch.float32)), dim=(2, 3))
    return torch.clamp(amax, min=1e-8) / 127.0


def _codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp -> int8 codes: round(x / scale) half to even, clipped."""
    q = torch.round(x.to(torch.float32) / scale)
    return torch.clamp(q, -128, 127).to(torch.int8)


def quantize_cache(k: torch.Tensor, v: torch.Tensor,
                   max_len: int) -> QuantizedCache:
    """Compress a prefill fp cache [nb, bl, B, S, Hkv, hd] into codes and
    scales, zero codes padding S up to ``max_len``.

    This is the paper's 'learn constants from the corpus' step, with the
    prefill cache as the corpus; decode steps reuse the constants.
    """
    k_scale = _absmax_scale(k)
    v_scale = _absmax_scale(v)
    per = (slice(None), slice(None), None, None)     # scales over B, S
    kc = _codes(k, k_scale[per])
    vc = _codes(v, v_scale[per])
    pad = max_len - kc.shape[3]
    if pad > 0:
        padw = (0, 0, 0, 0, 0, pad)
        kc = torch.nn.functional.pad(kc, padw)
        vc = torch.nn.functional.pad(vc, padw)
    return QuantizedCache(k_codes=kc, v_codes=vc, k_scale=k_scale,
                          v_scale=v_scale)


def quantized_decode_attention(q, k_codes, v_codes, k_scale, v_scale,
                               cur_len, window=A.GLOBAL, chunk=A.GLOBAL,
                               cap: float | None = None):
    """Decode attention over int8 codes: q [B, 1, H, hd] fp, codes [B, S,
    Hkv, hd] int8, scales [Hkv, hd]; the scales fold into q and into the
    output."""
    B, _, H, hd = q.shape
    S, Hkv = k_codes.shape[1], k_codes.shape[2]
    g = H // Hkv
    scale = hd ** -0.5

    qf = (q.to(torch.float32) * scale).reshape(B, Hkv, g, hd)
    q_folded = qf * k_scale[None, :, None, :]          # fold k scale into q
    s = L.softcap(torch.matmul(q_folded,
                               A.heads_f32(k_codes).transpose(-1, -2)), cap)
    s = s.masked_fill(~A._decode_valid(cur_len, S, window, chunk, q.device),
                      A.NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p, A.heads_f32(v_codes))
    out = out * v_scale[None, :, None, :]              # fold v scale into output
    return out.reshape(B, 1, H, hd).to(q.dtype)


def decode_step_q8(params, qcache: QuantizedCache, token, cur_len,
                   cfg: LMConfig):
    """One decode step over the int8 cache (mirror of
    ``transformer.decode_step``): the new token's k / v are quantized with
    the cache's constants and written at ``cur_len`` in place.  Returns
    (logits [B, padded_vocab] float32, the cache)."""
    cur = TF._position(cur_len, qcache.max_len)
    B = token.shape[0]
    x = TF._embed(params, token, cfg)
    win, chk = (t.tolist() for t in cfg.layer_locality())
    pos2d = torch.full((B, 1), cur, dtype=torch.int64, device=x.device)

    for i in range(cfg.n_blocks):
        bp = TF._block(params["layers"], i)
        for j in range(cfg.block_layers):
            lp = bp[f"sub{j}"]
            q, k, v = TF._decode_qkv(cfg, lp, x, pos2d, B)
            kc, vc = qcache.k_codes[i, j], qcache.v_codes[i, j]    # views
            ks, vs = qcache.k_scale[i, j], qcache.v_scale[i, j]
            # quantize the incoming token with the cache's constants
            kc[:, cur] = _codes(k[:, 0], ks)
            vc[:, cur] = _codes(v[:, 0], vs)
            o = quantized_decode_attention(
                q, kc, vc, ks, vs, cur + 1, window=win[i][j],
                chunk=chk[i][j], cap=cfg.attn_softcap)
            x = TF._decode_out(cfg, lp, x, o, j, B)
    return TF._logits(params, x, cfg)[:, 0], qcache


def cache_memory_bytes(cfg: LMConfig, batch: int, max_len: int,
                       quantized: bool) -> int:
    per = cfg.n_layers * batch * max_len * cfg.n_kv * cfg.head_dim
    if quantized:
        return 2 * per + 2 * cfg.n_layers * cfg.n_kv * cfg.head_dim * 4
    return 2 * per * 2  # bf16
