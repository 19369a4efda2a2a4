"""Blockwise (flash-style) attention in plain PyTorch (port of
``repro.models.flash``, its forward ``_flash_fwd_impl``).

A q-blocked, kv-blocked online softmax in float32: no more than one
[B, Hkv, block_q * g, block_kv] score tile lives at a time.  It supports
GQA (query head h reads kv head h // g), the causal mask, sliding-window
and chunked-local masks, the padded-key mask ``kpos < n_valid_k`` and the
gemma-2 logit soft-cap.  The reference is pure ``jax.numpy`` (no Pallas
kernel stands behind it), so this is plain PyTorch as well; no finished
attention kernel computes the soft-cap with the chunk mask.

A kv tile that every (query, key) pair of its q block masks is skipped.
That is exact: after a valid tile it would add exp(NEG_INF - m) = 0 at
corr = 1, and before one its contribution is zeroed by corr =
exp(NEG_INF - m_new) = 0.  The bounds come from the q block's positions on
the host.  The custom-VJP backward comes with the training slice.
"""

from __future__ import annotations

import torch

NEG_INF = -2.0e38


def valid_mask(qpos, kpos, window, chunk):
    """Causal + locality mask from position vectors ([Sq, Sk]): a query at
    i sees keys j <= i within ``window`` positions and in its ``chunk``."""
    i = qpos[:, None]
    j = kpos[None, :]
    m = j <= i
    m &= (i - j) < window
    m &= torch.div(i, chunk, rounding_mode="floor") == torch.div(
        j, chunk, rounding_mode="floor")
    return m


def _mask_tile(qpos, kpos, window, chunk, n_valid_k):
    return valid_mask(qpos, kpos, window, chunk) & (kpos < n_valid_k)[None, :]


def _softcap_fwd(u, cap):
    if cap is None:
        return u
    return cap * torch.tanh(u / cap)


def _tile_live(qlo: int, qhi: int, klo: int, khi: int, window: int,
               chunk: int, n_valid_k: int) -> bool:
    """Can any (query in [qlo, qhi], key in [klo, khi]) pair be unmasked?"""
    return (klo <= qhi and qlo - khi < window and klo < n_valid_k
            and qlo // chunk <= khi // chunk and klo // chunk <= qhi // chunk)


def flash_attention(q, k, v, qpos, locality, cap, block_q: int,
                    block_kv: int, n_valid_k: int):
    """q [B, Sq, H, hd], k / v [B, Sk, Hkv, hd] (Sq a multiple of
    ``block_q``, Sk of ``block_kv``), qpos [Sq] absolute positions,
    locality (window, chunk) -> [B, Sq, H, hd] in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    window, chunk = (int(v_) for v_ in locality)
    scale = hd ** -0.5
    dev = q.device
    nq, nk = Sq // block_q, Sk // block_kv

    # [B, Hkv, Sq * g, hd]: a q block is a contiguous run of rows
    qf = (q.to(torch.float32) * scale).reshape(B, Sq, Hkv, g, hd)
    qf = qf.permute(0, 2, 1, 3, 4).reshape(B, Hkv, Sq * g, hd)
    kh = k.permute(0, 2, 1, 3)                     # [B, Hkv, Sk, hd] views
    vh = v.permute(0, 2, 1, 3)
    qpos = torch.as_tensor(qpos, device=dev)
    qpos_host = qpos.to("cpu").reshape(nq, block_q)
    kpos_all = torch.arange(Sk, device=dev)
    out = torch.empty((B, Hkv, Sq * g, hd), dtype=torch.float32, device=dev)
    rows = block_q * g

    for bi in range(nq):
        qi = qf[:, :, bi * rows:(bi + 1) * rows]
        qp = qpos[bi * block_q:(bi + 1) * block_q]
        qlo, qhi = int(qpos_host[bi].min()), int(qpos_host[bi].max())
        acc = torch.zeros((B, Hkv, rows, hd), dtype=torch.float32, device=dev)
        m = torch.full((B, Hkv, rows), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hkv, rows), dtype=torch.float32, device=dev)
        for bj in range(nk):
            klo, khi = bj * block_kv, (bj + 1) * block_kv - 1
            if not _tile_live(qlo, qhi, klo, khi, window, chunk, n_valid_k):
                continue
            kt = kh[:, :, klo:khi + 1].to(
                torch.float32, memory_format=torch.contiguous_format)
            vt = vh[:, :, klo:khi + 1].to(
                torch.float32, memory_format=torch.contiguous_format)
            s = _softcap_fwd(torch.matmul(qi, kt.transpose(-1, -2)), cap)
            mask = _mask_tile(qp, kpos_all[klo:khi + 1], window, chunk,
                              n_valid_k)                       # [bq, bkv]
            s = s.reshape(B, Hkv, block_q, g, block_kv).masked_fill(
                ~mask[:, None, :], NEG_INF).reshape(B, Hkv, rows, block_kv)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(p, vt)
            m = m_new
        out[:, :, bi * rows:(bi + 1) * rows] = acc / torch.clamp(
            l[..., None], min=1e-30)

    out = out.reshape(B, Hkv, Sq, g, hd).permute(0, 2, 1, 3, 4)
    return out.reshape(B, Sq, H, hd).to(q.dtype)
