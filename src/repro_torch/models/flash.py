"""Blockwise (flash-style) attention in plain PyTorch (port of
``repro.models.flash``: the forward ``_flash_fwd_impl`` and the custom
VJP ``_flash_vjp_fwd`` / ``_flash_vjp_bwd``).

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
the host.  The backward skips the same tiles: the reference's p = exp(s -
lse) and ds are 0 on each of their entries.  On the meta device (the dry
run, ``launch/dryrun.py``) a tensor holds no values, so the positions
stay on the host there (``positions``) and the live tiles are the card's.
Each query row must see at
least one key (``attention.attention_block`` always gives it itself): a
row that sees none is outside the contract, as the reference's forward
averages every key of the call there and the skip averages fewer.
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


def _softcap_grad(u, cap):
    """d softcap(u) / du given the RAW logits u (None: no cap)."""
    if cap is None:
        return None
    t = torch.tanh(u / cap)
    return 1.0 - t * t


def _tile_live(qlo: int, qhi: int, klo: int, khi: int, window: int,
               chunk: int, n_valid_k: int) -> bool:
    """Can any (query in [qlo, qhi], key in [klo, khi]) pair be unmasked?"""
    return (klo <= qhi and qlo - khi < window and klo < n_valid_k
            and qlo // chunk <= khi // chunk and klo // chunk <= qhi // chunk)


def positions(qpos, device) -> torch.Tensor:
    """``qpos`` on ``device``, or on the host where ``device`` is the meta
    device: the tile skip reads the positions' values."""
    device = torch.device(device)
    return torch.as_tensor(qpos, device="cpu" if device.type == "meta"
                           else device)


class _Layout:
    """One call's shapes and the [B, Hkv, Sq * g, hd] row layout (a q block
    is a contiguous run of block_q * g rows), with the host-side bounds of
    each q block's positions for the tile skip (``qpos`` on q's device, or
    on the host for a meta q)."""

    def __init__(self, q, k, qpos, locality, cap, block_q, block_kv,
                 n_valid_k):
        self.B, self.Sq, self.H, self.hd = q.shape
        self.Sk, self.Hkv = k.shape[1], k.shape[2]
        self.g = self.H // self.Hkv
        self.window, self.chunk = (int(v_) for v_ in locality)
        self.cap, self.bq, self.bkv = cap, block_q, block_kv
        self.n_valid_k = n_valid_k
        self.scale = self.hd ** -0.5
        self.nq, self.nk = self.Sq // block_q, self.Sk // block_kv
        self.rows = block_q * self.g
        self.qpos = qpos.to(q.device)
        host = qpos.to("cpu").reshape(self.nq, block_q)
        self.qb = [(int(host[i].min()), int(host[i].max()))
                   for i in range(self.nq)]
        self.kpos = torch.arange(self.Sk, device=q.device)

    def q_rows(self, x):
        """[B, Sq, H, hd] (any dtype) -> float32 [B, Hkv, Sq * g, hd]."""
        x = x.to(torch.float32).reshape(self.B, self.Sq, self.Hkv, self.g,
                                        self.hd)
        return x.permute(0, 2, 1, 3, 4).reshape(self.B, self.Hkv,
                                                self.Sq * self.g, self.hd)

    def q_heads(self, x, dtype):
        """The inverse of ``q_rows``, cast to ``dtype``."""
        x = x.reshape(self.B, self.Hkv, self.Sq, self.g, self.hd)
        return x.permute(0, 2, 1, 3, 4).reshape(
            self.B, self.Sq, self.H, self.hd).to(dtype)

    def kv_heads(self, x):
        """[B, Sk, Hkv, hd] -> a float32 [B, Hkv, Sk, hd] copy."""
        return x.permute(0, 2, 1, 3).to(
            torch.float32, memory_format=torch.contiguous_format)

    def live(self, bi: int, bj: int) -> bool:
        qlo, qhi = self.qb[bi]
        return _tile_live(qlo, qhi, bj * self.bkv, (bj + 1) * self.bkv - 1,
                          self.window, self.chunk, self.n_valid_k)

    def tile(self, qi, kt, bi: int, bj: int):
        """Tile (bi, bj)'s raw scores [B, Hkv, rows, bkv], its capped and
        masked scores, and its mask broadcast over those rows."""
        s_raw = torch.matmul(qi, kt.transpose(-1, -2))
        qp = self.qpos[bi * self.bq:(bi + 1) * self.bq]
        mask = _mask_tile(qp, self.kpos[bj * self.bkv:(bj + 1) * self.bkv],
                          self.window, self.chunk, self.n_valid_k)
        mask = mask[:, None, :].expand(self.bq, self.g, self.bkv).reshape(
            self.rows, self.bkv)
        s = _softcap_fwd(s_raw, self.cap).masked_fill(~mask, NEG_INF)
        return s_raw, s, mask

    def dscores(self, s_raw, s, mask, lse_i, do_i, dl_i, vt):
        """(p, ds) of one tile: p = exp(s - lse), ds = p * (dp - delta)
        times the soft-cap's derivative, zero where masked."""
        p = torch.exp(s - lse_i[..., None])
        dp = torch.matmul(do_i, vt.transpose(-1, -2))
        ds = p * (dp - dl_i[..., None])
        grad = _softcap_grad(s_raw, self.cap)
        if grad is not None:
            ds = ds * grad
        return p, ds.masked_fill(~mask, 0.0)


def _forward(L: _Layout, q, k, v):
    """(out [B, Sq, H, hd] in q's dtype, lse [B, Hkv, Sq * g] float32)."""
    qf = L.q_rows(q) * L.scale
    kh = k.permute(0, 2, 1, 3)                     # [B, Hkv, Sk, hd] views
    vh = v.permute(0, 2, 1, 3)
    out = torch.empty_like(qf)
    lse = torch.empty(qf.shape[:-1], dtype=torch.float32, device=q.device)
    rows = L.rows
    for bi in range(L.nq):
        qi = qf[:, :, bi * rows:(bi + 1) * rows]
        acc = torch.zeros((L.B, L.Hkv, rows, L.hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((L.B, L.Hkv, rows), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((L.B, L.Hkv, rows), dtype=torch.float32,
                        device=q.device)
        for bj in range(L.nk):
            if not L.live(bi, bj):
                continue
            kv = slice(bj * L.bkv, (bj + 1) * L.bkv)
            kt = kh[:, :, kv].to(torch.float32,
                                 memory_format=torch.contiguous_format)
            vt = vh[:, :, kv].to(torch.float32,
                                 memory_format=torch.contiguous_format)
            _s_raw, s, _mask = L.tile(qi, kt, bi, bj)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(p, vt)
            m = m_new
        lc = torch.clamp(l, min=1e-30)
        out[:, :, bi * rows:(bi + 1) * rows] = acc / lc[..., None]
        lse[:, :, bi * rows:(bi + 1) * rows] = m + torch.log(lc)
    return L.q_heads(out, q.dtype), lse


def _backward(L: _Layout, q, k, v, out, lse, dout):
    """(dq, dk, dv) in q's, k's and v's dtypes: the reference's two passes
    over the live tiles."""
    qf = L.q_rows(q) * L.scale
    kh, vh = L.kv_heads(k), L.kv_heads(v)
    do = L.q_rows(dout)
    delta = torch.sum(do * L.q_rows(out), dim=-1)           # [B, Hkv, rows]
    rows = L.rows

    def q_block(bi):
        r = slice(bi * rows, (bi + 1) * rows)
        return qf[:, :, r], do[:, :, r], lse[:, :, r], delta[:, :, r]

    # pass 1: dQ (q blocks outer, kv blocks inner)
    dq = torch.zeros_like(qf)
    for bi in range(L.nq):
        qi, do_i, lse_i, dl_i = q_block(bi)
        acc = dq[:, :, bi * rows:(bi + 1) * rows]
        for bj in range(L.nk):
            if not L.live(bi, bj):
                continue
            kv = slice(bj * L.bkv, (bj + 1) * L.bkv)
            kt, vt = kh[:, :, kv], vh[:, :, kv]
            s_raw, s, mask = L.tile(qi, kt, bi, bj)
            _p, ds = L.dscores(s_raw, s, mask, lse_i, do_i, dl_i, vt)
            acc += torch.matmul(ds, kt)
    dq = dq * L.scale

    # pass 2: dK, dV (kv blocks outer, q blocks inner); qf carries the
    # 1/sqrt(hd) factor, so dK needs no rescale
    dk = torch.zeros_like(kh)
    dv = torch.zeros_like(vh)
    for bj in range(L.nk):
        kv = slice(bj * L.bkv, (bj + 1) * L.bkv)
        kt, vt = kh[:, :, kv], vh[:, :, kv]
        dk_acc, dv_acc = dk[:, :, kv], dv[:, :, kv]
        for bi in range(L.nq):
            if not L.live(bi, bj):
                continue
            qi, do_i, lse_i, dl_i = q_block(bi)
            s_raw, s, mask = L.tile(qi, kt, bi, bj)
            p, ds = L.dscores(s_raw, s, mask, lse_i, do_i, dl_i, vt)
            dv_acc += torch.matmul(p.transpose(-1, -2), do_i)
            dk_acc += torch.matmul(ds.transpose(-1, -2), qi)
    return (L.q_heads(dq, q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """The forward untraced, its residuals (q, k, v, out, lse, qpos); the
    backward blockwise."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, locality, cap, block_q, block_kv,
                n_valid_k):
        L = _Layout(q, k, qpos, locality, cap, block_q, block_kv, n_valid_k)
        out, lse = _forward(L, q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.layout = L
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(ctx.layout, q, k, v, out, lse, dout)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, qpos, locality, cap, block_q: int,
                    block_kv: int, n_valid_k: int):
    """q [B, Sq, H, hd], k / v [B, Sk, Hkv, hd] (Sq a multiple of
    ``block_q``, Sk of ``block_kv``), qpos [Sq] absolute positions,
    locality (window, chunk) -> [B, Sq, H, hd] in q's dtype,
    differentiable in q, k and v."""
    qpos = positions(qpos, q.device)
    return _FlashAttention.apply(q, k, v, qpos, tuple(locality), cap,
                                 block_q, block_kv, n_valid_k)
