"""Blockwise attention and decode attention (``repro_torch.models.flash``,
``models.attention``) against the reference on identical inputs, on the
CPU, and against a naive masked softmax in the port.

Shapes are the reference's ``tests/test_flash.py`` cases (GQA / MQA / MHA,
sliding windows, chunks, soft-cap, ragged S that pads to the block sizes)
plus Sk > Sq (a q block at the end of the stream).  Tolerance: every
output within 1e-5 of the output scale (max |diff| / max |out|,
``testing.scale_err``); the sums run in other orders in torch and XLA.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import attention as R_A  # noqa: E402
from repro.models import flash as R_F  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.models import attention as T_A  # noqa: E402
from repro_torch.models import flash as T_F  # noqa: E402

TOL = 1e-5
G = T_A.GLOBAL

CASES = [
    # (B, S, H, Hkv, hd, window, chunk, cap, bq, bkv) — test_flash.py's
    (2, 32, 4, 2, 16, G, G, None, 8, 8),
    (1, 64, 4, 1, 8, 16, G, None, 16, 16),          # MQA + window
    (2, 48, 4, 4, 8, G, 16, None, 16, 8),           # MHA + chunked
    (1, 32, 8, 2, 16, G, G, 50.0, 8, 16),           # softcap
    (1, 40, 2, 2, 8, 8, G, 30.0, 16, 8),            # ragged S
    # the port's own: window and chunk together, ragged in both blocks,
    # one block wider than S, a window narrower than a block
    (2, 37, 6, 3, 8, 12, 16, 50.0, 16, 8),
    (1, 20, 4, 2, 8, G, G, None, 32, 32),
    (2, 50, 4, 1, 16, 5, G, None, 16, 16),
]


def _qkv(B, Sq, Sk, H, Hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def naive(q, k, v, qpos, window, chunk, cap):
    """The full [Sq, Sk] masked softmax in float64, in the port's terms."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.double().reshape(B, Sq, Hkv, g, hd) * hd ** -0.5
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, k.double())
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    mask = T_F.valid_mask(torch.as_tensor(qpos), torch.arange(Sk), window,
                          chunk)
    s = s.masked_fill(~mask[None, :, None, None, :], -2.0e38)
    o = torch.einsum("bqhgk,bkhd->bqhgd", torch.softmax(s, -1), v.double())
    return o.reshape(B, Sq, H, hd)


@pytest.mark.parametrize("B,S,H,Hkv,hd,window,chunk,cap,bq,bkv", CASES)
def test_blockwise_attention_equals_the_reference(B, S, H, Hkv, hd, window,
                                                  chunk, cap, bq, bkv):
    q, k, v = _qkv(B, S, S, H, Hkv, hd, S + H)
    want = np.asarray(R_A.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.arange(S),
        window=jnp.int32(window), chunk=jnp.int32(chunk), cap=cap,
        block_q=bq, block_kv=bkv))
    got = T_A.blockwise_attention(_t(q), _t(k), _t(v), torch.arange(S),
                                  window=window, chunk=chunk, cap=cap,
                                  block_q=bq, block_kv=bkv)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert testing.scale_err(got.numpy(), want) <= TOL


@pytest.mark.parametrize("B,S,H,Hkv,hd,window,chunk,cap,bq,bkv", CASES)
def test_blockwise_attention_equals_a_naive_softmax(B, S, H, Hkv, hd, window,
                                                    chunk, cap, bq, bkv):
    q, k, v = (_t(a) for a in _qkv(B, S, S, H, Hkv, hd, 7 * S + H))
    got = T_A.blockwise_attention(q, k, v, torch.arange(S), window=window,
                                  chunk=chunk, cap=cap, block_q=bq,
                                  block_kv=bkv)
    want = naive(q, k, v, torch.arange(S), window, chunk, cap)
    assert testing.scale_err(got.numpy(), want.numpy()) <= TOL


@pytest.mark.parametrize("Sq,Sk,bq,bkv,window", [(16, 48, 8, 16, G),
                                                 (12, 40, 8, 16, 20),
                                                 (5, 33, 4, 8, G)])
def test_kv_longer_than_q_equals_the_reference(Sq, Sk, bq, bkv, window):
    """A q block at the end of the stream (chunked prefill)."""
    B, H, hd = 1, 4, 8
    q, k, v = _qkv(B, Sq, Sk, H, H, hd, Sq + Sk)
    qpos = np.arange(Sk - Sq, Sk)
    want = np.asarray(R_A.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos),
        window=jnp.int32(window), chunk=jnp.int32(G), cap=None, block_q=bq,
        block_kv=bkv))
    got = T_A.blockwise_attention(_t(q), _t(k), _t(v), _t(qpos),
                                  window=window, block_q=bq, block_kv=bkv)
    assert testing.scale_err(got.numpy(), want) <= TOL
    ref_naive = naive(_t(q), _t(k), _t(v), _t(qpos), window, G, None)
    assert testing.scale_err(got.numpy(), ref_naive.numpy()) <= TOL


@pytest.mark.parametrize("cap", [None, 50.0])
def test_flash_attention_with_padded_keys_equals_the_reference(cap):
    """``n_valid_k`` masks the padded tail of k / v (and a whole padded
    tile is skipped)."""
    B, Sq, Sk, H, Hkv, hd, bq, bkv, n_valid = 2, 16, 32, 4, 2, 8, 8, 8, 19
    q, k, v = _qkv(B, Sq, Sk, H, Hkv, hd, 3)
    qpos = np.arange(Sk - Sq, Sk)
    loc = (G, G)
    want = np.asarray(R_F.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos),
        jnp.asarray(loc, jnp.int32), cap, bq, bkv, n_valid))
    got = T_F.flash_attention(_t(q), _t(k), _t(v), _t(qpos), loc, cap, bq,
                              bkv, n_valid)
    assert testing.scale_err(got.numpy(), want) <= TOL


def test_masked_tiles_are_skipped_exactly(monkeypatch):
    """Skipping tiles that every pair masks leaves the output bit-equal to
    visiting them all."""
    B, S, H, Hkv, hd = 1, 64, 4, 2, 8
    q, k, v = (_t(a) for a in _qkv(B, S, S, H, Hkv, hd, 11))
    for window, chunk in ((G, G), (12, G), (G, 16), (20, 32)):
        args = (q, k, v, torch.arange(S))
        kw = dict(window=window, chunk=chunk, cap=30.0, block_q=8,
                  block_kv=8)
        skipped = T_A.blockwise_attention(*args, **kw)
        with monkeypatch.context() as m:
            m.setattr(T_F, "_tile_live", lambda *a: True)
            visited = T_A.blockwise_attention(*args, **kw)
        assert torch.equal(skipped, visited), (window, chunk)


@pytest.mark.parametrize("qlo,qhi,klo,khi,window,chunk,n_valid,want", [
    (0, 7, 8, 15, G, G, 64, False),       # keys all after the queries
    (8, 15, 8, 15, G, G, 64, True),       # the diagonal
    (40, 47, 0, 7, 16, G, 64, False),     # keys all out of the window
    (20, 27, 8, 15, 16, G, 64, True),
    (16, 23, 8, 15, G, 16, 64, False),    # another chunk
    (16, 23, 16, 23, G, 16, 64, True),
    (30, 40, 32, 39, G, G, 32, False),    # all padded keys
])
def test_tile_live_bounds(qlo, qhi, klo, khi, window, chunk, n_valid, want):
    assert T_F._tile_live(qlo, qhi, klo, khi, window, chunk, n_valid) is want
    # the bound agrees with the mask itself
    m = T_F._mask_tile(torch.arange(qlo, qhi + 1), torch.arange(klo, khi + 1),
                       window, chunk, n_valid)
    assert bool(m.any()) is want


@pytest.mark.parametrize("window,chunk,cap", [(G, G, None), (6, G, 50.0),
                                              (G, 8, None), (4, 8, 30.0)])
@pytest.mark.parametrize("cur_len", [1, 9, 17, 24])
def test_decode_attention_equals_the_reference(window, chunk, cap, cur_len):
    B, S, H, Hkv, hd = 2, 24, 4, 2, 16
    q, k, v = _qkv(B, 1, S, H, Hkv, hd, cur_len)
    want = np.asarray(R_A.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(cur_len),
        window=jnp.int32(window), chunk=jnp.int32(chunk), cap=cap))
    got = T_A.decode_attention(_t(q), _t(k), _t(v), cur_len, window=window,
                               chunk=chunk, cap=cap)
    assert got.shape == (B, 1, H, hd)
    assert testing.scale_err(got.numpy(), want) <= TOL
    # and the naive softmax at the query's position
    full = naive(_t(q), _t(k), _t(v), torch.tensor([cur_len - 1]), window,
                 chunk, cap)
    assert testing.scale_err(got.numpy(), full.numpy()) <= TOL


def test_decode_attention_takes_a_length_per_row():
    B, S, H, Hkv, hd = 3, 16, 4, 4, 8
    q, k, v = _qkv(B, 1, S, H, Hkv, hd, 5)
    lens = np.array([3, 16, 9], np.int32)
    want = np.asarray(R_A.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens)))
    got = T_A.decode_attention(_t(q), _t(k), _t(v), _t(lens))
    assert testing.scale_err(got.numpy(), want) <= TOL


@pytest.mark.parametrize("window,chunk,cap", [(G, G, None), (8, G, 50.0),
                                              (G, 8, None)])
def test_attention_block_equals_the_reference(window, chunk, cap):
    d, H, Hkv, hd, B, S = 32, 4, 2, 8, 2, 20
    rp = jax.tree_util.tree_map(np.asarray, R_A.attn_init(
        jax.random.PRNGKey(0), d, H, Hkv, hd))
    tp = {k: {"w": _t(w["w"])} for k, w in rp.items()}
    x = np.random.default_rng(0).standard_normal((B, S, d)).astype(np.float32)
    ro, (rk, rv) = R_A.attention_block(
        rp, jnp.asarray(x), jnp.arange(S), H, Hkv, hd,
        window=jnp.int32(window), chunk=jnp.int32(chunk), cap=cap,
        block_q=8, block_kv=8)
    to, (tk, tv) = T_A.attention_block(tp, _t(x), torch.arange(S), H, Hkv,
                                       hd, window=window, chunk=chunk,
                                       cap=cap, block_q=8, block_kv=8)
    for got, want in ((to, ro), (tk, rk), (tv, rv)):
        assert testing.scale_err(got.numpy(), np.asarray(want)) <= TOL


def test_attn_init_shapes_and_constants():
    g = torch.Generator().manual_seed(0)
    p = T_A.attn_init(g, 32, 4, 2, 8, device="cpu", lead=(3,))
    assert {k: tuple(v["w"].shape) for k, v in p.items()} == {
        "wq": (3, 32, 32), "wk": (3, 32, 16), "wv": (3, 32, 16),
        "wo": (3, 32, 32)}
    assert T_A.GLOBAL == int(R_A.GLOBAL) and T_A.NEG_INF == R_A.NEG_INF
    assert T_F.NEG_INF == R_F.NEG_INF
