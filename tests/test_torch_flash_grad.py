"""The blockwise-attention backward (``repro_torch.models.flash
.flash_attention``, a ``torch.autograd.Function``) against ``jax.grad`` of
the reference's custom-VJP ``flash_attention`` on identical inputs, on the
CPU, in float32.

dQ, dK and dV are held within 1e-5 of their scale (max |reference value|)
for GQA and MQA, a sliding window shorter than the sequence, a chunk
shorter than it, padded keys (``n_valid_k < Sk``), the soft-cap on and
off, and under ``torch.utils.checkpoint`` (remat) or not.  Every query
row sees at least one key, as every row ``attention_block`` makes does
(the module docstring says why).  The forward saves only (q, k, v, out,
lse): no tensor of [Sq, Sk] scores is kept for the backward.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from repro.models import attention as R_A  # noqa: E402
from repro.models import flash as R_F  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.models import attention as T_A  # noqa: E402
from repro_torch.models import flash as T_F  # noqa: E402

TOL = 1e-5
G = 2 ** 30

# (name, B, Sq, Sk, H, Hkv, hd, window, chunk, cap, n_valid_k, bq, bkv)
CASES = [
    ("gqa_global", 2, 32, 32, 4, 2, 8, G, G, None, 32, 8, 8),
    ("mqa_softcap", 1, 32, 32, 4, 1, 16, G, G, 50.0, 32, 16, 8),
    ("window", 2, 48, 48, 4, 2, 8, 11, G, None, 48, 16, 16),
    ("window_softcap", 1, 48, 48, 2, 2, 8, 7, G, 30.0, 48, 8, 16),
    ("chunk", 2, 32, 32, 4, 2, 8, G, 12, None, 32, 8, 8),
    ("chunk_window_softcap", 1, 64, 64, 4, 2, 8, 9, 24, 50.0, 64, 16, 8),
    ("padded_keys", 2, 24, 32, 4, 2, 8, G, G, None, 28, 8, 8),
    ("padded_keys_softcap", 1, 24, 32, 4, 1, 8, 6, 16, 50.0, 27, 8, 16),
]


def _inputs(B, Sq, Sk, H, Hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    w = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    return q, k, v, w


def _reference(q, k, v, w, window, chunk, cap, n_valid_k, bq, bkv):
    loc = jnp.asarray([window, chunk], jnp.int32)
    qpos = jnp.arange(q.shape[1])

    def f(q, k, v):
        out = R_F.flash_attention(q, k, v, qpos, loc, cap, bq, bkv,
                                  n_valid_k)
        return jnp.sum(out * w)

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


def _port(q, k, v, w, window, chunk, cap, n_valid_k, bq, bkv, remat):
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))

    def f(tq, tk, tv):
        return T_F.flash_attention(tq, tk, tv, torch.arange(q.shape[1]),
                                   (window, chunk), cap, bq, bkv, n_valid_k)

    out = checkpoint(f, tq, tk, tv, use_reentrant=False) if remat else f(
        tq, tk, tv)
    (out * torch.from_numpy(w)).sum().backward()
    return [t.grad.numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_backward_equals_the_reference(case, remat):
    _name, B, Sq, Sk, H, Hkv, hd, window, chunk, cap, nv, bq, bkv = case
    q, k, v, w = _inputs(B, Sq, Sk, H, Hkv, hd)
    want = _reference(q, k, v, w, window, chunk, cap, nv, bq, bkv)
    got = _port(q, k, v, w, window, chunk, cap, nv, bq, bkv, remat)
    for name, g, r in zip("qkv", got, want):
        assert g.shape == r.shape
        err = testing.scale_err(g, r)
        assert err <= TOL, (name, err)
    # padded keys get no gradient
    assert not got[1][:, nv:].any() and not got[2][:, nv:].any()


@pytest.mark.parametrize("case", CASES[:4], ids=[c[0] for c in CASES[:4]])
def test_flash_forward_is_unchanged_by_the_function(case):
    """The forward through the autograd Function equals the reference's
    output (as the forward-only port did), with and without grad."""
    _name, B, Sq, Sk, H, Hkv, hd, window, chunk, cap, nv, bq, bkv = case
    q, k, v, _w = _inputs(B, Sq, Sk, H, Hkv, hd, seed=1)
    want = np.asarray(R_F.flash_attention(
        q, k, v, jnp.arange(Sq), jnp.asarray([window, chunk], jnp.int32),
        cap, bq, bkv, nv))
    for grad in (False, True):
        tq = torch.tensor(q, requires_grad=grad)
        out = T_F.flash_attention(tq, torch.tensor(k), torch.tensor(v),
                                  torch.arange(Sq), (window, chunk), cap, bq,
                                  bkv, nv)
        assert out.requires_grad == grad
        assert testing.scale_err(out.detach().numpy(), want) <= TOL


def test_blockwise_attention_backward_through_padding():
    """``blockwise_attention`` pads q and kv to the blocks (q rows at
    position 0, keys masked): its gradients equal ``jax.grad`` of the
    reference's, and the padding's gradient never reaches the caller."""
    B, S, H, Hkv, hd = 2, 21, 4, 2, 8
    q, k, v, w = _inputs(B, S, S, H, Hkv, hd, seed=2)
    kw = dict(window=7, chunk=G, cap=50.0, block_q=8, block_kv=8)

    def f(q, k, v):
        return jnp.sum(R_A.blockwise_attention(q, k, v, jnp.arange(S), **kw)
                       * w)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = T_A.blockwise_attention(tq, tk, tv, torch.arange(S), **kw)
    (out * torch.from_numpy(w)).sum().backward()
    for t, r in zip((tq, tk, tv), want):
        assert tuple(t.grad.shape) == r.shape
        assert testing.scale_err(t.grad.numpy(), np.asarray(r)) <= TOL


def test_forward_saves_no_score_matrix():
    """The tensors the forward keeps for the backward are q, k, v, out and
    the [B, Hkv, Sq * g] log-sum-exp: none holds Sq x Sk scores."""
    B, Sq, Sk, H, Hkv, hd = 1, 64, 64, 4, 2, 8
    q, k, v, _w = _inputs(B, Sq, Sk, H, Hkv, hd)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = T_F.flash_attention(tq, tk, tv, torch.arange(Sq), (G, G), 50.0,
                                  16, 16, Sk)
    assert sorted(saved) == sorted([(B, Sq, H, hd), (B, Sk, Hkv, hd),
                                    (B, Sk, Hkv, hd), (B, Sq, H, hd),
                                    (B, Hkv, Sq * (H // Hkv))])
    assert max(np.prod(s) for s in saved) < Sq * Sk
    out.sum().backward()
    assert tq.grad is not None and tk.grad is not None


def test_bf16_gradients_come_back_in_the_inputs_dtype():
    q, k, v, w = _inputs(1, 16, 16, 2, 1, 8)
    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16).requires_grad_()
                  for a in (q, k, v))
    out = T_F.flash_attention(tq, tk, tv, torch.arange(16), (G, G), None, 8,
                              8, 16)
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert tq.grad.dtype == tk.grad.dtype == tv.grad.dtype == torch.bfloat16
    assert all(bool(torch.isfinite(t.grad.float()).all())
               for t in (tq, tk, tv))
