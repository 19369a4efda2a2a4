"""The int8 KV cache (``repro_torch.quantized.qkv_cache``) against the
reference on identical inputs, on the CPU, and the reference's
``tests/test_quantized_integrations.py`` LM tests on the port.

``quantize_cache`` of the reference's own prefill caches gives bit-equal
codes and scales (abs-max per layer, kv-head and dim; round half to even;
clip to [-128, 127]).  ``decode_step_q8`` starts from the reference's
quantized cache at each of the five ``reduced_config()``s (parameters
``PRNGKey(1)``, tokens from numpy seed 0, as ``test_torch_transformer``),
and its logits stay within 1e-5 of the logit scale with the argmax equal.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get as rget  # noqa: E402
from repro.models import transformer as R_TF  # noqa: E402
from repro.quantized import qkv_cache as R_QC  # noqa: E402
from repro_torch import convert, testing  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.data import lm_data  # noqa: E402
from repro_torch.models import transformer as T_TF  # noqa: E402
from repro_torch.quantized import qkv_cache as T_QC  # noqa: E402

LM_ARCHS = ["gemma-2b", "gemma2-9b", "minicpm-2b", "llama4-scout-17b-16e",
            "llama4-maverick-400b-17b"]
TOL = 1e-5
B, PRE, MAX, STEPS = 2, 16, 24, 4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_cache(rq):
    return T_QC.QuantizedCache(**{f.name: torch.from_numpy(
        np.array(getattr(rq, f.name))) for f in dataclasses.fields(rq)})


class _Run:
    """Both packages' q8 decode from the reference's quantized prefill."""

    def __init__(self, arch):
        self.rcfg = rget(arch).reduced_config()
        self.cfg = tget(arch).reduced_config()
        self.params = _np(R_TF.init_params(jax.random.PRNGKey(1), self.rcfg))
        self.tp = convert.lm_params_from_reference(self.params, device="cpu")
        self.toks = np.random.default_rng(0).integers(
            0, self.rcfg.vocab, (B, MAX)).astype(np.int32)
        t = jnp.asarray(self.toks)
        _, self.r_kv = _np(R_TF.prefill(self.params, t[:, :PRE], self.rcfg))
        rq = R_QC.quantize_cache(jnp.asarray(self.r_kv[0]),
                                 jnp.asarray(self.r_kv[1]), MAX)
        self.r_q = _np(rq)
        tq = _port_cache(self.r_q)
        self.r_dec, self.dec = [], []
        for s in range(STEPS):
            tok = self.toks[:, PRE + s:PRE + s + 1]
            lg, rq = R_QC.decode_step_q8(self.params, rq, jnp.asarray(tok),
                                         jnp.int32(PRE + s), self.rcfg)
            self.r_dec.append(np.asarray(lg))
            lg, tq = T_QC.decode_step_q8(self.tp, tq, torch.from_numpy(tok),
                                         PRE + s, self.cfg)
            self.dec.append(lg.numpy().copy())
        self.r_final, self.final = _np(rq), tq


_RUNS = {}


@pytest.fixture(scope="module")
def run():
    def get(arch):
        if arch not in _RUNS:
            _RUNS[arch] = _Run(arch)
        return _RUNS[arch]

    yield get
    _RUNS.clear()


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_quantize_cache_is_bit_equal_on_the_reference_prefill(arch, run):
    r = run(arch)
    got = T_QC.quantize_cache(torch.from_numpy(np.array(r.r_kv[0])),
                              torch.from_numpy(np.array(r.r_kv[1])), MAX)
    for f in ("k_codes", "v_codes", "k_scale", "v_scale"):
        g, w = getattr(got, f).numpy(), getattr(r.r_q, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert np.array_equal(g, w), f
    assert got.max_len == MAX
    assert not got.k_codes[:, :, :, PRE:].any()


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("step", range(STEPS))
def test_decode_step_q8_equals_the_reference(arch, step, run):
    r = run(arch)
    got, want = r.dec[step], r.r_dec[step]
    assert got.shape == want.shape == (B, r.cfg.padded_vocab)
    assert testing.scale_err(got, want) <= TOL
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_step_q8_writes_the_reference_codes_in_place(arch, run):
    r = run(arch)
    for f in ("k_codes", "v_codes"):
        g, w = getattr(r.final, f).numpy(), getattr(r.r_final, f)
        assert np.array_equal(g, w), f
        assert g[:, :, :, PRE:PRE + STEPS].any()
        assert not g[:, :, :, PRE + STEPS:].any()


@pytest.mark.parametrize("arch", ["gemma2-9b", "llama4-maverick-400b-17b"])
def test_decode_step_q8_at_a_full_cache_raises(arch, run):
    r = run(arch)
    qc = T_QC.make_quantized_cache(r.cfg, B, 4, device="cpu")
    tok = torch.from_numpy(r.toks[:, :1])
    with pytest.raises(ValueError, match="outside the cache"):
        T_QC.decode_step_q8(r.tp, qc, tok, 4, r.cfg)
    assert not qc.k_codes.any()


@pytest.mark.parametrize("window,chunk,cap,cur_len", [
    (T_QC.A.GLOBAL, T_QC.A.GLOBAL, None, 20), (6, T_QC.A.GLOBAL, 50.0, 13),
    (T_QC.A.GLOBAL, 8, None, 17), (4, 8, 30.0, 1)])
def test_quantized_decode_attention_equals_the_reference(window, chunk, cap,
                                                         cur_len):
    rng = np.random.default_rng(cur_len)
    Bq, S, H, Hkv, hd = 2, 20, 4, 2, 16
    q = rng.standard_normal((Bq, 1, H, hd)).astype(np.float32)
    kc = rng.integers(-128, 128, (Bq, S, Hkv, hd)).astype(np.int8)
    vc = rng.integers(-128, 128, (Bq, S, Hkv, hd)).astype(np.int8)
    ks = rng.uniform(0.001, 0.05, (Hkv, hd)).astype(np.float32)
    vs = rng.uniform(0.001, 0.05, (Hkv, hd)).astype(np.float32)
    want = np.asarray(R_QC.quantized_decode_attention(
        *(jnp.asarray(a) for a in (q, kc, vc, ks, vs)), jnp.int32(cur_len),
        window=jnp.int32(window), chunk=jnp.int32(chunk), cap=cap))
    got = T_QC.quantized_decode_attention(
        *(torch.from_numpy(a) for a in (q, kc, vc, ks, vs)), cur_len,
        window=window, chunk=chunk, cap=cap)
    assert testing.scale_err(got.numpy(), want) <= TOL


def test_codes_round_half_to_even_and_clip():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 300.0, -300.0, 127.49])
    got = T_QC._codes(x, torch.tensor(1.0))
    want = np.asarray(jnp.clip(jnp.round(jnp.asarray(x.numpy())), -128, 127)
                      .astype(jnp.int8))
    assert got.tolist() == want.tolist() == [0, 2, 2, 0, -2, 127, -128, 127]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_make_quantized_cache_matches_the_reference(arch):
    rq = R_QC.make_quantized_cache(rget(arch).reduced_config(), 3, 10)
    tq = T_QC.make_quantized_cache(tget(arch).reduced_config(), 3, 10,
                                   device="cpu")
    for f in dataclasses.fields(rq):
        g, w = getattr(tq, f.name).numpy(), np.asarray(getattr(rq, f.name))
        assert g.dtype == w.dtype and np.array_equal(g, w), f.name
    assert tq.max_len == rq.max_len == 10


# --------------------------------------------------------------------------
# the reference's LM integration tests, on the port


def _tiny_cfg():
    return T_TF.LMConfig(
        name="t", n_layers=4, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=256, dtype="float32", block_q=8, block_kv=8,
        attn_softcap=50.0, final_softcap=30.0,
    )


def _tiny(seed=0):
    cfg = _tiny_cfg()
    params = T_TF.init_params(torch.Generator().manual_seed(seed), cfg,
                              device="cpu")
    return cfg, params


def test_q8_cache_preserves_next_token_ranking():
    cfg, params = _tiny()
    toks = lm_data.lm_batch(torch.Generator().manual_seed(1), 4, 24,
                            cfg.vocab, device="cpu")["tokens"]
    _lg, caches = T_TF.prefill(params, toks[:, :16], cfg)

    kc, vc = T_TF.make_cache(cfg, 4, 24, dtype=torch.float32, device="cpu")
    T_TF.write_prefix(kc, caches[0])
    T_TF.write_prefix(vc, caches[1])
    lg_fp, _ = T_TF.decode_step(params, (kc, vc), toks[:, 16:17], 16, cfg)

    qcache = T_QC.quantize_cache(caches[0], caches[1], max_len=24)
    lg_q8, _ = T_QC.decode_step_q8(params, qcache, toks[:, 16:17], 16, cfg)

    top_fp = np.argsort(-lg_fp.numpy(), -1)[:, :5]
    top_q8 = np.argsort(-lg_q8.numpy(), -1)[:, :5]
    agree = np.mean([len(set(a) & set(b)) / 5 for a, b in zip(top_fp, top_q8)])
    assert agree >= 0.8, agree
    assert (top_fp[:, 0] == top_q8[:, 0]).mean() >= 0.75


def test_q8_cache_memory_halves_vs_bf16():
    cfg = _tiny_cfg()
    assert T_QC.cache_memory_bytes(cfg, 8, 1024, quantized=True) < (
        0.6 * T_QC.cache_memory_bytes(cfg, 8, 1024, quantized=False))


def test_q8_cache_multi_step_decode_stays_finite():
    cfg, params = _tiny()
    toks = lm_data.lm_batch(torch.Generator().manual_seed(1), 2, 32,
                            cfg.vocab, device="cpu")["tokens"]
    _lg, caches = T_TF.prefill(params, toks[:, :8], cfg)
    qcache = T_QC.quantize_cache(caches[0], caches[1], max_len=32)
    tok = toks[:, 8:9]
    for step in range(8):
        lg, qcache = T_QC.decode_step_q8(params, qcache, tok, 8 + step, cfg)
        assert torch.isfinite(lg[:, : cfg.vocab]).all()
        tok = torch.argmax(lg, -1)[:, None]
