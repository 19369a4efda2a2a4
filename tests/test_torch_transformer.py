"""The LM transformer (``repro_torch.models.transformer``, ``layers``,
``launch.steps.make_lm_*``, ``convert.lm_params_from_reference``)
against the reference on identical inputs, on the CPU.

The reference's parameters (``init_params``) go through numpy into the
port, so both packages compute the same function at each of the five
``reduced_config()``s (float32).  Tolerances: logits within 1e-5 of the
logit scale (max |diff| / max |logit|, ``testing.scale_err``) with the
argmax equal; prefill caches within rtol 1e-5 of their scale.  torch and
XLA sum products in other orders, and XLA's CPU ``exp`` differs from
``torch.exp`` by an ulp (ROADMAP queue C), so bit-equality is not asked.
The dense configs also run in bf16 against the reference's bf16 run,
within 4 bf16 epsilons of the scale (``test_bf16_model_...``).

The llama4 configs route tokens through capacity-limited experts.  On
their inputs (parameters ``PRNGKey(1)``, tokens from numpy seed 0) tokens
are dropped, and the reference's fault C10 (a drop overwriting the last
expert's last slot) does not strike: ``test_inputs_drop_tokens_...``
holds both facts, so the forward parity below covers the drop path.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get as rget  # noqa: E402
from repro.launch import steps as R_S  # noqa: E402
from repro.models import layers as R_L  # noqa: E402
from repro.models import transformer as R_TF  # noqa: E402
from repro_torch import convert, testing  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.launch import (  # noqa: E402
    make_lm_decode,
    make_lm_decode_q8,
    make_lm_prefill,
)
from repro_torch.models import layers as T_L  # noqa: E402
from repro_torch.models import moe as T_M  # noqa: E402
from repro_torch.models import transformer as T_TF  # noqa: E402
from repro_torch.quantized import qkv_cache as T_QC  # noqa: E402

LM_ARCHS = ["gemma-2b", "gemma2-9b", "minicpm-2b", "llama4-scout-17b-16e",
            "llama4-maverick-400b-17b"]
TOL = 1e-5
B, S, PRE, MAX = 2, 24, 16, 24
STEPS = 4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class _Run:
    """The reference's and the port's forward, prefill and STEPS decode
    steps on one arch's reduced config, computed once a module."""

    def __init__(self, arch):
        self.rcfg = rget(arch).reduced_config()
        self.cfg = tget(arch).reduced_config()
        self.params = _np(R_TF.init_params(jax.random.PRNGKey(1), self.rcfg))
        self.tp = convert.lm_params_from_reference(self.params, device="cpu")
        self.toks = np.random.default_rng(0).integers(
            0, self.rcfg.vocab, (B, S)).astype(np.int32)
        self.moe_inputs = []
        real = T_M.moe_apply

        def record(params, x, cfg, act="silu"):
            self.moe_inputs.append((x.numpy().copy(),
                                    params["router"]["w"].numpy(), cfg))
            return real(params, x, cfg, act)

        T_M.moe_apply = record
        try:
            self._port()
        finally:
            T_M.moe_apply = real
        self._reference()

    def _port(self):
        t = torch.from_numpy(self.toks)
        self.logits, self.aux = T_TF.forward(self.tp, t, self.cfg)
        self.pre_logits, self.pre_kv = T_TF.prefill(self.tp, t[:, :PRE],
                                                    self.cfg)
        kc, vc = T_TF.make_cache(self.cfg, B, MAX, dtype=torch.float32,
                                 device="cpu")
        T_TF.write_prefix(kc, self.pre_kv[0])
        T_TF.write_prefix(vc, self.pre_kv[1])
        self.dec = []
        for s in range(STEPS):
            lg, (kc, vc) = T_TF.decode_step(self.tp, (kc, vc),
                                            t[:, PRE + s:PRE + s + 1],
                                            PRE + s, self.cfg)
            self.dec.append(lg.numpy().copy())
        self.caches = (kc, vc)

    def _reference(self):
        t = jnp.asarray(self.toks)
        self.r_logits, self.r_aux = _np(R_TF.forward(self.params, t,
                                                     self.rcfg))
        self.r_pre_logits, self.r_pre_kv = _np(R_TF.prefill(
            self.params, t[:, :PRE], self.rcfg))
        kc, vc = R_TF.make_cache(self.rcfg, B, MAX, dtype=jnp.float32)
        kc = R_TF.write_prefix(kc, jnp.asarray(self.r_pre_kv[0]))
        vc = R_TF.write_prefix(vc, jnp.asarray(self.r_pre_kv[1]))
        self.r_dec = []
        for s in range(STEPS):
            lg, (kc, vc) = R_TF.decode_step(self.params, (kc, vc),
                                            t[:, PRE + s:PRE + s + 1],
                                            jnp.int32(PRE + s), self.rcfg)
            self.r_dec.append(np.asarray(lg))
        self.r_caches = _np((kc, vc))


_RUNS = {}


@pytest.fixture(scope="module")
def run():
    def get(arch):
        if arch not in _RUNS:
            _RUNS[arch] = _Run(arch)
        return _RUNS[arch]

    yield get
    _RUNS.clear()


def _logits_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = testing.scale_err(got, want)
    assert err <= TOL, err
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


# --------------------------------------------------------------------------
# forward, prefill, decode against the reference


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_logits_equal_the_reference(arch, run):
    r = run(arch)
    assert r.logits.dtype == torch.float32
    _logits_close(r.logits, r.r_logits)
    pad = r.logits[..., r.cfg.vocab:]
    assert bool((pad == -2.0e38).all())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_aux_equals_the_reference(arch, run):
    r = run(arch)
    for name in ("lb_loss", "z_loss", "drop_frac"):
        np.testing.assert_allclose(float(r.aux[name]), float(r.r_aux[name]),
                                   rtol=TOL, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_logits_and_caches_equal_the_reference(arch, run):
    r = run(arch)
    _logits_close(r.pre_logits, r.r_pre_logits)
    for got, want in zip(r.pre_kv, r.r_pre_kv):
        assert tuple(got.shape) == want.shape == T_TF.cache_shape(
            r.cfg, B, PRE)
        assert testing.scale_err(got.numpy(), want) <= TOL


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("step", range(STEPS))
def test_decode_step_logits_equal_the_reference(arch, step, run):
    r = run(arch)
    assert r.dec[step].shape == (B, r.cfg.padded_vocab)
    _logits_close(r.dec[step], r.r_dec[step])


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_caches_equal_the_reference(arch, run):
    r = run(arch)
    for got, want in zip(r.caches, r.r_caches):
        assert testing.scale_err(got.numpy(), want) <= TOL
        # positions past the last step are still zero
        assert not got[:, :, :, PRE + STEPS:].any()


@pytest.mark.parametrize("arch", ["llama4-scout-17b-16e",
                                  "llama4-maverick-400b-17b"])
def test_inputs_drop_tokens_and_c10_does_not_strike(arch, run):
    r = run(arch)
    assert r.moe_inputs
    assert float(r.aux["drop_frac"]) > 0
    for x, w, cfg in r.moe_inputs:
        assert not testing.c10_strikes(x, w, cfg.n_experts,
                                       cfg.capacity_factor)


@pytest.mark.parametrize("arch", ["gemma-2b", "gemma2-9b", "minicpm-2b"])
def test_decode_follows_forward(arch, run):
    """Decode step s's logits are forward's at position PRE + s (the port
    against itself: the cache path and the blockwise path agree).  Dense
    archs only: an MoE layer's drops depend on how many tokens a call
    routes."""
    r = run(arch)
    for s in range(STEPS):
        err = testing.scale_err(r.dec[s], r.logits[:, PRE + s].numpy())
        assert err <= TOL, (s, err)


# --------------------------------------------------------------------------
# configs' shapes, caches, the step builders


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_tree_matches_the_reference(arch):
    cfg = tget(arch).reduced_config()
    want = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)),
                                  R_TF.abstract_params(
                                      rget(arch).reduced_config()))
    got = T_TF.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))

    assert shapes(got) == want
    assert shapes(T_TF.abstract_params(cfg)) == want
    # param_count leaves out the embedding's padded rows
    assert sum(t.numel() for t in _leaves(got)) == cfg.param_count() + (
        cfg.padded_vocab - cfg.vocab) * cfg.d_model


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_make_cache_and_write_prefix(arch):
    cfg = tget(arch).reduced_config()
    kc, vc = T_TF.make_cache(cfg, 3, 10, device="cpu")
    assert kc.shape == T_TF.cache_shape(cfg, 3, 10) == R_TF.cache_shape(
        rget(arch).reduced_config(), 3, 10)
    assert kc.dtype == torch.float32 and not kc.any() and not vc.any()
    prefix = torch.randn(*T_TF.cache_shape(cfg, 3, 4),
                         generator=torch.Generator().manual_seed(0))
    assert T_TF.write_prefix(kc, prefix, start=2) is kc
    assert torch.equal(kc[:, :, :, 2:6], prefix)
    assert not kc[:, :, :, :2].any() and not kc[:, :, :, 6:].any()
    with pytest.raises(ValueError, match="does not fit"):
        T_TF.write_prefix(kc, prefix, start=7)


@pytest.mark.parametrize("arch", ["gemma2-9b", "llama4-scout-17b-16e"])
def test_decode_at_a_full_cache_raises_where_the_reference_clamps(arch, run):
    """The reference's ``dynamic_update_slice_in_dim`` clamps a write at
    cur_len >= max_len onto the last slot; the port raises."""
    r = run(arch)
    kc, vc = T_TF.make_cache(r.cfg, B, 4, dtype=torch.float32, device="cpu")
    tok = torch.from_numpy(r.toks[:, :1])
    for bad in (4, 5, -1):
        with pytest.raises(ValueError, match="outside the cache"):
            T_TF.decode_step(r.tp, (kc, vc), tok, bad, r.cfg)
    assert not kc.any()
    T_TF.decode_step(r.tp, (kc, vc), tok, torch.tensor(3), r.cfg)
    assert kc[:, :, :, 3].any() and not kc[:, :, :, :3].any()


@pytest.mark.parametrize("arch", ["gemma-2b", "llama4-maverick-400b-17b"])
def test_step_builders_equal_the_reference(arch, run):
    r = run(arch)
    t = torch.from_numpy(r.toks[:, :PRE])
    lg, kv = make_lm_prefill(r.cfg)(r.tp, t)
    rlg, rkv = _np(R_S.make_lm_prefill(r.rcfg)(r.params,
                                               jnp.asarray(r.toks[:, :PRE])))
    _logits_close(lg, rlg)
    kc, vc = T_TF.make_cache(r.cfg, B, MAX, dtype=torch.float32, device="cpu")
    T_TF.write_prefix(kc, kv[0])
    T_TF.write_prefix(vc, kv[1])
    nxt = torch.from_numpy(r.toks[:, PRE:PRE + 1])
    got, _ = make_lm_decode(r.cfg)(r.tp, (kc, vc), nxt, PRE)
    _logits_close(got, r.r_dec[0])
    qc = T_QC.quantize_cache(kv[0], kv[1], MAX)
    q8, qc2 = make_lm_decode_q8(r.cfg)(r.tp, qc, nxt, PRE)
    assert qc2 is qc and q8.shape == got.shape


# --------------------------------------------------------------------------
# numerics of the bf16 path


def test_embed_scale_is_rounded_to_the_model_dtype():
    """gemma2-9b's sqrt(3584) = 59.866 is 59.75 in bf16, and the reference
    multiplies by the rounded value; a bf16 tensor times the float would
    round 59.866 * x instead."""
    cfg = dataclasses.replace(tget("gemma2-9b").reduced_config(),
                              d_model=3584, dtype="bfloat16")
    table = torch.full((4, 3584), 3.0, dtype=torch.bfloat16)
    x = T_TF._embed({"embed": {"table": table}}, torch.tensor([[1, 2]]), cfg)
    ref = np.asarray((jnp.full((1, 2, 3584), 3.0, jnp.bfloat16)
                      * jnp.asarray(3584 ** 0.5, jnp.bfloat16))
                     .astype(jnp.float32))
    assert x.dtype == torch.bfloat16
    assert np.array_equal(x.to(torch.float32).numpy(), ref)
    # 3 x 59.75 = 179.25 rounds to 179; 3 x 59.866 would round to 180
    assert float(ref[0, 0, 0]) == 179.0
    assert float((table[:1, :1] * 3584 ** 0.5)[0, 0]) == 180.0


@pytest.mark.parametrize("seed", range(3))
def test_bf16_dense_within_one_ulp_of_the_reference(seed):
    """A bf16 ``dense`` is one product in bf16 with float32 accumulation
    and one rounding, as ``jnp.dot(..., preferred_element_type=f32)
    .astype(bf16)``: within one bf16 ulp of it."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((6, 5, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 40)) / 10).astype(np.float32)
    xr, wr = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = np.asarray(R_L.dense({"w": wr}, xr).astype(jnp.float32))
    xt = convert.lm_params_from_reference({"x": np.asarray(xr)},
                                          device="cpu")["x"]
    wt = convert.lm_params_from_reference({"w": np.asarray(wr)},
                                          device="cpu")["w"]
    got = T_L.dense({"w": wt}, xt)
    assert got.dtype == torch.bfloat16
    got = got.to(torch.float32).numpy()
    # one bf16 ulp at each value: 2^(exponent - 7)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all()


BF16_EPS = 2.0 ** -7           # bf16's epsilon
BF16_TOL = 4 * BF16_EPS


def _bf16(arch, pkg):
    cfg = (rget if pkg == "ref" else tget)(arch).reduced_config()
    return dataclasses.replace(cfg, dtype="bfloat16")


@pytest.mark.parametrize("arch", ["gemma-2b", "gemma2-9b", "minicpm-2b"])
def test_bf16_model_within_a_few_bf16_eps_of_the_reference(arch):
    """The reduced config in bf16, on the reference's bf16 parameters:
    forward, prefill (logits and caches) and STEPS decode steps on a bf16
    cache within BF16_TOL (4 bf16 epsilons) of the scale.  The two
    packages round their activations at other points (XLA fuses
    ``jax.nn.gelu``'s bf16 ops; ``F.gelu`` rounds once), as the
    reference's own jitted and eager runs differ (0.0116 of the logit
    scale on gemma-2b's), so the argmax is not held at near-ties.  The
    llama4 configs' bf16 MoE layers are held in ``test_torch_moe.py``: a
    one-ulp change can flip a token's top-1 expert, so their whole models
    are not compared here."""
    rcfg, cfg = _bf16(arch, "ref"), _bf16(arch, "port")
    params = _np(R_TF.init_params(jax.random.PRNGKey(1), rcfg))
    tp = convert.lm_params_from_reference(params, device="cpu")
    assert tp["embed"]["table"].dtype == torch.bfloat16
    toks = np.random.default_rng(0).integers(0, rcfg.vocab,
                                             (B, S)).astype(np.int32)
    t, j = torch.from_numpy(toks), jnp.asarray(toks)

    def close(got, want):
        got = got.to(torch.float32).numpy()
        want = np.asarray(want).astype(np.float32)
        assert got.shape == want.shape
        err = testing.scale_err(got, want)
        assert err <= BF16_TOL, err

    close(T_TF.forward(tp, t, cfg)[0], R_TF.forward(params, j, rcfg)[0])
    lg, kv = T_TF.prefill(tp, t[:, :PRE], cfg)
    rlg, rkv = R_TF.prefill(params, j[:, :PRE], rcfg)
    close(lg, rlg)
    for g, w in zip(kv, rkv):
        assert g.dtype == torch.bfloat16
        close(g, w)
    kc, vc = T_TF.make_cache(cfg, B, MAX, device="cpu")
    T_TF.write_prefix(kc, kv[0])
    T_TF.write_prefix(vc, kv[1])
    rk, rv = R_TF.make_cache(rcfg, B, MAX)
    rk, rv = R_TF.write_prefix(rk, rkv[0]), R_TF.write_prefix(rv, rkv[1])
    for s in range(STEPS):
        tok = slice(PRE + s, PRE + s + 1)
        lg, (kc, vc) = T_TF.decode_step(tp, (kc, vc), t[:, tok], PRE + s, cfg)
        rlg, (rk, rv) = R_TF.decode_step(params, (rk, rv), j[:, tok],
                                         jnp.int32(PRE + s), rcfg)
        assert lg.dtype == torch.float32
        close(lg, rlg)
    close(kc, rk)
    close(vc, rv)


def test_float32_dense_is_unchanged_bit_for_bit():
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(7, 33, generator=g), torch.randn(33, 9, generator=g)
    assert torch.equal(T_L.dense({"w": w}, x), torch.matmul(x, w))
    assert torch.equal(T_L.dot_f32(x, w), torch.matmul(x, w))


def test_bf16_params_cross_from_the_reference_bit_for_bit():
    a = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (5, 7),
                                     jnp.bfloat16))
    t = convert.lm_params_from_reference({"a": {"b": a}}, device="cpu")
    got = t["a"]["b"]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.to(torch.float32).numpy(),
                          a.astype(np.float32))
