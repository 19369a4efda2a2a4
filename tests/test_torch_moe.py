"""The top-1 MoE FFN (``repro_torch.models.moe``) against the reference and
against a per-token oracle (``testing.moe_naive``), on the CPU.

The port follows the reference's docstring ("dropped past capacity"): a
dropped token writes nothing.  The reference writes each drop's sentinel
into slot [E-1, C-1] (``moe.py:100-104``), which overwrites the token that
legitimately holds it whenever a later token is dropped (C10, ROADMAP
queue C): that token's routed output becomes 0.  So the port is held to
the reference within rtol 1e-5 on every token the reference does not
zero, and to the oracle on all of them; ``..._c10`` pins the fault.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get as rget  # noqa: E402
from repro.models import moe as R_M  # noqa: E402
from repro_torch import convert, testing  # noqa: E402
from repro_torch.models import moe as T_M  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
ARCHS = ["llama4-scout-17b-16e", "llama4-maverick-400b-17b"]


def _case(arch, seed, B, S, cf=None, shared=None):
    cfg = rget(arch).reduced_config()
    mc = cfg.moe
    if cf is not None:
        mc = dataclasses.replace(mc, capacity_factor=cf)
    if shared is not None:
        mc = dataclasses.replace(mc, shared_expert=shared)
    params = jax.tree_util.tree_map(np.asarray, R_M.moe_init(
        jax.random.PRNGKey(seed), cfg.d_model, mc))
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return mc, params, x


def _port_cfg(mc):
    return T_M.MoEConfig(**dataclasses.asdict(mc))


def _zeroed(x, params, mc):
    """The tokens whose routed output the reference zeroes (C10)."""
    assign, pos, keep, C = testing.moe_routing(
        x, params["router"]["w"], mc.n_experts, mc.capacity_factor)
    if not testing.c10_strikes(x, params["router"]["w"], mc.n_experts,
                               mc.capacity_factor):
        return np.zeros(len(assign), bool)
    return keep & (assign == mc.n_experts - 1) & (pos == C - 1)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed,B,S,cf", [(0, 2, 8, None), (1, 2, 24, None),
                                         (2, 4, 16, None), (3, 1, 40, 1.0),
                                         (4, 3, 30, 0.5), (5, 1, 3, None)])
def test_moe_apply_equals_the_reference_on_tokens_it_keeps(arch, seed, B, S,
                                                           cf):
    mc, params, x = _case(arch, seed, B, S, cf)
    want, raux = R_M.moe_apply(params, jnp.asarray(x), mc, act="silu")
    want = np.asarray(want).reshape(B * S, -1)
    tp = convert.lm_params_from_reference(params, device="cpu")
    got, aux = T_M.moe_apply(tp, torch.from_numpy(x), _port_cfg(mc),
                             act="silu")
    got = got.numpy().reshape(B * S, -1)
    ok = ~_zeroed(x, params, mc)
    np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL, atol=ATOL)
    for name in ("lb_loss", "z_loss", "drop_frac"):
        np.testing.assert_allclose(float(aux[name]), float(raux[name]),
                                   rtol=RTOL, atol=1e-7, err_msg=name)
    oracle = testing.moe_naive(params, x, mc.n_experts, mc.capacity_factor)
    np.testing.assert_allclose(got, oracle.reshape(B * S, -1), rtol=RTOL,
                               atol=ATOL)


BF16_EPS = 2.0 ** -7           # bf16's epsilon


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed,B,S,cf", [(0, 2, 8, None), (1, 2, 24, None),
                                         (3, 1, 40, 1.0), (4, 3, 30, 0.5)])
def test_bf16_moe_apply_within_two_bf16_eps_of_the_reference(arch, seed, B,
                                                             S, cf):
    """bf16 parameters and input: the experts' products are bf16 with a
    float32 output (``layers.dot_f32``) and the activations round where
    the reference's do, up to ``jax.nn.silu``'s own bf16 steps: within 2
    bf16 epsilons of the output scale on every token the reference does
    not zero (C10), with the aux equal."""
    cfg = rget(arch).reduced_config()
    mc = cfg.moe if cf is None else dataclasses.replace(
        cfg.moe, capacity_factor=cf)
    params = jax.tree_util.tree_map(np.asarray, R_M.moe_init(
        jax.random.PRNGKey(seed), cfg.d_model, mc, jnp.bfloat16))
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)), jnp.bfloat16)
    want, raux = jax.jit(lambda p, x: R_M.moe_apply(p, x, mc, act="silu"))(
        params, x)
    want = np.asarray(want).astype(np.float32).reshape(B * S, -1)
    tp = convert.lm_params_from_reference(params, device="cpu")
    xt = convert.lm_params_from_reference({"x": np.asarray(x)},
                                          device="cpu")["x"]
    assert tp["gate_w"].dtype == xt.dtype == torch.bfloat16
    got, aux = T_M.moe_apply(tp, xt, _port_cfg(mc), act="silu")
    assert got.dtype == torch.bfloat16
    got = got.to(torch.float32).numpy().reshape(B * S, -1)
    ok = ~_zeroed(np.asarray(x).astype(np.float32), params, mc)
    assert testing.scale_err(got[ok], want[ok]) <= 2 * BF16_EPS
    for name in ("lb_loss", "z_loss", "drop_frac"):
        np.testing.assert_allclose(float(aux[name]), float(raux[name]),
                                   rtol=RTOL, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("shared", [True, False])
def test_moe_apply_equals_the_per_token_oracle(act, shared):
    mc, params, x = _case(ARCHS[0], 7, 2, 20, cf=0.75, shared=shared)
    tp = convert.lm_params_from_reference(params, device="cpu")
    got, aux = T_M.moe_apply(tp, torch.from_numpy(x), _port_cfg(mc), act=act)
    assert float(aux["drop_frac"]) > 0
    oracle = testing.moe_naive(params, x, mc.n_experts, mc.capacity_factor,
                               act=act)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=RTOL, atol=ATOL)
    want, _ = R_M.moe_apply(params, jnp.asarray(x), mc, act=act)
    ok = ~_zeroed(x, params, mc)
    np.testing.assert_allclose(got.numpy().reshape(40, -1)[ok],
                               np.asarray(want).reshape(40, -1)[ok],
                               rtol=RTOL, atol=ATOL)


def _c10_probe():
    """E=4, capacity_factor 1.0, T=40 (so C=10): tokens 0-9 go to expert
    3, tokens 10-39 to expert 0, so 20 of them are dropped."""
    d, E, T = 8, 4, 40
    mc = R_M.MoEConfig(n_experts=E, top_k=1, d_ff=16, capacity_factor=1.0,
                       shared_expert=False)
    params = jax.tree_util.tree_map(np.asarray, R_M.moe_init(
        jax.random.PRNGKey(0), d, mc))
    router = np.zeros((d, E), np.float32)
    router[0, 3] = router[1, 0] = 5.0
    params["router"]["w"] = router
    rng = np.random.default_rng(0)
    x = 0.1 * rng.standard_normal((1, T, d)).astype(np.float32)
    x[0, :10, 0] += 3.0
    x[0, 10:, 1] += 3.0
    return mc, params, x


def test_moe_apply_keeps_the_token_the_reference_zeroes_c10():
    mc, params, x = _c10_probe()
    assign, pos, keep, C = testing.moe_routing(x, params["router"]["w"], 4,
                                               1.0)
    assert C == 10 and (assign[:10] == 3).all() and (assign[10:] == 0).all()
    assert keep.sum() == 20 and keep[9] and pos[9] == C - 1
    assert testing.c10_strikes(x, params["router"]["w"], 4, 1.0)

    want, raux = R_M.moe_apply(params, jnp.asarray(x), mc, act="silu")
    want = np.asarray(want)[0]
    # the reference: token 9 legitimately fills slot [3, 9], and every
    # later drop overwrites it with the sentinel: its output is 0 though
    # drop_frac counts only the 20 drops
    assert not want[9].any()
    assert np.abs(want[:9]).min(axis=1).max() > 0
    assert float(raux["drop_frac"]) == 0.5
    assert (np.abs(want).sum(axis=1) > 0).sum() == 19

    tp = convert.lm_params_from_reference(params, device="cpu")
    got, aux = T_M.moe_apply(tp, torch.from_numpy(x), _port_cfg(mc),
                             act="silu")
    got = got.numpy()[0]
    oracle = testing.moe_naive(params, x, 4, 1.0)[0]
    assert np.abs(got[9]).max() > 0
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)
    assert (np.abs(got).sum(axis=1) > 0).sum() == 20
    np.testing.assert_allclose(got[:9], want[:9], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[10:], want[10:], rtol=RTOL, atol=ATOL)
    assert float(aux["drop_frac"]) == 0.5


@pytest.mark.parametrize("T,E,cf", [(1, 4, 1.25), (40, 4, 1.0), (48, 4, 1.25),
                                    (8320, 16, 1.25), (18432, 128, 1.25),
                                    (33, 8, 0.5), (7, 3, 2.0)])
def test_capacity_equals_the_reference_formula(T, E, cf):
    want = max(8, int(-(-T * cf // E)))
    assert T_M.capacity(T_M.MoEConfig(n_experts=E, capacity_factor=cf),
                        T) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_init_matches_the_reference_tree(arch):
    cfg = rget(arch).reduced_config()
    want = jax.tree_util.tree_map(
        lambda a: (a.shape, str(a.dtype)),
        R_M.moe_init(jax.random.PRNGKey(0), cfg.d_model, cfg.moe))
    got = T_M.moe_init(torch.Generator().manual_seed(0), cfg.d_model,
                       _port_cfg(cfg.moe), device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))

    assert shapes(got) == want
    assert dataclasses.asdict(_port_cfg(cfg.moe)) == dataclasses.asdict(
        cfg.moe)
