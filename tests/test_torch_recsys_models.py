"""CTR serving for the four recsys architectures (``repro_torch.models
.layers``, ``models.recsys.interactions``, ``models.recsys.models``,
``data.recsys_data``, ``configs.{autoint,dcn_v2,dien,dlrm_mlperf,lpq_ann}``,
``launch.steps.make_recsys_serve``, ``launch.mesh``) against the reference
on identical inputs, on the CPU.

The reference's parameters (``init_params``) and batches (``ctr_batch``)
go through numpy into the port (``convert.recsys_params_from_reference``),
so both packages compute the same function.  Tolerances: every float
result within rtol 1e-5 of the reference's (``RTOL``), with an absolute
floor of 1e-6 (``ATOL``) for values near 0 (logits, activations); torch
and XLA sum products in different orders, so bit-equality is not asked.
Integer results (the power-law id map on shared uniforms, dot-interaction
index order, shapes, sharding specs) are exact.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import autoint as R_AI  # noqa: E402
from repro.configs import dcn_v2 as R_DCN  # noqa: E402
from repro.configs import dien as R_DIEN  # noqa: E402
from repro.configs import dlrm_mlperf as R_DLRM  # noqa: E402
from repro.configs import lpq_ann as R_ANN  # noqa: E402
from repro.data import recsys_data as R_D  # noqa: E402
from repro.dist import sharding as RSH  # noqa: E402
from repro.launch import steps as R_S  # noqa: E402
from repro.models import layers as R_L  # noqa: E402
from repro.models.recsys import interactions as R_I  # noqa: E402
from repro.models.recsys import models as R_M  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import autoint as T_AI  # noqa: E402
from repro_torch.configs import dcn_v2 as T_DCN  # noqa: E402
from repro_torch.configs import dien as T_DIEN  # noqa: E402
from repro_torch.configs import dlrm_mlperf as T_DLRM  # noqa: E402
from repro_torch.configs import lpq_ann as T_ANN  # noqa: E402
from repro_torch.data import recsys_data as T_D  # noqa: E402
from repro_torch.dist import sharding as TSH  # noqa: E402
from repro_torch.launch import make_recsys_serve  # noqa: E402
from repro_torch.launch import mesh as T_MESH  # noqa: E402
from repro_torch.models import layers as T_L  # noqa: E402
from repro_torch.models.recsys import interactions as T_I  # noqa: E402
from repro_torch.models.recsys import models as T_M  # noqa: E402
from repro_torch.runtime import profile as rtprofile  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
CONFIGS = {"autoint": (R_AI, T_AI), "dcn-v2": (R_DCN, T_DCN),
           "dien": (R_DIEN, T_DIEN), "dlrm-mlperf": (R_DLRM, T_DLRM)}
ARCHS = list(CONFIGS)
B = 16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


def _ref_params(arch, seed=0):
    cfg = CONFIGS[arch][0].reduced_config()
    return cfg, _np(R_M.init_params(jax.random.PRNGKey(seed), cfg))


def _ref_batch(cfg, seed=1, batch=B):
    return _np(R_D.ctr_batch(jax.random.PRNGKey(seed), batch, cfg.n_dense,
                             cfg.vocab_sizes, cfg.seq_len))


def _port_cfg(arch):
    return CONFIGS[arch][1].reduced_config()


# --------------------------------------------------------------------------
# configs


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("which", ["config", "reduced_config"])
def test_configs_equal_the_reference_field_for_field(arch, which):
    ref, port = CONFIGS[arch]
    assert (dataclasses.asdict(getattr(port, which)())
            == dataclasses.asdict(getattr(ref, which)()))
    assert (port.ARCH_ID, port.FAMILY, port.SKIP) == (ref.ARCH_ID, ref.FAMILY,
                                                      ref.SKIP)
    assert port.SHAPES == ref.SHAPES


@pytest.mark.parametrize("which", ["config", "reduced_config"])
def test_lpq_ann_config_equals_the_reference(which):
    want, got = getattr(R_ANN, which)(), getattr(T_ANN, which)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (T_ANN.ARCH_ID, T_ANN.FAMILY, T_ANN.SKIP, T_ANN.SHAPES) == (
        R_ANN.ARCH_ID, R_ANN.FAMILY, R_ANN.SKIP, R_ANN.SHAPES)
    ws, gs = want.index_spec(), got.index_spec()
    assert (gs.kind, gs.metric, gs.params) == (ws.kind, ws.metric, ws.params)
    assert str(gs.quant.scheme) == str(ws.quant.scheme)
    assert (gs.quant.bits, gs.quant.sigmas) == (ws.quant.bits, ws.quant.sigmas)


# --------------------------------------------------------------------------
# layers


def _ref_layer_params(seed=0, d=12, f=20):
    k = jax.random.PRNGKey(seed)
    return _np({
        "dense": R_L.dense_init(k, d, f),
        "embed": R_L.embed_init(k, 30, d),
        "glu": R_L.glu_mlp_init(k, d, f),
        "mlp": R_L.mlp_init(k, [d, f, 7, 3]),
        "norm": {"scale": jax.random.normal(k, (d,)) * 0.1},
    })


LAYER_CASES = ["dense", "embed", "rmsnorm", "glu_gelu", "glu_silu",
               "mlp", "mlp_final_act", "rope", "softcap", "softcap_none",
               "shifted_softplus"]


@pytest.mark.parametrize("case", LAYER_CASES)
def test_layers_equal_the_reference(case):
    p = _ref_layer_params()
    tp = convert.recsys_params_from_reference(p, device="cpu")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 12)).astype(np.float32)
    if case == "dense":
        got, want = T_L.dense(tp["dense"], _t(x)), R_L.dense(p["dense"], x)
    elif case == "embed":
        ids = rng.integers(0, 30, (4, 6)).astype(np.int32)
        got, want = T_L.embed(tp["embed"], _t(ids)), R_L.embed(p["embed"], ids)
    elif case == "rmsnorm":
        got = T_L.rmsnorm(tp["norm"], _t(x))
        want = R_L.rmsnorm(p["norm"], x)
    elif case.startswith("glu"):
        act = case.split("_")[1]
        got = T_L.glu_mlp(tp["glu"], _t(x), act=act)
        want = R_L.glu_mlp(p["glu"], x, act=act)
    elif case.startswith("mlp"):
        fa = case == "mlp_final_act"
        got = T_L.mlp(tp["mlp"], _t(x), final_act=fa)
        want = R_L.mlp(p["mlp"], x, final_act=fa)
    elif case == "rope":
        xr = rng.standard_normal((2, 7, 3, 8)).astype(np.float32)
        pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
        got, want = T_L.rope(_t(xr), _t(pos)), R_L.rope(xr, pos)
    elif case.startswith("softcap"):
        cap = None if case == "softcap_none" else 3.0
        got, want = T_L.softcap(_t(x) * 5, cap), R_L.softcap(x * 5, cap)
    else:
        got = T_L.shifted_softplus(_t(x) * 10)
        want = R_L.shifted_softplus(x * 10)
    _close(got, want)


def test_layer_inits_draw_the_reference_shapes_from_a_generator():
    g = torch.Generator().manual_seed(0)
    tp = {"dense": T_L.dense_init(g, 12, 20, device="cpu"),
          "embed": T_L.embed_init(g, 30, 12, device="cpu"),
          "glu": T_L.glu_mlp_init(g, 12, 20, device="cpu"),
          "mlp": T_L.mlp_init(g, [12, 20, 7, 3], device="cpu"),
          "norm": T_L.rmsnorm_init(12, device="cpu")}
    rp = _ref_layer_params()
    rp["norm"] = {"scale": np.zeros(12, np.float32)}
    got = {k: tuple(v.shape) for k, v in _flat(tp).items()}
    want = {k: tuple(v.shape) for k, v in _flat(rp).items()}
    assert got == want
    assert not torch.equal(tp["glu"]["gate"]["w"], tp["glu"]["up"]["w"])
    g2 = torch.Generator().manual_seed(0)
    again = T_L.dense_init(g2, 12, 20, device="cpu")
    assert torch.equal(again["w"], tp["dense"]["w"])


# --------------------------------------------------------------------------
# interactions


def _gru_mask(b, t):
    """Ones with a gap mid-sequence in row 1 and an all-zero row 2."""
    m = np.ones((b, t), np.float32)
    m[1, t // 3: t // 3 + 3] = 0
    m[2] = 0
    m[3, -2:] = 0
    return m


INTERACTION_CASES = ["dot", "dot_diag", "cross", "autoint", "gru_cell",
                     "augru_cell", "gru_scan", "augru_scan"]


@pytest.mark.parametrize("case", INTERACTION_CASES)
def test_interactions_equal_the_reference(case):
    rng = np.random.default_rng(5)
    k = jax.random.PRNGKey(7)
    if case.startswith("dot"):
        feats = rng.standard_normal((4, 6, 8)).astype(np.float32)
        keep = case == "dot_diag"
        got = T_I.dot_interaction(_t(feats), keep_diag=keep)
        want = R_I.dot_interaction(feats, keep_diag=keep)
        assert got.shape == want.shape
        _close(got, want)
        return
    if case == "cross":
        p = _np(R_I.cross_init(k, 10, 3))
        p = {name: {"w": v["w"], "b": rng.standard_normal(10).astype(
            np.float32)} for name, v in p.items()}
        x0 = rng.standard_normal((6, 10)).astype(np.float32)
        got = T_I.cross_apply(convert.recsys_params_from_reference(
            p, device="cpu"), _t(x0))
        _close(got, R_I.cross_apply(p, x0))
        return
    if case == "autoint":
        p = _np(R_I.autoint_layer_init(k, 8, 2, 4))
        x = rng.standard_normal((3, 5, 8)).astype(np.float32)
        got = T_I.autoint_layer(convert.recsys_params_from_reference(
            p, device="cpu"), _t(x), 2)
        _close(got, R_I.autoint_layer(p, x, 2))
        return
    p = _np(R_I.gru_init(k, 6, 5))
    p["b"] = rng.standard_normal(15).astype(np.float32) * 0.3
    tp = convert.recsys_params_from_reference(p, device="cpu")
    if case.endswith("cell"):
        h = rng.standard_normal((4, 5)).astype(np.float32)
        x = rng.standard_normal((4, 6)).astype(np.float32)
        att = (rng.random(4).astype(np.float32) if case == "augru_cell"
               else None)
        got = T_I._gru_cell(tp, _t(h), _t(x),
                            att=None if att is None else _t(att))
        _close(got, R_I._gru_cell(p, h, x, att=att))
        return
    xs = rng.standard_normal((4, 9, 6)).astype(np.float32)
    mask = _gru_mask(4, 9)
    if case == "gru_scan":
        got = T_I.gru_scan(tp, _t(xs), _t(mask))
        want = R_I.gru_scan(p, xs, mask)
    else:
        pa = _np(R_I.gru_init(k, 6, 6))
        xs = rng.standard_normal((4, 9, 6)).astype(np.float32)
        att = rng.random((4, 9)).astype(np.float32)
        got = T_I.augru_scan(convert.recsys_params_from_reference(
            pa, device="cpu"), _t(xs), _t(att), _t(mask))
        want = R_I.augru_scan(pa, xs, att, mask)
    assert got.shape == want.shape
    _close(got, want)
    assert torch.all(got[2] == 0)       # an all-zero mask keeps h0


# --------------------------------------------------------------------------
# the four architectures


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {"/".join(path): tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_keys_and_shapes(arch):
    cfg = CONFIGS[arch][0].reduced_config()
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in _flat(jax.tree_util.tree_map(
                lambda x: x, R_M.abstract_params(cfg))).items()}
    g = torch.Generator().manual_seed(0)
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in _flat(T_M.init_params(g, _port_cfg(arch),
                                             device="cpu")).items()}
    assert got == want
    meta = _flat(T_M.abstract_params(_port_cfg(arch)))
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in meta.items()} == want
    assert all(v.is_meta for v in meta.values())
    assert _port_cfg(arch).jdtype == torch.float32


def test_init_params_needs_the_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T_M.init_params(torch.Generator(), _port_cfg("dlrm-mlperf"))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_serve_and_loss_equal_the_reference(arch):
    cfg, p = _ref_params(arch)
    batch = _ref_batch(cfg)
    tcfg = _port_cfg(arch)
    tp = convert.recsys_params_from_reference(p, device="cpu")
    assert set(_flat(tp)) == set(_flat(p))
    tb = {k: _t(v) for k, v in batch.items()}
    _close(T_M.forward(tp, tb, tcfg), R_M.forward(p, batch, cfg))
    prob = T_M.serve(tp, tb, tcfg)
    want = np.asarray(R_M.serve(p, batch, cfg))
    _close(prob, want, atol=0)
    _close(make_recsys_serve(tcfg)(tp, tb), R_S.make_recsys_serve(cfg)(
        p, batch), atol=0)
    loss, aux = T_M.bce_loss(tp, tb, tcfg)
    rloss, raux = R_M.bce_loss(p, batch, cfg)
    _close(loss, rloss, atol=0)
    _close(aux["logit_mean"], raux["logit_mean"])


def test_dien_with_an_empty_history_row_equals_the_reference():
    """A fully masked history row: the -1e30 masked scores give uniform
    attention (no NaN), as the reference's."""
    cfg, p = _ref_params("dien", seed=2)
    batch = _ref_batch(cfg, seed=3, batch=6)
    batch["hist_mask"] = _gru_mask(6, cfg.seq_len)
    tp = convert.recsys_params_from_reference(p, device="cpu")
    got = T_M.serve(tp, {k: _t(v) for k, v in batch.items()},
                    _port_cfg("dien"))
    assert torch.isfinite(got).all()
    _close(got, R_M.serve(p, batch, cfg), atol=0)


# --------------------------------------------------------------------------
# data


def test_powerlaw_id_map_equals_the_reference_on_shared_uniforms():
    from repro.configs.base import CRITEO_VOCABS

    vocabs = CRITEO_VOCABS + (63_001, 801, 192_403, 500, 50, 2000)
    for i, vocab in enumerate(vocabs):
        key = jax.random.PRNGKey(i)
        u = np.array(jax.random.uniform(key, (20_000,), minval=1e-6,
                                        maxval=1.0))
        want = np.asarray(R_D._powerlaw_ids(key, (20_000,), vocab))
        got = T_D.powerlaw_ids(torch.from_numpy(u), vocab)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(vocab))


def test_exp32_equals_the_reference_exp():
    x = np.random.default_rng(0).uniform(-80, 88, 200_000).astype(np.float32)
    got = T_D._exp32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.exp(x)))


@pytest.mark.parametrize("arch", ARCHS)
def test_ctr_batch_has_the_reference_layout(arch):
    cfg = _port_cfg(arch)
    g = torch.Generator().manual_seed(0)
    b = T_D.ctr_batch(g, 64, cfg.n_dense, cfg.vocab_sizes, cfg.seq_len,
                      device="cpu")
    want = _ref_batch(CONFIGS[arch][0].reduced_config(), batch=64)
    assert set(b) == set(want)
    for k, v in b.items():
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype).replace("torch.", "") == str(want[k].dtype), k
    sp = b["sparse"].numpy()
    assert (sp >= 0).all() and (sp < np.asarray(cfg.vocab_sizes)).all()
    assert set(np.unique(b["label"].numpy())) <= {0.0, 1.0}
    # a power law: the head ids dominate
    big = int(np.argmax(cfg.vocab_sizes))
    assert np.median(sp[:, big]) < cfg.vocab_sizes[big] / 4


def test_batch_iterator_replays_from_its_start_step():
    it = T_D.batch_iterator(8, 3, (50, 20), seed=4, device="cpu")
    first = [next(it) for _ in range(3)]
    again = next(T_D.batch_iterator(8, 3, (50, 20), seed=4, device="cpu",
                                    start_step=2))
    for k in first[2]:
        assert torch.equal(first[2][k], again[k])
    assert not torch.equal(first[0]["dense"], first[1]["dense"])


# --------------------------------------------------------------------------
# sharding rules on real parameters, and host meshes


class _StandIn:
    """A mesh of the given axis sizes: the rules read only its ``shape``
    and ``axis_names`` (as ``tests/test_torch_dist.py``'s)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_recsys_sharding_on_real_parameters_equals_the_reference(arch):
    ref_cfg = CONFIGS[arch][0].reduced_config()
    # one table past the rules' 4,096-row floor, so some shard
    big = (8192,) + ref_cfg.vocab_sizes[1:]
    ref_cfg = dataclasses.replace(ref_cfg, vocab_sizes=big)
    cfg = dataclasses.replace(_port_cfg(arch), vocab_sizes=big)
    params = T_M.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    aparams = R_M.abstract_params(ref_cfg)
    for shape in ({"data": 16, "model": 16}, {"pod": 2, "data": 8,
                  "model": 4}, {"data": 1, "model": 2}, {"data": 3,
                  "model": 5}):
        mesh = _StandIn(shape)
        got = {k: tuple(v.spec) for k, v in _flat(
            TSH.recsys_params_sharding(mesh, params)).items()}
        rule = RSH._recsys_rule_for(mesh)
        want = {}
        for path, leaf in jax.tree_util.tree_leaves_with_path(aparams):
            p = RSH._path_str(path)
            shp = tuple(int(v) for v in leaf.shape)
            want[p] = tuple(RSH.P(*(
                e if e is not None and RSH._divisible(shp, d, mesh, e)
                else None for d, e in enumerate(rule(p, shp)))))
        assert got == want, shape
        assert any(s and s[0] for s in got.values()) == (
            8192 % max(RSH._axes_size(mesh, ("data", "model")), 1) == 0)


def test_recsys_sharding_on_a_one_device_mesh_equals_the_reference():
    cfg = dataclasses.replace(_port_cfg("dlrm-mlperf"),
                              vocab_sizes=(8192, 100, 50, 2000))
    ref_cfg = dataclasses.replace(R_DLRM.reduced_config(),
                                  vocab_sizes=cfg.vocab_sizes)
    params = T_M.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    rmesh = jax.make_mesh((1, 1), ("data", "model"))
    tmesh = TSH.make_mesh((1, 1), ("data", "model"), ["cpu"])
    want = {RSH._path_str(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_leaves_with_path(RSH.recsys_params_sharding(
                rmesh, R_M.abstract_params(ref_cfg)))}
    got = {k: tuple(v.spec) for k, v in _flat(
        TSH.recsys_params_sharding(tmesh, params)).items()}
    assert got == want
    assert got["tables/t0/table"] == (("data", "model"), None)


@pytest.mark.parametrize("profile,mp,shape", [
    ("ci-cpu", 1, {"data": 1, "model": 1}),
    ("ci-cpu", 4, {"data": 1, "model": 1}),
    ("cpu-mesh4", 1, {"data": 4, "model": 1}),
    ("cpu-mesh4", 2, {"data": 2, "model": 2}),
    ("cpu-mesh4", 3, {"data": 2, "model": 2}),
    ("cpu-mesh4", 8, {"data": 1, "model": 4}),
])
def test_make_host_mesh_shapes(profile, mp, shape):
    rtprofile._reset_for_tests()
    try:
        rtprofile.apply(rtprofile.resolve(profile))
        mesh = T_MESH.make_host_mesh(mp)
        assert mesh.shape == shape
        assert all(d.type == "cpu" for d in mesh.shard_devices())
        with pytest.raises(RuntimeError, match=r"needs 256 devices, have"):
            T_MESH.make_production_mesh()
        with pytest.raises(RuntimeError, match=r"needs 512 devices, have"):
            T_MESH.make_production_mesh(multi_pod=True)
    finally:
        rtprofile._reset_for_tests()
