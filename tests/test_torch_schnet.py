"""SchNet and its graph data (``repro_torch.models.gnn.schnet``,
``data.graph_data``, ``configs.schnet``, ``convert.schnet_params_from_reference``)
against the reference on identical inputs, on the CPU, with the SchNet
cases of the reference's ``tests/test_smoke_archs.py`` ported.

The reference's parameters and graphs go through numpy into the port.
Tolerances: outputs, losses and gradients within 1e-5 of their scale
(max |reference value|; the whole gradient tree's scale for a gradient
leaf, whose own scale can be cancellation noise, as
``tests/test_torch_train_steps.py`` says).  The RBF centres equal
``jnp.linspace`` bit for bit, and ``NeighborSampler`` returns the
reference's subgraph bit for bit on the same ``np.random.Generator``.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import schnet as R_CFG  # noqa: E402
from repro.data import graph_data as R_G  # noqa: E402
from repro.models.gnn import schnet as R_S  # noqa: E402
from repro_torch import convert, testing  # noqa: E402
from repro_torch.configs import schnet as T_CFG  # noqa: E402
from repro_torch.data import graph_data as T_G  # noqa: E402
from repro_torch.models.gnn import schnet as T_S  # noqa: E402
from repro_torch.train.train_loop import value_and_grad  # noqa: E402

TOL = 1e-5
SHAPES = ["molecule", "full_graph_sm", "minibatch_lg", "ogb_products"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _graph(g):
    """A reference Graph's arrays as the port's Graph on the CPU."""
    return T_G.Graph(
        node_feat=_t(g.node_feat), senders=_t(g.senders),
        receivers=_t(g.receivers), edge_mask=_t(g.edge_mask),
        n_nodes=g.n_nodes,
        positions=None if g.positions is None else _t(g.positions),
        labels=None if g.labels is None else _t(g.labels))


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], path + (k,))
    else:
        yield path, tree


def _tree_close(got, want, tol=TOL):
    want = _np(want)
    top = max(float(np.abs(a).max()) for a in jax.tree_util.tree_leaves(want))
    gl = dict(_leaves_with_paths(got))
    wl = dict(_leaves_with_paths(want))
    assert set(gl) == set(wl)
    for p, w in wl.items():
        g = gl[p].detach().numpy()
        assert g.shape == w.shape, p
        assert np.abs(g - w).max() <= tol * top, p


# --------------------------------------------------------------------------
# configs and parameters


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("which", ["config", "reduced_config"])
def test_schnet_configs_equal_the_reference(shape, which):
    got = dataclasses.asdict(getattr(T_CFG, which)(shape))
    assert got == dataclasses.asdict(getattr(R_CFG, which)(shape))
    for attr in ("ARCH_ID", "FAMILY", "SHAPES", "SKIP"):
        assert getattr(T_CFG, attr) == getattr(R_CFG, attr)


@pytest.mark.parametrize("shape", ["molecule", "full_graph_sm"])
@pytest.mark.parametrize("which", ["config", "reduced_config"])
def test_param_tree_matches_the_reference(shape, which):
    rcfg = getattr(R_CFG, which)(shape)
    want = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)),
        jax.eval_shape(lambda: R_S.init_params(jax.random.PRNGKey(0), rcfg)))
    got = T_S.init_params(torch.Generator().manual_seed(0),
                          getattr(T_CFG, which)(shape), device="cpu")
    shapes = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
              for p, t in _leaves_with_paths(got)}
    assert shapes == dict(_leaves_with_paths(want))
    # biases start at zero, weights are drawn
    assert not got["head1"]["b"].any() and got["head1"]["w"].any()


def test_init_params_is_a_function_of_its_generator():
    cfg = T_CFG.reduced_config()
    a, b, c = (T_S.init_params(torch.Generator().manual_seed(s), cfg,
                               device="cpu") for s in (1, 1, 2))
    assert torch.equal(a["interactions"]["filter1"]["w"],
                       b["interactions"]["filter1"]["w"])
    assert not torch.equal(a["interactions"]["filter1"]["w"],
                           c["interactions"]["filter1"]["w"])


# --------------------------------------------------------------------------
# the radial basis


@pytest.mark.parametrize("n,cutoff", [(300, 10.0), (20, 5.0), (7, 3.3),
                                      (64, 7.5), (2, 1.0), (301, 12.25),
                                      (1000, 0.7)])
def test_rbf_centres_equal_jnp_linspace_bit_for_bit(n, cutoff):
    want = np.asarray(jnp.linspace(0.0, cutoff, n))
    got = T_S.rbf_centers(n, cutoff).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_torch_linspace_would_round_otherwise():
    """Why ``rbf_centers`` exists: at the published 300 RBFs on [0, 10]
    ``torch.linspace`` differs from ``jnp.linspace`` in some centre."""
    want = np.asarray(jnp.linspace(0.0, 10.0, 300))
    assert not np.array_equal(torch.linspace(0.0, 10.0, 300).numpy(), want)


@pytest.mark.parametrize("n,cutoff", [(300, 10.0), (20, 5.0)])
def test_rbf_expand_equals_the_reference(n, cutoff):
    d = np.random.default_rng(0).uniform(0, cutoff * 1.2, 257).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda d: R_S.rbf_expand(d, n, cutoff))(d))
    got = T_S.rbf_expand(_t(d), n, cutoff).numpy()
    assert np.abs(got - want).max() <= 1e-6


# --------------------------------------------------------------------------
# forward, losses and gradients


def _molecule_case(cfg_fn, key=3):
    rcfg = cfg_fn("molecule")
    params = _np(R_S.init_params(jax.random.PRNGKey(0), rcfg))
    mol = R_G.random_molecules(4, 6, 12, key=jax.random.PRNGKey(key))
    return rcfg, params, mol


def _feature_case(cfg_fn, key=3, edges=256):
    rcfg = cfg_fn("full_graph_sm")
    params = _np(R_S.init_params(jax.random.PRNGKey(0), rcfg))
    g = R_G.random_graph(64, edges, rcfg.d_feat, key=jax.random.PRNGKey(key))
    g.labels = jnp.clip(g.labels, 0, rcfg.n_classes - 1)
    g.edge_mask = g.edge_mask.at[::5].set(False)
    return rcfg, params, g


def _forward_pair(rcfg, tcfg, params, g, molecule):
    kw = dict(senders=g.senders, receivers=g.receivers,
              edge_mask=g.edge_mask, n_nodes=g.n_nodes)
    if molecule:
        want = R_S.forward(params, rcfg, z=g.node_feat, positions=g.positions,
                           **kw)
        tkw = dict(z=_t(g.node_feat), positions=_t(g.positions))
    else:
        want = R_S.forward(params, rcfg, node_feat=g.node_feat, **kw)
        tkw = dict(node_feat=_t(g.node_feat))
    tp = convert.schnet_params_from_reference(params, device="cpu")
    got = T_S.forward(tp, tcfg, senders=_t(g.senders),
                      receivers=_t(g.receivers), edge_mask=_t(g.edge_mask),
                      n_nodes=g.n_nodes, **tkw)
    return got, np.asarray(want)


@pytest.mark.parametrize("which", ["reduced_config", "config"])
def test_molecule_forward_equals_the_reference(which):
    rcfg, params, mol = _molecule_case(getattr(R_CFG, which))
    got, want = _forward_pair(rcfg, getattr(T_CFG, which)("molecule"), params,
                              mol, True)
    assert got.shape == want.shape == (mol.n_nodes, 1)
    assert testing.scale_err(got.numpy(), want) <= TOL


@pytest.mark.parametrize("which", ["reduced_config", "config"])
def test_feature_graph_forward_equals_the_reference(which):
    if which == "config":        # the published widths at cora's features
        rcfg = R_CFG.config("full_graph_sm")
        params = _np(R_S.init_params(jax.random.PRNGKey(0), rcfg))
        g = R_G.random_graph(200, 800, rcfg.d_feat, key=jax.random.PRNGKey(4))
    else:
        rcfg, params, g = _feature_case(R_CFG.reduced_config)
    got, want = _forward_pair(rcfg, getattr(T_CFG, which)("full_graph_sm"),
                              params, g, False)
    assert got.shape == want.shape == (g.n_nodes, rcfg.n_classes)
    assert testing.scale_err(got.numpy(), want) <= TOL


def test_energy_loss_and_gradients_equal_the_reference():
    rcfg, params, mol = _molecule_case(R_CFG.reduced_config)
    gids = jnp.repeat(jnp.arange(4), 6)
    want, rg = jax.value_and_grad(
        lambda p: R_S.energy_loss(p, rcfg, mol, gids, 4))(params)
    tcfg = T_CFG.reduced_config("molecule")
    tp = convert.schnet_params_from_reference(params, device="cpu")
    (got, _), tg = value_and_grad(
        lambda p, g: (T_S.energy_loss(p, tcfg, g, _t(gids), 4), {}), tp,
        _graph(mol))
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)
    _tree_close(tg, rg)


def test_node_class_loss_and_gradients_equal_the_reference():
    rcfg, params, g = _feature_case(R_CFG.reduced_config)
    want, rg = jax.value_and_grad(
        lambda p: R_S.node_class_loss(p, rcfg, g))(params)
    tcfg = T_CFG.reduced_config("full_graph_sm")
    tp = convert.schnet_params_from_reference(params, device="cpu")
    (got, _), tg = value_and_grad(
        lambda p, gr: (T_S.node_class_loss(p, tcfg, gr), {}), tp, _graph(g))
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)
    _tree_close(tg, rg)


def test_self_edges_have_finite_equal_gradients():
    """The 1e-12 goes on the difference vector, not under the root: a
    self-edge's length is sqrt(3) * 1e-12, and its gradient is finite and
    the reference's."""
    rcfg, params, mol = _molecule_case(R_CFG.reduced_config)
    s = np.array(mol.senders)
    s[::4] = np.array(mol.receivers)[::4]          # every 4th edge a loop
    mol.senders = jnp.asarray(s)
    gids = jnp.repeat(jnp.arange(4), 6)
    rg = jax.grad(lambda p: R_S.energy_loss(p, rcfg, mol, gids, 4))(params)
    tp = convert.schnet_params_from_reference(params, device="cpu")
    (_l, _), tg = value_and_grad(
        lambda p, g: (T_S.energy_loss(p, T_CFG.reduced_config(), g,
                                      _t(gids), 4), {}), tp, _graph(mol))
    for _p, leaf in _leaves_with_paths(tg):
        assert bool(torch.isfinite(leaf).all())
    _tree_close(tg, rg)
    pos = torch.zeros((2, 3), requires_grad=True)
    length = T_S._edge_length(pos, torch.tensor([0]), torch.tensor([0]))
    length.sum().backward()
    assert float(length.detach()) == pytest.approx(3 ** 0.5 * 1e-12, rel=1e-6)
    assert bool(torch.isfinite(pos.grad).all())


# --------------------------------------------------------------------------
# graph data


def test_random_molecules_have_block_diagonal_edges():
    g = T_G.random_molecules(8, 30, 64, generator=torch.Generator()
                             .manual_seed(0), device="cpu")
    assert g.n_nodes == 240 and g.positions.shape == (240, 3)
    assert g.node_feat.shape == (240,) and g.node_feat.dtype == torch.int32
    assert int(g.node_feat.min()) >= 1 and int(g.node_feat.max()) <= 9
    assert g.senders.shape == g.receivers.shape == (8 * 64,)
    assert g.senders.dtype == g.receivers.dtype == torch.int32
    assert bool(g.edge_mask.all()) and g.labels.shape == (8,)
    mol = torch.arange(8).repeat_interleave(64)
    assert torch.equal(g.senders // 30, mol)
    assert torch.equal(g.receivers // 30, mol)
    ref = R_G.random_molecules(8, 30, 64)
    assert (np.asarray(ref.senders) // 30 == mol.numpy()).all()


def test_random_graph_shapes_and_hubs():
    g = T_G.random_graph(500, 4000, 24, device="cpu")
    assert g.node_feat.shape == (500, 24) and g.labels.shape == (500,)
    assert g.senders.dtype == g.receivers.dtype == torch.int32
    assert int(g.senders.max()) < 500 and int(g.receivers.max()) < 500
    assert int(g.labels.max()) < 16
    # squared uniforms put half the senders below a quarter of the ids
    assert float((g.senders < 125).float().mean()) > 0.45
    again = T_G.random_graph(500, 4000, 24, device="cpu")
    assert torch.equal(g.senders, again.senders)


def test_graph_data_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T_G.random_graph(10, 20, 4)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fanouts", [(5, 3), (15, 10), (4,)])
def test_neighbor_sampler_is_bit_equal_to_the_reference(seed, fanouts):
    g = R_G.random_graph(500, 4000, 24, key=jax.random.PRNGKey(seed))
    s, r = np.asarray(g.senders), np.asarray(g.receivers)
    ref = R_G.NeighborSampler(s, r, 500)
    port = T_G.NeighborSampler(s, r, 500)
    assert np.array_equal(ref.indptr, port.indptr)
    seeds = np.random.default_rng(seed).integers(0, 500, 16)
    want = ref.sample(seeds, fanouts, np.random.default_rng(seed + 10))
    got = port.sample(seeds, fanouts, np.random.default_rng(seed + 10))
    assert np.array_equal(got[0], want[0]) and got[0].dtype == want[0].dtype
    assert len(got[1]) == len(want[1]) == len(fanouts)
    for a, b in zip(got[1], want[1]):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_minibatch_sampler_forward_equals_the_reference():
    """The minibatch_lg regime: sampler -> padded subgraph -> forward."""
    rcfg = R_CFG.reduced_config("full_graph_sm")
    g = R_G.random_graph(500, 4000, 24)
    sampler = T_G.NeighborSampler(np.asarray(g.senders),
                                  np.asarray(g.receivers), 500)
    nodes, layers = sampler.sample(np.arange(8), fanouts=(5, 3),
                                   rng=np.random.default_rng(0))
    s = np.concatenate([la[0] for la in layers])
    r = np.concatenate([la[1] for la in layers])
    m = np.concatenate([la[2] for la in layers])
    params = _np(R_S.init_params(jax.random.PRNGKey(0), rcfg))
    feat = np.asarray(g.node_feat)[nodes]
    want = np.asarray(R_S.forward(params, rcfg, senders=s, receivers=r,
                                  edge_mask=m, n_nodes=len(nodes),
                                  node_feat=feat))
    got = T_S.forward(convert.schnet_params_from_reference(params,
                                                           device="cpu"),
                      T_CFG.reduced_config("full_graph_sm"), senders=_t(s),
                      receivers=_t(r), edge_mask=_t(m), n_nodes=len(nodes),
                      node_feat=_t(feat))
    assert got.shape == (len(nodes), rcfg.n_classes)
    assert testing.scale_err(got.numpy(), want) <= TOL


# --------------------------------------------------------------------------
# edge blocks (``forward``'s ``block``, ``RBF_BYTES``)

#: block sizes: one edge a block, a size that leaves a ragged last block,
#: and every edge in one block (the default at these sizes); the feature
#: graphs of these tests have BLOCK_EDGES edges (a block of one edge is a
#: launch of its own a block and an interaction)
BLOCKS = [1, 37, None]
BLOCK_EDGES = 80


def _blocks(monkeypatch, block, n_rbf):
    """Run every SchNet call at ``block`` edges a block (None: the
    default ``RBF_BYTES``), through the byte budget the model reads."""
    if block is not None:
        monkeypatch.setattr(T_S, "RBF_BYTES", block * n_rbf * 4)


def test_edge_block_comes_from_the_byte_budget():
    assert T_S.edge_block(300) == 1_789_569
    assert -(-61_859_140 // T_S.edge_block(300)) == 35
    assert T_S.edge_block(10 ** 12) == 1


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("molecule", [True, False])
def test_blocked_forward_equals_the_reference(block, molecule, monkeypatch):
    rcfg, params, g = (_molecule_case(R_CFG.reduced_config) if molecule
                       else _feature_case(R_CFG.reduced_config,
                                          edges=BLOCK_EDGES))
    _blocks(monkeypatch, block, rcfg.n_rbf)
    tcfg = T_CFG.reduced_config("molecule" if molecule else "full_graph_sm")
    got, want = _forward_pair(rcfg, tcfg, params, g, molecule)
    assert testing.scale_err(got.numpy(), want) <= TOL


@pytest.mark.parametrize("block", BLOCKS)
def test_blocked_losses_and_gradients_equal_the_reference(block,
                                                          monkeypatch):
    rcfg, params, mol = _molecule_case(R_CFG.reduced_config)
    _blocks(monkeypatch, block, rcfg.n_rbf)
    gids = jnp.repeat(jnp.arange(4), 6)
    want, rg = jax.value_and_grad(
        lambda p: R_S.energy_loss(p, rcfg, mol, gids, 4))(params)
    tcfg = T_CFG.reduced_config("molecule")
    tp = convert.schnet_params_from_reference(params, device="cpu")
    (got, _), tg = value_and_grad(
        lambda p, g: (T_S.energy_loss(p, tcfg, g, _t(gids), 4), {}), tp,
        _graph(mol))
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)
    _tree_close(tg, rg)

    rcfg, params, g = _feature_case(R_CFG.reduced_config, edges=BLOCK_EDGES)
    want, rg = jax.value_and_grad(
        lambda p: R_S.node_class_loss(p, rcfg, g))(params)
    tcfg = T_CFG.reduced_config("full_graph_sm")
    tp = convert.schnet_params_from_reference(params, device="cpu")
    (got, _), tg = value_and_grad(
        lambda p, gr: (T_S.node_class_loss(p, tcfg, gr), {}), tp, _graph(g))
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)
    _tree_close(tg, rg)


def _unblocked_forward(params, cfg, senders, receivers, edge_mask, n_nodes,
                       node_feat):
    """The feature-graph forward as it stood before edge blocks: one
    [E, n_rbf] RBF matrix, the messages of every edge at once."""
    from repro_torch.models import layers as T_L

    x = T_L.dense(params["embed"], node_feat)
    proj = T_L.dense(params["dist_proj"], node_feat)
    dist = T_S._edge_length(proj, senders, receivers)
    rbf = T_S.rbf_expand(dist, cfg.n_rbf, cfg.cutoff).to(x.dtype)
    for ip in T_L.unstack(params["interactions"], cfg.n_interactions):
        w = T_S._affine(ip["filter1"], rbf)
        w = T_L.shifted_softplus(w)
        w = T_S._affine(ip["filter2"], w)
        msg = T_L.dense(ip["in_proj"], x)[senders.to(torch.int64)] * w
        msg = torch.where(edge_mask[:, None], msg, torch.zeros_like(msg))
        y = T_S._affine(ip["out1"], T_S._segment_sum(msg, receivers,
                                                     n_nodes))
        y = T_S._affine(ip["out2"], T_L.shifted_softplus(y))
        x = x + y
    y = T_L.shifted_softplus(T_S._affine(params["head1"], x))
    return T_S._affine(params["head2"], y)


def test_one_block_equals_the_unblocked_form_bit_for_bit():
    """At the published widths, with every edge in one block."""
    rcfg, params, g = _feature_case(R_CFG.config)
    tcfg = T_CFG.config("full_graph_sm")
    tp = convert.schnet_params_from_reference(params, device="cpu")
    kw = dict(senders=_t(g.senders), receivers=_t(g.receivers),
              edge_mask=_t(g.edge_mask), n_nodes=g.n_nodes,
              node_feat=_t(g.node_feat))
    got = T_S.forward(tp, tcfg, **kw)
    want = _unblocked_forward(tp, tcfg, **kw)
    assert T_S.edge_block(tcfg.n_rbf) >= g.senders.shape[0]
    assert torch.equal(got, want)
    # the gradients too, but dist_proj's: the unblocked form sums the
    # interactions' RBF gradients before the expansion's backward, the
    # blocked one takes each through the expansion and sums the lengths'
    labels = _t(g.labels)
    (lg, _), gg = value_and_grad(
        lambda p, _b: (T_S._node_nll(T_S.forward(p, tcfg, **kw), labels),
                       {}), tp, None)
    (lw, _), gw = value_and_grad(
        lambda p, _b: (T_S._node_nll(_unblocked_forward(p, tcfg, **kw),
                                     labels), {}), tp, None)
    assert torch.equal(lg, lw)
    top = max(float(v.abs().max()) for _p, v in _leaves_with_paths(gw))
    for (path, a), (_p, b) in zip(_leaves_with_paths(gg),
                                  _leaves_with_paths(gw)):
        if path[0] == "dist_proj":
            assert float((a - b).abs().max()) <= TOL * top
        else:
            assert torch.equal(a, b), path


def test_minibatch_train_step_equals_the_reference():
    """The minibatch_lg regime end to end on a 500-node graph: the
    sampler's subgraph, its layers flattened into one edge list, features
    and labels gathered at its nodes, one make_gnn_train_step."""
    from repro.launch import steps as R_ST
    from repro.train import optimizer as R_OPT
    from repro_torch.launch import steps as T_ST
    from repro_torch.train import optimizer as T_OPT

    rcfg = R_CFG.reduced_config("full_graph_sm")
    tcfg = T_CFG.reduced_config("full_graph_sm")
    g = R_G.random_graph(500, 4000, rcfg.d_feat, key=jax.random.PRNGKey(7))
    sampler = T_G.NeighborSampler(np.asarray(g.senders),
                                  np.asarray(g.receivers), 500)
    nodes, layers = sampler.sample(np.arange(0, 500, 25), fanouts=(5, 3),
                                   rng=np.random.default_rng(3))
    batch = {"senders": np.concatenate([la[0] for la in layers]),
             "receivers": np.concatenate([la[1] for la in layers]),
             "edge_mask": np.concatenate([la[2] for la in layers]),
             "node_feat": np.asarray(g.node_feat)[nodes],
             "labels": np.clip(np.asarray(g.labels)[nodes], 0,
                               rcfg.n_classes - 1).astype(np.int32)}
    n = len(nodes)
    params = _np(R_S.init_params(jax.random.PRNGKey(0), rcfg))
    opt = dict(lr=1e-3, warmup_steps=0, schedule="const")
    rstep = R_ST.make_gnn_train_step(rcfg, "minibatch", R_OPT.OptConfig(**opt),
                                     n)
    _rp, _ro, rm = rstep(params, R_OPT.adamw_init(params), batch)
    rg = jax.grad(lambda p: R_ST._schnet_node_loss(p, batch, rcfg, n))(params)

    tp = convert.schnet_params_from_reference(params, device="cpu")
    tb = {k: _t(v) for k, v in batch.items()}
    (_l, _), tg = value_and_grad(
        lambda p, b: (T_ST._schnet_node_loss(p, b, tcfg, n), {}), tp, tb)
    _tree_close(tg, rg)
    step = T_ST.make_gnn_train_step(tcfg, "minibatch", T_OPT.OptConfig(**opt),
                                    n)
    _new, state, tm = step(tp, T_OPT.adamw_init(tp), tb)
    np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                               rtol=TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]),
                               rtol=TOL)
    assert int(state["step"]) == 1
