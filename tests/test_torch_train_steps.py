"""The training objectives and train steps (``models.transformer.lm_loss``,
``launch.steps.make_lm_train_step`` / ``make_recsys_train_step`` /
``make_gnn_train_step``, ``train.train_loop.value_and_grad``) against the
reference's (``jax.value_and_grad``, ``repro.launch.steps``) on identical
inputs, on the CPU, in float32.

Tolerances.  A loss within 1e-6 of the reference's (relative), every
gradient leaf within 1e-5 of its scale (max |reference gradient|), the
gradient norm within rtol 1e-5.  The recsys and SchNet steps floor a
leaf's scale at 1e-3 of the tree's largest gradient (``FLOOR``): a
leaf whose gradient is 0 in exact arithmetic (DIEN's attention-score
bias, which a softmax ignores: 1.2e-10 against 0.25 elsewhere) or far
below the rest (SchNet's ``out2`` weights, 0.005 beside a head bias's
16.8) carries float32 cancellation noise of the tree's scale.  A step's new parameters: Adam's first
step moves an element by lr * g / (|g| + eps) (plus the decay), close to
lr * sign(g), so an element whose reference gradient lies within the
gradient tolerance of 0 (1e-5 of its leaf's gradient scale), but not 0
itself, may move either way in a faithful port.  Those elements are set
aside, counted
(``_hold_step`` returns the count; fewer than 1% of a tree's elements)
and held only to Adam's bound |p_new - p_old| <= lr (1 + wd |p_old|).
Every other element is held within 1e-6 of its leaf's scale plus what
the gradient tolerance moves Adam's first step by, lr * eps * tol /
((|g| + eps) (|g| - tol + eps)).

The llama4 configs run on inputs where the reference's C10 does not
strike (parameters ``PRNGKey(1)``, tokens from numpy seed 0, as
``tests/test_torch_transformer.py``), which a test here holds; at 16
tokens a microbatch C10 struck on every seed tried, so the microbatched
steps run the dense configs.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get as rget  # noqa: E402
from repro.data import graph_data as R_G  # noqa: E402
from repro.data import recsys_data as R_RD  # noqa: E402
from repro.launch import steps as R_S  # noqa: E402
from repro.models import transformer as R_TF  # noqa: E402
from repro.models.gnn import schnet as R_SN  # noqa: E402
from repro.models.recsys import models as R_RM  # noqa: E402
from repro.train import optimizer as R_OPT  # noqa: E402
from repro_torch import convert, testing  # noqa: E402
from repro_torch.configs import get as tget  # noqa: E402
from repro_torch.launch import steps as T_S  # noqa: E402
from repro_torch.launch import (  # noqa: E402
    make_gnn_train_step,
    make_lm_train_step,
    make_recsys_train_step,
)
from repro_torch.models import moe as T_M  # noqa: E402
from repro_torch.models import transformer as T_TF  # noqa: E402
from repro_torch.train import optimizer as T_OPT  # noqa: E402
from repro_torch.train.train_loop import value_and_grad  # noqa: E402

LM_ARCHS = ["gemma-2b", "gemma2-9b", "minicpm-2b", "llama4-scout-17b-16e",
            "llama4-maverick-400b-17b"]
DENSE = ["gemma-2b", "gemma2-9b", "minicpm-2b"]
RECSYS = ["autoint", "dcn-v2", "dien", "dlrm-mlperf"]
LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-6, 1e-5, 1e-6
OPT = dict(lr=1e-3, warmup_steps=0, schedule="const")
FLOOR = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    """Leaves in sorted-key order (the reference's)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _grads_close(got, want, floor=0.0):
    want = list(_leaves(_np(want)))
    got = list(_leaves(got))
    assert len(got) == len(want)
    for g, w, scale in zip(got, want, testing.grad_scales(want, floor)):
        assert tuple(g.shape) == w.shape
        err = np.abs(g.numpy().astype(np.float64) - w).max()
        assert err <= GRAD_TOL * scale, err
    return len(got)


def _hold_step(new, ref_new, old, ref_grads, cfg: T_OPT.OptConfig,
               floor=0.0) -> int:
    """Hold a first AdamW step's parameters (module docstring,
    ``testing.adam_first_step``); returns the count of elements set aside
    as near-zero gradients."""
    held = testing.adam_first_step(
        [t.numpy() for t in _leaves(new)], list(_leaves(_np(ref_new))),
        list(_leaves(old)), list(_leaves(_np(ref_grads))), lr=cfg.lr,
        weight_decay=cfg.weight_decay, eps=cfg.eps, param_tol=PARAM_TOL,
        grad_tol=GRAD_TOL, floor=floor)
    assert held["away"] <= 1.0 and held["near"] <= 1.0, held
    assert held["n_near"] < 0.01 * held["n"], held
    return held["n_near"]


# --------------------------------------------------------------------------
# lm_loss and its gradients


class _LM:
    """An arch's reduced config, the reference's parameters and a batch
    whose tokens are the transformer tests' (numpy seed 0)."""

    def __init__(self, arch, batch=2, seq=24, remat=False, masked=True):
        self.rcfg = dataclasses.replace(rget(arch).reduced_config(),
                                        remat=remat)
        self.cfg = dataclasses.replace(tget(arch).reduced_config(),
                                       remat=remat)
        self.params = _np(R_TF.init_params(jax.random.PRNGKey(1), self.rcfg))
        self.tp = convert.lm_params_from_reference(self.params, device="cpu")
        toks = np.random.default_rng(0).integers(
            0, self.rcfg.vocab, (batch, seq)).astype(np.int32)
        mask = np.ones((batch, seq), np.float32)
        if masked:
            mask[0, -3:] = 0.0                      # masked targets count 0
        self.batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1),
                      "mask": mask}


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_and_gradients_equal_the_reference(arch, remat):
    m = _LM(arch, remat=remat)
    (rl, raux), rg = jax.value_and_grad(R_TF.lm_loss, has_aux=True)(
        m.params, {k: jnp.asarray(v) for k, v in m.batch.items()}, m.rcfg)
    seen = []
    real = T_M.moe_apply

    def record(params, x, cfg, act="silu"):
        seen.append((x.detach().numpy().copy(),
                     params["router"]["w"].detach().numpy(), cfg))
        return real(params, x, cfg, act)

    T_M.moe_apply = record
    try:
        (tl, taux), tg = value_and_grad(
            lambda p, b: T_TF.lm_loss(p, b, m.cfg), m.tp, _t(m.batch))
    finally:
        T_M.moe_apply = real
    np.testing.assert_allclose(float(tl), float(rl), rtol=LOSS_TOL)
    for name in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(taux[name]), float(raux[name]),
                                   rtol=1e-5, atol=1e-7)
    assert _grads_close(tg, rg) == len(jax.tree_util.tree_leaves(rg))
    # the llama4 inputs drop tokens, and C10 does not strike on them
    if m.cfg.moe is not None:
        assert float(taux["drop_frac"]) > 0
        assert seen and not any(testing.c10_strikes(
            x, w, c.n_experts, c.capacity_factor) for x, w, c in seen)


def test_lm_loss_masks_targets_and_adds_the_moe_terms():
    m = _LM("llama4-scout-17b-16e")
    batch = _t(m.batch)
    loss, aux = T_TF.lm_loss(m.tp, batch, m.cfg)
    logits, _ = T_TF.forward(m.tp, batch["tokens"], m.cfg)
    logp = torch.log_softmax(logits, -1)
    nll = -torch.gather(logp, -1, batch["targets"].long()[..., None])[..., 0]
    want = (nll * batch["mask"]).sum() / batch["mask"].sum()
    want = want + 0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)


def test_remat_recomputes_the_block_and_keeps_only_its_input():
    """With remat the backward recomputes each block: the same gradients as
    without, and fewer tensors saved by the forward."""
    counts = {}
    for remat in (False, True):
        m = _LM("gemma2-9b", remat=remat)
        saved = []

        def pack(t):
            saved.append(t.numel())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            (_l, _a), g = value_and_grad(
                lambda p, b: T_TF.lm_loss(p, b, m.cfg), m.tp, _t(m.batch))
        counts[remat] = (sum(saved), g)
    assert counts[True][0] < counts[False][0] / 2
    for a, b in zip(_leaves(counts[True][1]), _leaves(counts[False][1])):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-9)


def test_configs_set_remat_where_the_reference_does():
    for arch in LM_ARCHS:
        assert tget(arch).config().remat is True
        assert tget(arch).reduced_config().remat is False
        assert rget(arch).config().remat is True


# --------------------------------------------------------------------------
# make_lm_train_step


def _lm_step_case(arch, microbatches, batch):
    m = _LM(arch, batch=batch, seq=16)
    opt = T_OPT.OptConfig(**OPT)
    jb = {k: jnp.asarray(v) for k, v in m.batch.items()}
    rp, ro, rm = R_S.make_lm_train_step(
        m.rcfg, R_OPT.OptConfig(**OPT), microbatches=microbatches)(
        m.params, R_OPT.adamw_init(m.params), jb)
    # the reference step's gradient, accumulated as its scan does
    n = batch // microbatches
    rg = None
    for i in range(microbatches):
        mb = {k: v[i * n:(i + 1) * n] for k, v in jb.items()}
        g = jax.grad(lambda p: R_TF.lm_loss(p, mb, m.rcfg)[0])(m.params)
        rg = g if rg is None else jax.tree_util.tree_map(jnp.add, rg, g)
    rg = jax.tree_util.tree_map(lambda a: a / microbatches, rg)
    step = make_lm_train_step(m.cfg, opt, microbatches=microbatches,
                              batch_axes=("data",), grad_specs=None)
    tp, to, tm = step(m.tp, T_OPT.adamw_init(m.tp), _t(m.batch))
    np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]),
                               rtol=GRAD_TOL)
    assert float(tm["lr"]) == float(rm["lr"])
    assert int(to["step"]) == int(ro["step"]) == 1
    _hold_step(tp, rp, m.params, rg, opt)
    for part in ("mu", "nu"):
        for g, w in zip(_leaves(to[part]), _leaves(_np(ro[part]))):
            assert testing.scale_err(g.numpy(), w) <= GRAD_TOL * (
                2 if part == "nu" else 1)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_train_step_equals_the_reference(arch):
    _lm_step_case(arch, 1, 2)


@pytest.mark.parametrize("arch", DENSE)
def test_lm_train_step_with_four_microbatches_equals_the_reference(arch):
    _lm_step_case(arch, 4, 4)


@pytest.mark.parametrize("arch", DENSE)
def test_lm_microbatches_equal_one_batch_on_the_port(arch):
    """The port against itself: four microbatches of a batch give one
    batch's step (dense configs: an MoE layer's capacity depends on the
    tokens a call routes; every target counted, as a microbatch's loss is
    its own masked mean)."""
    m = _LM(arch, batch=4, seq=16, masked=False)
    opt = T_OPT.OptConfig(**OPT)
    out = [make_lm_train_step(m.cfg, opt, microbatches=mb)(
        m.tp, T_OPT.adamw_init(m.tp), _t(m.batch)) for mb in (1, 4)]
    np.testing.assert_allclose(float(out[0][2]["loss"]),
                               float(out[1][2]["loss"]), rtol=1e-6)
    grads = value_and_grad(lambda p, b: T_TF.lm_loss(p, b, m.cfg), m.tp,
                           _t(m.batch))[1]
    for a, b, g in zip(_leaves(out[0][0]), _leaves(out[1][0]),
                       _leaves(grads)):
        away = g.abs() > GRAD_TOL * g.abs().max()
        diff = torch.where(away, (a - b).abs(), torch.zeros_like(a))
        assert float(diff.max()) <= 1e-6 * float(a.abs().max())


# --------------------------------------------------------------------------
# make_recsys_train_step


@pytest.mark.parametrize("arch", RECSYS)
def test_recsys_train_step_equals_the_reference(arch):
    rcfg, tcfg = rget(arch).reduced_config(), tget(arch).reduced_config()
    params = _np(R_RM.init_params(jax.random.PRNGKey(0), rcfg))
    batch = _np(R_RD.ctr_batch(jax.random.PRNGKey(1), 16, rcfg.n_dense,
                               rcfg.vocab_sizes, rcfg.seq_len))
    (rl, _), rg = jax.value_and_grad(R_RM.bce_loss, has_aux=True)(
        params, batch, rcfg)
    rp, _ro, rm = R_S.make_recsys_train_step(rcfg, R_OPT.OptConfig(**OPT))(
        params, R_OPT.adamw_init(params), batch)
    tp = convert.recsys_params_from_reference(params, device="cpu")
    (tl, _), tg = value_and_grad(
        lambda p, b: __import__("repro_torch.models.recsys.models",
                                fromlist=["bce_loss"]).bce_loss(p, b, tcfg),
        tp, _t(batch))
    np.testing.assert_allclose(float(tl), float(rl), rtol=LOSS_TOL)
    # every parameter leaf gets the reference's gradient: no lookup or
    # in-place write cuts the graph (DIEN's GRU included)
    assert _grads_close(tg, rg, FLOOR) == len(jax.tree_util.tree_leaves(rg))
    opt = T_OPT.OptConfig(**OPT)
    np_, _no, nm = make_recsys_train_step(tcfg, opt)(
        tp, T_OPT.adamw_init(tp), _t(batch))
    np.testing.assert_allclose(float(nm["loss"]), float(rm["loss"]),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(float(nm["grad_norm"]),
                               float(rm["grad_norm"]), rtol=GRAD_TOL)
    _hold_step(np_, rp, params, rg, opt, FLOOR)


# --------------------------------------------------------------------------
# make_gnn_train_step


def _gnn_case(kind):
    """(reference cfg, port cfg, params, batch, n_nodes, n_graphs)."""
    shape = "molecule" if kind == "molecule" else "full_graph_sm"
    rcfg, tcfg = (rget("schnet").reduced_config(shape),
                  tget("schnet").reduced_config(shape))
    params = _np(R_SN.init_params(jax.random.PRNGKey(0), rcfg))
    if kind == "molecule":
        g = R_G.random_molecules(4, 6, 12, key=jax.random.PRNGKey(3))
        batch = {"senders": g.senders, "receivers": g.receivers,
                 "edge_mask": g.edge_mask, "z": g.node_feat,
                 "positions": g.positions,
                 "graph_ids": jnp.repeat(jnp.arange(4), 6),
                 "labels": g.labels}
        return rcfg, tcfg, params, _np(batch), g.n_nodes, 4
    g = R_G.random_graph(64, 256, 24, key=jax.random.PRNGKey(3))
    batch = {"senders": g.senders, "receivers": g.receivers,
             "edge_mask": g.edge_mask.at[::7].set(False),
             "node_feat": g.node_feat,
             "labels": jnp.clip(g.labels, 0, rcfg.n_classes - 1)}
    return rcfg, tcfg, params, _np(batch), g.n_nodes, 0


@pytest.mark.parametrize("kind", ["molecule", "full_graph"])
def test_gnn_train_step_equals_the_reference(kind):
    rcfg, tcfg, params, batch, n_nodes, n_graphs = _gnn_case(kind)
    rstep = R_S.make_gnn_train_step(rcfg, kind, R_OPT.OptConfig(**OPT),
                                    n_nodes, n_graphs)
    rp, _ro, rm = rstep(params, R_OPT.adamw_init(params), batch)
    loss_fn = (R_S._schnet_molecule_loss if kind == "molecule"
               else R_S._schnet_node_loss)
    kw = dict(cfg=rcfg, n_nodes=n_nodes)
    if kind == "molecule":
        kw["n_graphs"] = n_graphs
    rg = jax.grad(lambda p: loss_fn(p, batch, **kw))(params)
    opt = T_OPT.OptConfig(**OPT)
    tp = convert.schnet_params_from_reference(params, device="cpu")
    port_loss = (T_S._schnet_molecule_loss if kind == "molecule"
                 else T_S._schnet_node_loss)
    (_l, _a), tg = value_and_grad(
        lambda p, b: (port_loss(p, b, tcfg, **{k: v for k, v in kw.items()
                                               if k != "cfg"}), {}),
        tp, _t(batch))
    assert _grads_close(tg, rg, FLOOR) == len(jax.tree_util.tree_leaves(rg))
    step = make_gnn_train_step(tcfg, kind, opt, n_nodes, n_graphs)
    np_, no, nm = step(tp, T_OPT.adamw_init(tp), _t(batch))
    np.testing.assert_allclose(float(nm["loss"]), float(rm["loss"]),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(float(nm["grad_norm"]),
                               float(rm["grad_norm"]), rtol=GRAD_TOL)
    assert int(no["step"]) == 1
    _hold_step(np_, rp, params, rg, opt, FLOOR)


@pytest.mark.parametrize("case", ["logits", "experts"])
def test_half_dot_f32_backward_keeps_the_float32_cotangent(case):
    """``layers._HalfDotF32``: the card's bf16 product with a float32
    output (the tied logits' and the experts' product in bf16 training)
    has a backward of its own, which only the card reaches through
    ``dot_f32``; it is called here directly on CPU tensors.  For bf16
    operands and a float32 cotangent it equals the CPU branch's autograd
    (both operands in float32) bit for bit, and ``jax.vjp`` of the
    reference's product (``jnp.dot`` / ``jnp.einsum`` with
    ``preferred_element_type=float32``, the cotangent kept in float32)
    within one bf16 ulp of each element."""
    from types import SimpleNamespace

    from repro_torch.models import layers as T_L

    rng = np.random.default_rng(3)
    if case == "logits":
        x = rng.standard_normal((2, 5, 32))
        w = rng.standard_normal((48, 32)).T          # table.T, a view
        g = rng.standard_normal((2, 5, 48))

        def ref(a, b):
            return jnp.dot(a, b, preferred_element_type=jnp.float32)
    else:
        x = rng.standard_normal((4, 6, 32))
        w = rng.standard_normal((4, 32, 16))
        g = rng.standard_normal((4, 6, 16))

        def ref(a, b):
            return jnp.einsum("ecd,edf->ecf", a, b,
                              preferred_element_type=jnp.float32)
    xj, wj = (jnp.asarray(a, jnp.bfloat16) for a in (x, w))
    _out, vjp = jax.vjp(ref, xj, wj)
    want = vjp(jnp.asarray(g, jnp.float32))
    tx, tw = (convert.tree_from_reference(np.asarray(a), device="cpu")
              for a in (xj, wj))
    tg = torch.as_tensor(g, dtype=torch.float32)
    got = T_L._HalfDotF32.backward(SimpleNamespace(saved_tensors=(tx, tw)),
                                   tg)
    ax, aw = (t.detach().requires_grad_() for t in (tx, tw))
    T_L.dot_f32(ax, aw).backward(tg)
    for have, plain, ref_g, op in zip(got, (ax.grad, aw.grad), want,
                                      (tx, tw)):
        assert have.dtype == op.dtype == torch.bfloat16
        assert have.shape == op.shape
        assert torch.equal(have, plain)
        r = np.asarray(ref_g).astype(np.float32)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(r), 1e-30))) - 7)
        assert (np.abs(have.float().numpy() - r) <= ulp).all()
