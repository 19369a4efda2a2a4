"""The training runtime (``repro_torch.train``: optimizer, checkpoint,
train_loop, fault_tolerance; ``launch.train``) against the reference
(``repro.train``) on identical inputs, on the CPU, with the reference's
own ``tests/test_train.py`` cases ported one by one.

Tolerances: ``lr_at`` within 1 float32 ulp of the reference's for the
three schedules; one ``adamw_update`` on the same gradients, parameters
and state within 1e-6 of each leaf's scale (max |reference value|), the
gradient norm within rtol 1e-6.  The gradients are the same arrays in
both packages here, so no element is near a sign flip of Adam's step and
none is set aside (the train-step tests, whose gradients differ, set
aside and count elements whose gradient is near 0:
``tests/test_torch_train_steps.py``).  Checkpoints cross packages in both
directions with equal digests, float32 and bf16 (C11), and ``meta.msgpack``
is byte-equal to ``msgpack.packb``.
"""

import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402
import torch  # noqa: E402

from repro.models import transformer as R_TF  # noqa: E402
from repro.train import checkpoint as R_CKPT  # noqa: E402
from repro.train import fault_tolerance as R_FT  # noqa: E402
from repro.train import optimizer as R_OPT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import train as T  # noqa: E402
from repro_torch.data import lm_data  # noqa: E402
from repro_torch.dist import sharding as TSH  # noqa: E402
from repro_torch.models import transformer as T_TF  # noqa: E402
from repro_torch.train import checkpoint as CKPT  # noqa: E402
from repro_torch.train.fault_tolerance import (  # noqa: E402
    _specs,
    best_mesh_shape,
    elastic_remesh,
    run_with_retries,
)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-6


def _tiny_cfg(pkg):
    cls = R_TF.LMConfig if pkg == "ref" else T_TF.LMConfig
    return cls(name="t", n_layers=2, d_model=32, n_heads=2, n_kv=1,
               head_dim=16, d_ff=64, vocab=128, dtype="float32",
               block_q=16, block_kv=16, remat=False)


@pytest.fixture(scope="module")
def tiny():
    cfg = _tiny_cfg("port")
    params = T_TF.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    batch = lm_data.lm_batch(torch.Generator().manual_seed(7), 8, 16, 128,
                             device="cpu")
    return cfg, params, batch


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _scale_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, err


# --------------------------------------------------------------------------
# the optimizer against the reference


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "const"])
@pytest.mark.parametrize("lr,warmup,total", [(3e-4, 10, 100), (1.0, 0, 120),
                                             (2e-3, 7, 1000)])
def test_lr_at_within_one_ulp_of_the_reference(schedule, lr, warmup, total):
    kw = dict(lr=lr, schedule=schedule, warmup_steps=warmup,
              total_steps=total, decay_frac=0.2)
    rcfg, tcfg = R_OPT.OptConfig(**kw), T.OptConfig(**kw)
    for step in range(121):
        want = np.float32(R_OPT.lr_at(step, rcfg))
        got = T.lr_at(step, tcfg)
        assert got.dtype == torch.float32 and got.dim() == 0
        ulps = abs(int(want.view(np.int32))
                   - int(got.numpy().view(np.int32)))
        assert ulps <= 1, (step, want, float(got))
    assert T.lr_at(torch.tensor(5), tcfg).dtype == torch.float32


def test_lr_at_raises_on_an_unknown_schedule():
    with pytest.raises(ValueError):
        T.lr_at(3, T.OptConfig(schedule="linear"))


def _opt_inputs(seed, fresh):
    rng = np.random.default_rng(seed)
    params = {"a": {"w": rng.standard_normal((5, 7)).astype(np.float32)},
              "b": rng.standard_normal((11,)).astype(np.float32)}
    grads = {"a": {"w": (rng.standard_normal((5, 7)) * 3).astype(np.float32)},
             "b": rng.standard_normal((11,)).astype(np.float32)}
    grads["b"][:3] = [0.0, 1e-12, -1e-9]        # at and near Adam's eps
    if fresh:
        state = {"mu": {"a": {"w": np.zeros((5, 7), np.float32)},
                        "b": np.zeros(11, np.float32)},
                 "nu": {"a": {"w": np.zeros((5, 7), np.float32)},
                        "b": np.zeros(11, np.float32)},
                 "step": np.int32(0)}
    else:
        state = {"mu": {"a": {"w": rng.standard_normal((5, 7))
                              .astype(np.float32) * 0.1},
                        "b": rng.standard_normal(11).astype(np.float32)},
                 "nu": {"a": {"w": rng.random((5, 7)).astype(np.float32)},
                        "b": rng.random(11).astype(np.float32) * 0.01},
                 "step": np.int32(6)}
    return params, grads, state


@pytest.mark.parametrize("fresh", [True, False])
@pytest.mark.parametrize("clip", [1.0, 100.0])
@pytest.mark.parametrize("schedule", ["cosine", "wsd"])
def test_adamw_update_equals_the_reference(fresh, clip, schedule):
    params, grads, state = _opt_inputs(3, fresh)
    kw = dict(lr=1e-2, clip_norm=clip, schedule=schedule, warmup_steps=2,
              total_steps=10)
    rp, rs, rm = R_OPT.adamw_update(
        jax.tree_util.tree_map(jnp.asarray, grads),
        jax.tree_util.tree_map(jnp.asarray, state),
        jax.tree_util.tree_map(jnp.asarray, params), R_OPT.OptConfig(**kw))
    tp = convert.schnet_params_from_reference(params, device="cpu")
    tg = convert.schnet_params_from_reference(grads, device="cpu")
    ts = convert.adamw_state_from_reference(state, device="cpu")
    before = {k: v.clone() for k, v in zip("ab", _leaves(tp))}
    np_, ns, nm = T.adamw_update(tg, ts, tp, T.OptConfig(**kw))
    for got, want in zip(_leaves(np_), _leaves(jax.tree_util.tree_map(
            np.asarray, rp))):
        assert got.dtype == torch.float32
        _scale_close(got.numpy(), want)
    for part in ("mu", "nu"):
        for got, want in zip(_leaves(ns[part]), _leaves(jax.tree_util
                                                      .tree_map(np.asarray,
                                                                rs[part]))):
            _scale_close(got.numpy(), want)
    assert ns["step"].dtype == torch.int32
    assert int(ns["step"]) == int(rs["step"]) == int(state["step"]) + 1
    np.testing.assert_allclose(float(nm["grad_norm"]), float(rm["grad_norm"]),
                               rtol=TOL)
    assert abs(float(nm["lr"]) - float(rm["lr"])) <= np.spacing(
        np.float32(rm["lr"]))
    # the arguments are left as they were (a functional update)
    for k, v in zip("ab", _leaves(tp)):
        assert torch.equal(v, before[k])


def test_adamw_update_writes_bf16_leaves_back_in_bf16():
    """A bf16 parameter is updated in float32 and rounded once: within one
    bf16 ulp of the reference's (both round a float32 value that may
    differ in its last bits)."""
    rng = np.random.default_rng(0)
    p32 = rng.standard_normal((64,)).astype(np.float32)
    g = rng.standard_normal((64,)).astype(np.float32)
    pb = np.asarray(jnp.asarray(p32, jnp.bfloat16))
    rp, _rs, _ = R_OPT.adamw_update({"w": jnp.asarray(g, jnp.bfloat16)},
                                    R_OPT.adamw_init({"w": jnp.asarray(pb)}),
                                    {"w": jnp.asarray(pb)},
                                    R_OPT.OptConfig(lr=1e-2, warmup_steps=0))
    tp = convert.lm_params_from_reference({"w": pb}, device="cpu")
    tg = convert.lm_params_from_reference(
        {"w": np.asarray(jnp.asarray(g, jnp.bfloat16))}, device="cpu")
    got, state, _ = T.adamw_update(tg, T.adamw_init(tp), tp,
                                   T.OptConfig(lr=1e-2, warmup_steps=0))
    assert got["w"].dtype == torch.bfloat16
    assert state["mu"]["w"].dtype == torch.float32
    want = np.asarray(rp["w"]).astype(np.float32)
    have = got["w"].to(torch.float32).numpy()
    ulp = np.exp2(np.floor(np.log2(np.abs(want))) - 7)
    assert (np.abs(have - want) <= ulp).all()


@pytest.mark.parametrize("chunk", [1, 7, 12, 60])
def test_adamw_update_in_row_blocks_equals_the_reference(monkeypatch, chunk):
    """Every leaf is updated in blocks of its leading rows, at most
    ``_CHUNK`` elements a block (at least one row): a small ``_CHUNK``
    cuts these leaves into blocks of one row, of several rows and an
    uneven last one, or leaves one block, as a 2^24-element block cuts
    gemma2-9b's embedding table and stacked MLP weights.  The update
    equals the reference's within 1e-6 of each leaf's scale."""
    monkeypatch.setattr(T.optimizer, "_CHUNK", chunk)
    rng = np.random.default_rng(11)
    shapes = {"emb": (9, 4), "mlp": (3, 4, 5), "b": (11,), "s": ()}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = {k: (rng.standard_normal(s) * 2).astype(np.float32)
             for k, s in shapes.items()}
    state = {"mu": {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
                    for k, s in shapes.items()},
             "nu": {k: (rng.random(s) * 0.01).astype(np.float32)
                    for k, s in shapes.items()},
             "step": np.int32(4)}
    kw = dict(lr=1e-2, clip_norm=5.0, warmup_steps=2, total_steps=10)
    rp, rs, _ = R_OPT.adamw_update(
        *(jax.tree_util.tree_map(jnp.asarray, t)
          for t in (grads, state, params)), R_OPT.OptConfig(**kw))
    np_, ns, _ = T.adamw_update(
        convert.tree_from_reference(grads, device="cpu"),
        convert.tree_from_reference(state, device="cpu"),
        convert.tree_from_reference(params, device="cpu"),
        T.OptConfig(**kw))
    for got, want in ((np_, rp), (ns["mu"], rs["mu"]), (ns["nu"], rs["nu"])):
        for k, s in shapes.items():
            assert tuple(got[k].shape) == s
            _scale_close(got[k].numpy(), np.asarray(want[k]))


def test_adamw_init_matches_the_reference_tree(tiny):
    _cfg, params, _b = tiny
    state = T.adamw_init(params)
    assert set(state) == {"mu", "nu", "step"}
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    for p, m, n in zip(_leaves(params), _leaves(state["mu"]),
                       _leaves(state["nu"])):
        assert m.shape == n.shape == p.shape
        assert m.dtype == torch.float32 and not m.any() and not n.any()


def test_global_norm_equals_the_reference():
    _p, grads, _s = _opt_inputs(1, True)
    want = float(R_OPT.global_norm(jax.tree_util.tree_map(jnp.asarray,
                                                          grads)))
    got = T.optimizer.global_norm(convert.schnet_params_from_reference(
        grads, device="cpu"))
    np.testing.assert_allclose(float(got), want, rtol=TOL)


# ported from tests/test_train.py

def test_adamw_descends_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = T.adamw_init(params)
    cfg = T.OptConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                      schedule="const")
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _m = T.adamw_update(grads, state, params, cfg)
    assert float(params["w"].abs().max()) < 0.1


def test_schedules():
    cfg = T.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      schedule="wsd", decay_frac=0.2, min_lr_ratio=0.1)
    assert float(T.lr_at(0, cfg)) == 0.0
    assert float(T.lr_at(10, cfg)) == pytest.approx(1.0)
    assert float(T.lr_at(50, cfg)) == pytest.approx(1.0)     # stable phase
    assert float(T.lr_at(99, cfg)) < 0.2                      # decay phase
    ccfg = T.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                       schedule="cosine")
    assert float(T.lr_at(99, ccfg)) <= float(T.lr_at(50, ccfg))


def test_grad_clipping():
    params = {"w": torch.zeros(3)}
    cfg = T.OptConfig(lr=0.0, clip_norm=1.0, warmup_steps=0)
    _p, _s, m = T.adamw_update({"w": torch.full((3,), 100.0)},
                               T.adamw_init(params), params, cfg)
    assert float(m["grad_norm"]) > 100  # reported pre-clip


# --------------------------------------------------------------------------
# checkpoints


def _tree_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_roundtrip(tmp_path, tiny):
    _cfg, params, _b = tiny
    tree = {"params": params, "step": torch.tensor(7, dtype=torch.int32)}
    CKPT.save(str(tmp_path), 7, tree)
    restored, meta = CKPT.restore_latest(str(tmp_path), tree)
    assert meta["step"] == 7
    _tree_equal(tree, restored)


def test_checkpoint_skips_corrupt(tmp_path, tiny):
    _cfg, params, _b = tiny
    tree = {"p": params}
    CKPT.save(str(tmp_path), 1, tree)
    CKPT.save(str(tmp_path), 2, tree)
    newest = os.path.join(str(tmp_path), "step_0000000002", "arrays.npz")
    with open(newest, "r+b") as f:
        f.seek(200)
        f.write(b"\xde\xad\xbe\xef")
    _restored, meta = CKPT.restore_latest(str(tmp_path), tree)
    assert meta["step"] == 1  # fell back past the corrupt one


def test_checkpoint_retain(tmp_path, tiny):
    _cfg, params, _b = tiny
    for s in range(5):
        CKPT.save(str(tmp_path), s, {"p": params})
    CKPT.retain(str(tmp_path), keep=2)
    assert CKPT.list_steps(str(tmp_path)) == [3, 4]
    assert CKPT.restore_latest(str(tmp_path / "none"), {"p": params}) == (
        None, None)


def _ref_tree(dtype):
    rcfg = _tiny_cfg("ref")
    params = R_TF.init_params(jax.random.PRNGKey(0), rcfg)
    params = jax.tree_util.tree_map(lambda a: a.astype(dtype), params)
    return {"params": params, "opt": R_OPT.adamw_init(params),
            "step": jnp.int32(5)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, dtype):
    tree = _ref_tree(jnp.dtype(dtype))
    R_CKPT.save(str(tmp_path), 5, tree, metadata={"run": "ref", "n": 3})
    np_tree = jax.tree_util.tree_map(np.asarray, tree)
    template = {"params": convert.lm_params_from_reference(
        np_tree["params"], device="cpu"),
        "opt": convert.adamw_state_from_reference(np_tree["opt"],
                                                  device="cpu"),
        "step": torch.tensor(0, dtype=torch.int32)}
    got, meta = CKPT.restore_latest(str(tmp_path), template)
    _rt, rmeta = R_CKPT.restore_latest(str(tmp_path), tree)
    assert meta == rmeta and meta["user"] == {"run": "ref", "n": 3}
    assert int(got["step"]) == 5 and got["step"].dtype == torch.int32
    # C11: bf16 leaves come back as torch.bfloat16, equal bit for bit
    assert got["params"]["embed"]["table"].dtype == getattr(torch, dtype)
    _tree_equal(got, template | {"step": got["step"]})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, dtype):
    tree = _ref_tree(jnp.dtype(dtype))
    np_tree = jax.tree_util.tree_map(np.asarray, tree)
    port = {"params": convert.lm_params_from_reference(np_tree["params"],
                                                       device="cpu"),
            "opt": convert.adamw_state_from_reference(np_tree["opt"],
                                                      device="cpu"),
            "step": torch.tensor(5, dtype=torch.int32)}
    CKPT.save(str(tmp_path / "port"), 5, port, metadata={"k": [1, None]})
    R_CKPT.save(str(tmp_path / "ref"), 5, tree, metadata={"k": [1, None]})
    # the same paths, digest and user metadata, byte for byte
    meta_bytes = [(tmp_path / d / "step_0000000005" / "meta.msgpack")
                  .read_bytes() for d in ("port", "ref")]
    assert meta_bytes[0] == meta_bytes[1]
    got, meta = R_CKPT.restore_latest(str(tmp_path / "port"), tree)
    _rgot, rmeta = R_CKPT.restore_latest(str(tmp_path / "ref"), tree)
    assert meta["digest"] == rmeta["digest"]
    assert meta["paths"] == rmeta["paths"]
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(np_tree), strict=True):
        g = np.asarray(g)
        assert g.shape == w.shape
        # the reference hands a bf16 leaf back as void |V2 (C11); its bytes
        # are the saved ones
        if dtype == "bfloat16" and w.dtype.name == "bfloat16":
            assert g.dtype == np.dtype("V2")
        assert g.tobytes() == np.ascontiguousarray(w).tobytes()


def test_reference_bf16_restore_is_void_and_jax_refuses_it_c11(tmp_path):
    """C11 pinned: the reference's restore of a bf16 leaf is ``|V2``, which
    ``jnp.asarray`` refuses; the port's restore is ``torch.bfloat16``."""
    tree = {"w": jnp.arange(4, dtype=jnp.bfloat16)}
    R_CKPT.save(str(tmp_path), 1, tree)
    got, _ = R_CKPT.restore_latest(str(tmp_path), tree)
    assert np.asarray(got["w"]).dtype == np.dtype("V2")
    with pytest.raises(TypeError):
        jnp.asarray(got["w"])
    mine, _ = CKPT.restore_latest(
        str(tmp_path), {"w": torch.zeros(4, dtype=torch.bfloat16)})
    assert mine["w"].dtype == torch.bfloat16
    assert mine["w"].tolist() == [0.0, 1.0, 2.0, 3.0]


def test_restore_refuses_a_template_of_another_shape_or_dtype(tmp_path):
    CKPT.save(str(tmp_path), 1, {"w": torch.zeros(4)})
    for bad in ({"w": torch.zeros(5)}, {"w": torch.zeros(4, dtype=torch.int32)},
                {"w": torch.zeros(4), "v": torch.zeros(1)}):
        assert CKPT.restore_latest(str(tmp_path), bad) == (None, None)


@pytest.mark.parametrize("meta", [
    {"step": 3, "paths": ["['a']"], "digest": "ab" * 32, "user": {}},
    {"step": 2**40, "paths": ["x" * 40, "y" * 300, "z" * 70000],
     "digest": "", "user": {"n": [-1, -33, -200, -40000, -2**35, 127, 128,
                                  255, 256, 65535, 65536, 2**32, None, True,
                                  False, (1, 2)],
                            "é": "ü" * 31}},
    {str(i): list(range(i * 7)) for i in range(20)},
    list(range(70000)),
])
def test_msgpack_subset_is_byte_equal_to_msgpack(meta):
    assert CKPT.packb(meta) == msgpack.packb(meta)
    assert CKPT.unpackb(msgpack.packb(meta)) == msgpack.unpackb(
        msgpack.packb(meta))


def test_msgpack_subset_refuses_other_types():
    with pytest.raises(TypeError):
        CKPT.packb({"x": 1.5})
    with pytest.raises(ValueError):
        CKPT.unpackb(msgpack.packb(1.5))
    with pytest.raises(ValueError):
        CKPT.unpackb(msgpack.packb(3) + b"\x00")


def test_checkpoint_paths_follow_the_reference(tmp_path):
    tree = {"b": {"z": np.zeros(2, np.float32),
                  "a": [np.ones(1, np.float32), (np.ones(1, np.float32),
                                                 None)]},
            "a": np.int32(3), "c": None}
    want, _l, _t = R_CKPT._flatten_with_paths(tree)
    got, _leaves2 = CKPT._flatten_with_paths(tree)
    assert got == want


# --------------------------------------------------------------------------
# the loop


def _loss_fn(cfg):
    return lambda p, b: T_TF.lm_loss(p, b, cfg)


def test_train_resume_continues(tmp_path, tiny):
    cfg, params, batch = tiny
    opt = T.OptConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    _p, _o, h1 = T.train(_loss_fn(cfg), params, itertools.repeat(batch), opt,
                         T.TrainConfig(steps=10, ckpt_dir=str(tmp_path),
                                       ckpt_every=5, log_every=2))
    assert [h["step"] for h in h1] == [0, 2, 4, 6, 8, 9]
    assert CKPT.list_steps(str(tmp_path)) == [5, 10]
    p2, o2, h2 = T.train(_loss_fn(cfg), params, itertools.repeat(batch),
                         opt, T.TrainConfig(steps=16, ckpt_dir=str(tmp_path),
                                            ckpt_every=5, log_every=2))
    assert h2[0]["step"] == 10  # resumed, not restarted
    assert int(o2["step"]) == 16
    assert h2[-1]["loss"] < h1[0]["loss"]
    assert set(h2[0]) == {"step", "loss", "grad_norm", "lr", "sec"}


def test_microbatch_equivalence(tiny):
    cfg, params, batch = tiny
    opt = T.OptConfig(lr=1e-3, warmup_steps=0)
    s1 = T.make_train_step(_loss_fn(cfg), opt, microbatches=1, donate=False)
    s4 = T.make_train_step(_loss_fn(cfg), opt, microbatches=4, donate=False)
    p1, _o, m1 = s1(params, T.adamw_init(params), batch)
    p4, _o, m4 = s4(params, T.adamw_init(params), batch)
    diff = max(float((a - b).abs().max())
               for a, b in zip(_leaves(p1), _leaves(p4)))
    assert diff < 1e-4
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)


def test_microbatches_must_divide_the_batch(tiny):
    cfg, params, batch = tiny
    step = T.make_train_step(_loss_fn(cfg), T.OptConfig(), microbatches=3)
    with pytest.raises(ValueError, match="microbatches"):
        step(params, T.adamw_init(params), batch)


def test_train_step_leaves_the_callers_params_without_a_graph(tiny):
    cfg, params, batch = tiny
    step = T.make_train_step(_loss_fn(cfg), T.OptConfig(lr=1e-3))
    p, o, m = step(params, T.adamw_init(params), batch)
    for leaf in itertools.chain(_leaves(params), _leaves(p), _leaves(o)):
        assert not leaf.requires_grad and leaf.grad_fn is None
    assert not m["loss"].requires_grad


def test_preemption_checkpoints_and_stops(tmp_path, tiny):
    cfg, params, batch = tiny
    stop = {"n": 0}

    def data():
        while True:
            stop["n"] += 1
            yield batch

    class Guard(T.train_loop.PreemptionGuard):
        def install(self):
            self.preempted = True        # as if SIGTERM arrived

    real = T.train_loop.PreemptionGuard
    T.train_loop.PreemptionGuard = Guard
    try:
        _p, _o, hist = T.train(_loss_fn(cfg), params, data(),
                               T.OptConfig(lr=1e-3),
                               T.TrainConfig(steps=10, ckpt_dir=str(tmp_path),
                                             ckpt_every=50))
    finally:
        T.train_loop.PreemptionGuard = real
    assert stop["n"] == 1 and hist[0]["step"] == 0
    assert CKPT.list_steps(str(tmp_path)) == [1]


def test_run_with_retries():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("node died")
        return "ok"

    assert run_with_retries(flaky, restore=lambda: None, backoff_s=0.0) == "ok"
    with pytest.raises(RuntimeError):
        run_with_retries(
            lambda: (_ for _ in ()).throw(RuntimeError("always")),
            restore=lambda: None, max_failures=1, backoff_s=0.0,
        )


@pytest.mark.parametrize("n,mp", [(512, 16), (448, 16), (100, 16), (7, 16),
                                  (1, 1), (6, 4), (12, 5)])
def test_elastic_remesh_factorizations(n, mp):
    assert best_mesh_shape(n, mp) == R_FT.best_mesh_shape(n, mp)


def test_elastic_remesh_resharding():
    state = {"w": np.ones((8, 4), np.float32), "s": np.int32(3)}
    mesh, placed = elastic_remesh(state, lambda leaf: TSH.P(),
                                  model_parallel=1, devices=["cpu"])
    assert mesh.shape == {"data": 1, "model": 1}
    np.testing.assert_array_equal(placed["w"].numpy(), state["w"])
    assert placed["s"].shape == () and int(placed["s"]) == 3


def test_elastic_remesh_specs_equal_the_reference():
    """The spec tree on a (data, model) mesh of four CPU devices equals the
    reference's ``NamedSharding`` specs on its one-device mesh for the same
    rule (a rule reading only shapes), and a spec over an axis the mesh
    lacks is refused."""
    state = {"emb": np.zeros((8, 4), np.float32),
             "b": np.zeros((4,), np.float32),
             "s": np.zeros((), np.int32)}

    def rule(leaf):
        return ("model", None) if leaf.ndim == 2 else ()

    _rm, sharded = R_FT.elastic_remesh(
        state, lambda leaf: R_FT.P(*rule(leaf)), model_parallel=1)
    want = {k: tuple(v.sharding.spec) for k, v in sharded.items()}
    mesh, placed = elastic_remesh(state, lambda leaf: TSH.P(*rule(leaf)),
                                  model_parallel=2, devices=["cpu"] * 4)
    assert mesh.shape == {"data": 2, "model": 2}
    got = {k: tuple(v.spec) for k, v in _specs(
        state, lambda leaf: TSH.P(*rule(leaf)), mesh).items()}
    assert got == want
    assert all(t.device.type == "cpu" for t in placed.values())
    assert {k: tuple(t.shape) for k, t in placed.items()} == {
        k: v.shape for k, v in state.items()}
    with pytest.raises(ValueError, match="axis 'pod'"):
        elastic_remesh(state, lambda leaf: TSH.P("pod"), devices=["cpu"])


# --------------------------------------------------------------------------
# the launcher


def _launch(argv, env_extra, module):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               **env_extra)
    return subprocess.run([sys.executable, "-m", module, *argv], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT))


def test_launch_train_prints_the_reference_line_on_the_cpu():
    argv = ["--arch", "gemma-2b", "--steps", "3", "--batch", "2",
            "--seq-len", "16"]
    port = _launch(argv, {"REPRO_RUNTIME_PROFILE": "cpu-dev"},
                   "repro_torch.launch.train")
    ref = _launch(argv, {}, "repro.launch.train")
    assert port.returncode == ref.returncode == 0, port.stderr + ref.stderr
    got = port.stdout.strip().splitlines()[-1]
    want = ref.stdout.strip().splitlines()[-1]
    head = "[launch/train] gemma-2b: final loss "
    assert got.startswith(head) and want.startswith(head)
    assert len(got) == len(want)
    assert 0 < float(got[len(head):]) < 10


def test_launch_train_refuses_the_gnn_family_as_the_reference():
    out = _launch(["--arch", "schnet", "--steps", "1"],
                  {"REPRO_RUNTIME_PROFILE": "cpu-dev"},
                  "repro_torch.launch.train")
    assert out.returncode != 0
    assert "use examples/ for family 'gnn'" in out.stderr


def test_launch_train_reduced_cannot_be_turned_off_c12(monkeypatch):
    """C12 pinned: the reference's ``--reduced`` is ``store_true`` with
    ``default=True``, so the port's parser (its copy) always reads True."""
    from repro_torch.launch import train as LT

    seen = {}

    def stop(self, args=None, namespace=None):
        ns = real(self, args, namespace)
        seen["reduced"] = ns.reduced
        raise SystemExit(0)

    import argparse

    real = argparse.ArgumentParser.parse_args
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(SystemExit):
        LT.main(["--arch", "gemma-2b"])
    assert seen["reduced"] is True


def test_port_never_imports_msgpack():
    """The card's machine has no ``msgpack``: the port writes and reads
    ``meta.msgpack`` with its own subset (``train.checkpoint.packb``)."""
    import re

    pat = re.compile(r"^\s*(import\s+msgpack\b|from\s+msgpack\b)", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert not [f for f in files if pat.search(f.read_text())]
