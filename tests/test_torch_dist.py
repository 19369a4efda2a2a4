"""The port's ``dist/`` against the reference's, on the CPU.

* ``balance``, ``Placement`` (every factory, ``summary``, ``shard_bytes``,
  ``rows_max``, validation), ``for_index`` and ``sentinel_gids`` equal the
  reference's on the same inputs (``for_index`` on indexes the reference
  built and the port loaded).
* The sharding rules against the reference's ``_lm_rule``,
  ``_recsys_rule_for`` and ``_divisible`` on the paths and shapes of the
  reference's own abstract parameter trees (every assigned architecture at
  full size), through a stand-in mesh that supplies ``.shape`` and
  ``.axis_names``; and the whole rule functions against the reference's on
  a one-device JAX mesh.
* ``engine.distributed_topk`` against the reference's, run under
  ``jax.vmap`` with a named axis (its ``all_gather`` gathers the vmapped
  shards), on hand-made ties, NEG slots and -1 ids, both tie breaks.
* ``core.stats.distributed_stats`` against the reference's one-shot
  ``corpus_stats`` of the whole corpus: the count exact, the moments within
  rtol 1e-6.
* ``replicated_query_plan`` padding, ``submeshes``, the mesh's own rules,
  and the reference's four ``ReplicaSet`` tests, waiting on events.
"""

import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import stats as RST  # noqa: E402
from repro.dist import placement as RP  # noqa: E402
from repro.dist import sharding as RSH  # noqa: E402
from repro.engine import scorer as RS  # noqa: E402
from repro_torch.core import stats as TST  # noqa: E402
from repro_torch.dist import (  # noqa: E402
    Mesh,
    ReplicaSet,
    make_mesh,
    replicated_query_plan,
    sentinel_gids,
    submeshes,
)
from repro_torch.dist import placement as TP  # noqa: E402
from repro_torch.dist.replica import replicate  # noqa: E402
from repro_torch.dist import sharding as TSH  # noqa: E402
from repro_torch.engine import NEG, distributed_topk  # noqa: E402

RNG = np.random.default_rng(0)


def _same_placement(a, b):
    assert (a.kind, a.n_shards, a.assign, a.unit_sizes, a.replicated_rows) \
        == (b.kind, b.n_shards, b.assign, b.unit_sizes, b.replicated_rows)
    assert a.summary() == b.summary()
    assert a.n_rows == b.n_rows and a.n_units == b.n_units
    if a.n_shards:
        assert a.rows_max == b.rows_max
        assert a.shard_bytes(3) == b.shard_bytes(3)
        for s in range(a.n_shards):
            assert a.shard_units(s) == b.shard_units(s)
            assert a.shard_rows(s) == b.shard_rows(s)


# -- placement ------------------------------------------------------------------

@pytest.mark.parametrize("trial", range(6))
def test_balance_and_factories_equal_the_reference(trial):
    rng = np.random.default_rng(trial)
    n_units = int(rng.integers(0, 40))
    sizes = [int(x) for x in rng.integers(0, 500, n_units)]
    if trial % 2:                         # skewed, with ties
        sizes = [int(x) for x in rng.choice([0, 1, 7, 7, 300], n_units)]
    for n_shards in (1, 2, 3, 4, 7):
        assert TP.balance(sizes, n_shards) == RP.balance(sizes, n_shards)
        _same_placement(TP.Placement.lists(sizes, n_shards),
                        RP.Placement.lists(sizes, n_shards))
        _same_placement(TP.Placement.segments(sizes or [0], n_shards),
                        RP.Placement.segments(sizes or [0], n_shards))
        n = int(rng.integers(0, 1000))
        _same_placement(TP.Placement.rows(n, n_shards),
                        RP.Placement.rows(n, n_shards))
        _same_placement(TP.Placement.replicated(n, n_shards),
                        RP.Placement.replicated(n, n_shards))


def test_rows_placement_with_empty_shards():
    """Three rows over four shards: ceil blocks leave shard 3 empty."""
    p = TP.Placement.rows(3, 4)
    assert p.unit_sizes == (1, 1, 1, 0) and p.rows_max == 1
    _same_placement(p, RP.Placement.rows(3, 4))
    _same_placement(TP.Placement.rows(0, 2), RP.Placement.rows(0, 2))


@pytest.mark.parametrize("bad", [
    ("rows", 2, (0, 2), (5, 5)),        # shard id out of range
    ("bogus", 2, (0, 1), (5, 5)),       # unknown kind
    ("lists", 2, (0, 1), (5,)),         # assign and sizes misaligned
])
def test_placement_validation_matches_the_reference(bad):
    with pytest.raises(ValueError) as want:
        RP.Placement(*bad)
    with pytest.raises(ValueError) as got:
        TP.Placement(*bad)
    assert str(got.value) == str(want.value)


def test_balance_refuses_no_shards():
    with pytest.raises(ValueError, match="n_shards must be positive"):
        TP.balance([1, 2], 0)


def test_for_index_equals_the_reference_on_its_own_indexes(tmp_path):
    from repro.knn import make_index as r_make
    from repro_torch.knn import load_index

    corpus = RNG.standard_normal((256, 16)).astype(np.float32)
    for factory, over in (("flat", {}), ("ivf8", {"kmeans_iters": 2}),
                          ("hnsw8", {"ef_construction": 20}),
                          ("pq4+lpq", {"kmeans_iters": 2}),
                          ("cascade(ivf8,lpq8|r32)", {"kmeans_iters": 2}),
                          ("stream(flat,lpq8)", {"seal_threshold": 96})):
        ref = r_make(factory, corpus, key=jax.random.PRNGKey(0), **over)
        path = tmp_path / f"{factory.replace('|', '_')}.npz"
        ref.save(str(path))
        port = load_index(path, device="cpu")
        for n_shards in (1, 2, 4):
            _same_placement(TP.for_index(port, n_shards),
                            RP.for_index(ref, n_shards))


# -- sentinel gids -----------------------------------------------------------------

@pytest.mark.parametrize("n,n_shards,padded", [(97, 2, 50), (300, 4, 128),
                                                (10, 3, 4)])
def test_sentinel_gids_equal_the_reference(n, n_shards, padded):
    rows_per = -(-n // n_shards)
    for shard in range(n_shards):
        lrow = np.arange(padded, dtype=np.int32)
        gid0 = shard * rows_per + lrow
        valid = (lrow < rows_per) & (gid0 < n) & (RNG.random(padded) < 0.8)
        want = np.asarray(RSH.sentinel_gids(
            jnp.asarray(gid0), jnp.asarray(valid), shard=shard,
            local_rows=jnp.asarray(lrow), n_total=n, padded_rows=padded))
        got = sentinel_gids(torch.from_numpy(gid0), torch.from_numpy(valid),
                            shard=shard, local_rows=torch.from_numpy(lrow),
                            n_total=n, padded_rows=padded)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got.numpy()[~valid] >= n).all()


# -- sharding rules -----------------------------------------------------------------

class _StandIn:
    """What the rule functions read of a mesh."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


STAND_INS = [{"data": 16, "model": 16}, {"pod": 2, "data": 8, "model": 4},
             {"data": 1, "model": 2}, {"data": 3, "model": 5}]


def _reference_trees():
    from repro.configs import ASSIGNED, get
    from repro.models import transformer as TF
    from repro.models.gnn import schnet as SN
    from repro.models.recsys import models as RM

    out = []
    for arch in ASSIGNED:
        mod = get(arch)
        cfg = mod.config()
        if mod.FAMILY == "lm":
            tree = TF.abstract_params(cfg)
        elif mod.FAMILY == "recsys":
            tree = RM.abstract_params(cfg)
        else:
            tree = jax.eval_shape(
                lambda cfg=cfg: SN.init_params(jax.random.PRNGKey(0), cfg))
        out.append((arch, mod.FAMILY, tree))
    return out


TREES = _reference_trees()


def _shapes(tree):
    return jax.tree_util.tree_map(lambda x: tuple(int(v) for v in x.shape),
                                  tree)


def _port_leaves(nest, path=()):
    """{path: leaf} of a port spec nest (the rules' own path strings)."""
    if isinstance(nest, dict):
        out = {}
        for k, v in nest.items():
            out.update(_port_leaves(v, path + (str(k),)))
        return out
    if isinstance(nest, (list, tuple)) and not isinstance(nest, TSH.P):
        out = {}
        for i, v in enumerate(nest):
            out.update(_port_leaves(v, path + (str(i),)))
        return out
    return {"/".join(path): nest}


def _expected(mesh, path, shape, rule):
    return tuple(RSH.P(*(
        e if e is not None and RSH._divisible(shape, d, mesh, e) else None
        for d, e in enumerate(rule(path, shape)))))


@pytest.mark.parametrize("arch,family,tree", TREES,
                         ids=[a for a, _f, _t in TREES])
def test_model_rules_equal_the_reference_on_its_parameter_trees(arch, family,
                                                                tree):
    shapes = _shapes(tree)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    for shape in STAND_INS:
        mesh = _StandIn(shape)
        assert TSH.dp_axes(mesh) == RSH.dp_axes(mesh)
        if family == "lm":
            rule, got = RSH._lm_rule, TSH.lm_params_sharding(mesh, shapes)
            opt = TSH.lm_opt_sharding(mesh, shapes)
            grads = _port_leaves(TSH.lm_grad_specs(shapes))
        elif family == "recsys":
            rule = RSH._recsys_rule_for(mesh)
            got = TSH.recsys_params_sharding(mesh, shapes)
            opt = TSH.recsys_opt_sharding(mesh, shapes)
        else:
            got = opt = TSH.gnn_params_sharding(mesh, shapes)
        got, opt = _port_leaves(got), _port_leaves(opt)
        assert len(got) == len(leaves)
        for p, leaf in leaves:
            path = RSH._path_str(p)
            shape_t = tuple(int(v) for v in leaf.shape)
            want = (() if family == "gnn"
                    else _expected(mesh, path, shape_t, rule))
            assert got[path].mesh is mesh
            assert tuple(got[path].spec) == want, (arch, path)
            assert tuple(opt[path].spec) == want, (arch, path)
            if family == "lm":
                assert tuple(grads[path]) == tuple(
                    RSH.lm_zero_spec(path, leaf)), (arch, path)


def test_rules_on_a_one_device_mesh_equal_the_reference_whole():
    """The reference's rule functions end to end (a real one-device JAX
    mesh, where every axis divides) against the port's on a (1, 1) mesh."""
    rmesh = jax.make_mesh((1, 1), ("data", "model"))
    tmesh = make_mesh((1, 1), ("data", "model"), ["cpu"])
    for arch, family, tree in TREES:
        fn = {"lm": "lm_params_sharding", "recsys": "recsys_params_sharding",
              "gnn": "gnn_params_sharding"}[family]
        want = {RSH._path_str(p): tuple(s.spec) for p, s in
                jax.tree_util.tree_leaves_with_path(
                    getattr(RSH, fn)(rmesh, tree))}
        got = {p: tuple(s.spec) for p, s in
               _port_leaves(getattr(TSH, fn)(tmesh, _shapes(tree))).items()}
        assert got == want, arch
    for batch in (1, 2, 8):
        assert tuple(TSH.lm_cache_spec(tmesh, batch).spec) == tuple(
            RSH.lm_cache_spec(rmesh, batch).spec)
    assert tuple(TSH.gnn_edge_sharding(tmesh).spec) == tuple(
        RSH.gnn_edge_sharding(rmesh).spec)
    assert TSH.corpus_shards(tmesh) == RSH.corpus_shards(rmesh)
    assert TSH.replicated(tmesh, {"a": (2, 3), "b": [(4,)]})["b"][0].spec == ()


@pytest.mark.parametrize("shape", ["molecule", "full_graph_sm"])
def test_gnn_rules_on_real_schnet_parameters(shape):
    """``gnn_params_sharding`` on the port's own SchNet parameter tree (real
    tensors from ``models.gnn.schnet.init_params``): every leaf replicated,
    the same paths and specs as the reference's rule on its tree."""
    from repro.models.gnn import schnet as RSN
    from repro_torch.configs import schnet as T_SCFG
    from repro_torch.models.gnn import schnet as TSN

    cfg = T_SCFG.config(shape)
    params = TSN.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    rtree = jax.eval_shape(lambda: RSN.init_params(jax.random.PRNGKey(0),
                                                   _cfg_ref(shape)))
    rmesh = jax.make_mesh((1, 1), ("data", "model"))
    want = {RSH._path_str(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_leaves_with_path(
                RSH.gnn_params_sharding(rmesh, rtree))}
    for mesh in (make_mesh((1, 1), ("data", "model"), ["cpu"]),
                 make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)):
        got = _port_leaves(TSH.gnn_params_sharding(mesh, params))
        assert {p: tuple(v.spec) for p, v in got.items()} == want
        assert all(v.mesh is mesh for v in got.values())
    assert sum(t.numel() for t in _port_leaves(params).values()) == sum(
        int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(rtree))


def _cfg_ref(shape):
    from repro.configs import schnet as R_SCFG

    return R_SCFG.config(shape)


def test_cache_spec_degrades_on_divisibility():
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    assert TSH.lm_cache_spec(mesh, 4).spec == (None, None, "data", None,
                                               None, None)
    assert TSH.lm_cache_spec(mesh, 3).spec == ()
    spec = TSH.lm_zero_spec("layers/mlp/gate/w", (4, 64, 128))
    assert "data" in spec and "model" in spec
    assert TSH.lm_zero_spec("layers/mlp/gate/w", (4, 64, 128)) == \
        RSH.lm_zero_spec("layers/mlp/gate/w",
                         jax.ShapeDtypeStruct((4, 64, 128), jnp.float32))


# -- the mesh ------------------------------------------------------------------------

def test_mesh_shape_and_devices():
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    assert mesh.devices.shape == (2, 2) and mesh.devices.size == 4
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.axis_names == ("data", "model")
    assert all(d == torch.device("cpu") for d in mesh.shard_devices())
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((4,), ("data",), ["cpu"] * 3)
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.array([torch.device("cpu")] * 2, dtype=object),
             ("data", "model"))


def test_mesh_refuses_mixed_device_types():
    with pytest.raises(ValueError, match="one type"):
        make_mesh((2,), ("data",), ["cpu", "meta"])


def test_default_mesh_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((1,), ("data",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        submeshes(1)


# -- distributed_topk -------------------------------------------------------------

def _reference_merge(scores, ids, k, offsets, tie_break):
    """The reference's ``distributed_topk`` with its shards as a vmapped
    named axis (``all_gather`` over it gathers the shards)."""
    fn = jax.vmap(lambda s, i, o: RS.distributed_topk(
        s, i, k, "shard", o, tie_break=tie_break), axis_name="shard")
    s, i = fn(jnp.asarray(np.stack(scores)), jnp.asarray(np.stack(ids)),
              jnp.asarray(np.asarray(offsets, np.int32)))
    return np.asarray(s[0]), np.asarray(i[0])


def _hand_made(n_shards, Q, kk, rng):
    """Per-shard lists with heavy ties (a few distinct scores), NEG slots
    with -1 ids, and -1 ids beside real scores nowhere (as the plans)."""
    scores, ids = [], []
    for _ in range(n_shards):
        s = rng.choice(np.float32([3.0, 1.5, 1.5, -0.0, 0.0, -2.0]),
                       (Q, kk)).astype(np.float32)
        i = rng.integers(0, 50, (Q, kk)).astype(np.int32)
        dead = rng.random((Q, kk)) < 0.3
        s[dead], i[dead] = NEG, -1
        order = np.argsort(-s, axis=1, kind="stable")  # a shard's list is sorted
        scores.append(np.take_along_axis(s, order, 1))
        ids.append(np.take_along_axis(i, order, 1))
    return scores, ids


@pytest.mark.parametrize("tie_break", ["order", "id"])
@pytest.mark.parametrize("n_shards,kk,k", [(1, 5, 5), (2, 6, 6), (4, 5, 7),
                                           (3, 8, 2)])
def test_distributed_topk_equals_the_reference(tie_break, n_shards, kk, k):
    rng = np.random.default_rng(n_shards * 10 + kk)
    scores, ids = _hand_made(n_shards, 6, kk, rng)
    offsets = [s * 100 for s in range(n_shards)]
    ws, wi = _reference_merge(scores, ids, k, offsets, tie_break)
    gs, gi = distributed_topk([torch.from_numpy(x) for x in scores],
                              [torch.from_numpy(x) for x in ids], k, offsets,
                              tie_break=tie_break)
    assert gs.dtype == torch.float32 and gi.dtype == torch.int32
    np.testing.assert_array_equal(gs.numpy().view(np.int32),
                                  ws.view(np.int32))
    np.testing.assert_array_equal(gi.numpy(), wi)


def test_distributed_topk_tie_breaks_by_hand():
    s = [torch.tensor([[2.0, 1.0]]), torch.tensor([[2.0, NEG]])]
    i = [torch.tensor([[9, 3]], dtype=torch.int32),
         torch.tensor([[1, -1]], dtype=torch.int32)]
    so, io = distributed_topk(s, i, 3)                   # shard order
    assert io.tolist() == [[9, 1, 3]] and so.tolist() == [[2.0, 2.0, 1.0]]
    _so, io = distributed_topk(s, i, 4, tie_break="id")  # id order, NEG last
    assert io.tolist() == [[1, 9, 3, -1]]
    _so, io = distributed_topk(s, i, 2, [0, 10])         # rebased, -1 kept
    assert io.tolist() == [[9, 11]]
    with pytest.raises(ValueError, match="tie_break"):
        distributed_topk(s, i, 2, tie_break="score")


# -- distributed_stats ------------------------------------------------------------

@pytest.mark.parametrize("splits", [(100,), (40, 60), (10, 0, 70, 20),
                                    (1, 1, 98)])
def test_distributed_stats_equal_one_shot_reference_stats(splits):
    x = (RNG.standard_normal((sum(splits), 12)) * 3 + 1).astype(np.float32)
    shards = np.split(x, np.cumsum(splits)[:-1])
    got = TST.distributed_stats([torch.from_numpy(s) for s in shards])
    want = RST.corpus_stats(jnp.asarray(x))
    assert float(got.count) == float(want.count) == x.shape[0]
    for f in ("mean", "m2", "amax", "vmin", "vmax"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(x).max()), err_msg=f)
    for f in ("amax", "vmin", "vmax"):               # ranges are exact
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


# -- replicas ----------------------------------------------------------------------

def test_replicated_query_plan_pads_and_restores():
    mesh = make_mesh((4,), ("data",), ["cpu"] * 4)
    seen = []

    def core(qs):
        seen.append(qs.shape[0])
        s = torch.sum(qs, dim=-1, keepdim=True)
        return s, torch.zeros_like(s, dtype=torch.int32)

    run = replicated_query_plan(core, mesh)
    for Q in (1, 3, 8, 9):
        seen.clear()
        q = torch.from_numpy(np.random.RandomState(Q).randn(Q, 4)
                             .astype(np.float32))
        s, i = run(q)
        assert s.shape == (Q, 1) and i.shape == (Q, 1)
        assert seen == [-(-Q // 4)] * 4          # equal slices, zero-padded
        torch.testing.assert_close(s, torch.sum(q, -1, keepdim=True),
                                   rtol=0, atol=0)


def test_submeshes_disjoint_cover():
    devs = ["cpu"] * 5
    groups = submeshes(2, devs)
    assert [g.devices.size for g in groups] == [2, 2]
    assert all(g.axis_names == ("data",) for g in groups)
    assert [g.devices.size for g in submeshes(9, devs)] == [1] * 5


def test_replicate_moves_nothing_already_there():
    from repro_torch.knn import make_index

    idx = make_index("hnsw8,lpq8", RNG.standard_normal((64, 8))
                     .astype(np.float32), device="cpu", ef_construction=16)
    rep = replicate(idx, "cpu")
    assert rep.store.data.data_ptr() == idx.store.data.data_ptr()
    assert all(a.data_ptr() == b.data_ptr()
               for a, b in zip(rep.layers, idx.layers))
    assert rep.entry == idx.entry and rep.n == idx.n


def test_replicaset_routes_and_serves():
    served = []

    def make(r):
        return lambda x: served.append((r, x)) or (r, x * 10)

    rs = ReplicaSet(make, 2)
    futs = [rs.submit(i, queries=1) for i in range(6)]
    out = [f.result(timeout=10) for f in futs]
    rs.close()
    assert sorted(x for _r, x in out) == [0, 10, 20, 30, 40, 50]
    assert {r for r, _x in served} <= {0, 1}


def test_replicaset_admission_sheds_and_counts():
    from repro_torch.runtime.telemetry import Telemetry

    started, gate = threading.Event(), threading.Event()
    tel = Telemetry()

    def make(r):
        def run(x):
            started.set()
            gate.wait(10)
            return x
        return run

    rs = ReplicaSet(make, 1, max_queue=1, telemetry=tel)
    first = rs.submit(0, queries=1)
    assert started.wait(10)
    # the one replica holds one request (executing): at its cap, it sheds
    assert rs.submit(99, queries=1) is None
    assert tel.counters["replica_shed"] == 1
    gate.set()
    assert first.result(timeout=10) == 0
    rs.close()
    assert tel.counters["replica0_requests"] == 1
    assert tel.counters["replica0_queries"] == 1
    assert tel.counters["replica0_queue_peak"] == 1
    assert tel.counters["requests"] == 1           # one served request row


def test_replicaset_counts_every_request_under_thread_switches():
    """Many submitters, more replicas than cores, a short switch interval:
    no request, counter or telemetry row is lost."""
    import os
    import sys

    from repro_torch.runtime.telemetry import Telemetry

    n_rep, n_sub, per = 2 * (os.cpu_count() or 2), 8, 40
    tel = Telemetry()
    rs = ReplicaSet(lambda r: (lambda x: x + 1), n_rep, telemetry=tel)
    results = [None] * n_sub
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def submit(t):
            futs = [rs.submit(t * per + i, queries=2) for i in range(per)]
            results[t] = [f.result(timeout=30) for f in futs]

        threads = [threading.Thread(target=submit, args=(t,))
                   for t in range(n_sub)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        rs.drain()
    finally:
        sys.setswitchinterval(old)
        rs.close()
    total = n_sub * per
    assert sorted(x for part in results for x in part) == list(
        range(1, total + 1))
    c = tel.counters
    assert sum(c[f"replica{r}_requests"] for r in range(n_rep)) == total
    assert sum(c[f"replica{r}_queries"] for r in range(n_rep)) == 2 * total
    assert c["requests"] == total and len(tel.events) == total
    assert rs._depths == [0] * n_rep


def test_replicaset_rebuild_is_a_write_barrier():
    epochs = {"e": 0}

    def make(r):
        e = epochs["e"]
        return lambda x: (e, x)

    rs = ReplicaSet(make, 2)
    assert rs.submit(1).result(timeout=10)[0] == 0
    epochs["e"] = 1
    rs.rebuild()
    assert rs.submit(1).result(timeout=10)[0] == 1
    rs.close()


def test_replicaset_surfaces_exceptions():
    def make(r):
        def run(x):
            raise RuntimeError("boom")
        return run

    rs = ReplicaSet(make, 1)
    fut = rs.submit(1)
    with pytest.raises(RuntimeError, match="boom"):
        fut.result(timeout=10)
    rs.close()
    with pytest.raises(ValueError, match="n_replicas must be positive"):
        ReplicaSet(make, 0)
