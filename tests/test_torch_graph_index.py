"""The port's NGT-style graph index (``repro_torch.knn.graph_index``)
against the reference's on identical inputs.

* Search parity on indexes the reference built and saved and the port
  loaded: the integer arms (int8 ip / l2 / angular, packed int4 at the odd
  augmented width, int8 with an fp32 rerank tail) give bit-equal ids,
  scores and stats, one-shot and through a bucketed ``Searcher``.  The
  fp32 arm sums floats in torch's order: recall@10 within 0.01 of the
  reference's, each returned id's score within rtol 1e-6 of the
  reference's score for it.
* Build parity: given the reference's draws and float sums (``_given``:
  the seed centroids, the ip augmentation column, the Eq. 1 constants of
  the augmented corpus) the integer arms build the reference's adjacency;
  the seed ids are the reference's except where a centroid sits at an
  exact tie between two rows (a k-means cluster of two rows), where the
  two packages' f32 sums may pick either (G-T5).  On the port's own draws
  recall is held statistically and memory is the reference's formula.
* One test for each trap of the build (G-T1 to G-T5) and of the plan (the
  entry set, then the walk, then the whole search), the Searcher's
  query width under augmentation, npz both ways, and the parts not ported
  yet raising naming their ROADMAP item.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import engine as r_engine  # noqa: E402
from repro.core.preserve import recall_at_k as r_recall  # noqa: E402
from repro.knn import graph as RG  # noqa: E402
from repro.knn import load_index as r_load  # noqa: E402
from repro.knn import make_index as r_make  # noqa: E402
from repro.knn.graph_index import GraphIndex as RGraphIndex  # noqa: E402
from repro.knn import SearchParams as RParams  # noqa: E402
from repro.tune import table as tunetable  # noqa: E402
from repro_torch import convert, engine  # noqa: E402
from repro_torch.core.preserve import recall_at_k  # noqa: E402
from repro_torch.knn import SearchParams, as_spec, load_index, make_index  # noqa: E402
from repro_torch.knn import graph as G  # noqa: E402
from repro_torch.knn import graph_index as GI  # noqa: E402
from repro_torch.knn.base import load_state  # noqa: E402

N, D, NQ, K = 2000, 32, 21, 10
INT_ARMS = ["graph8,lpq8@gaussian:3", "graph8,lpq8,l2",
            "graph8,lpq8@global_absmax,angular", "graph8,lpq4",
            "graph8,lpq8+r32"]


@pytest.fixture(autouse=True)
def _no_tune_table():
    # the reference consults a process-wide TuneTable; compare untuned
    with tunetable.pinned(None):
        yield


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    corpus = rng.standard_normal((N, D)).astype(np.float32)
    queries = rng.standard_normal((NQ, D)).astype(np.float32)
    return corpus, queries


@pytest.fixture(scope="module")
def recall_queries(data):
    corpus, _ = data
    q = np.random.default_rng(22).standard_normal((300, D)).astype(np.float32)
    return q, np.array(r_make("flat", corpus).search(q, K).ids)


@pytest.fixture(scope="module")
def built(data, tmp_path_factory):
    """Each arm built once by the reference, saved, and loaded by the port."""
    corpus, _ = data
    out = {}
    for f in INT_ARMS + ["graph8"]:
        ref = r_make(f, corpus)
        path = tmp_path_factory.mktemp("graph") / "ref.npz"
        ref.save(str(path))
        out[f] = (ref, load_index(path, device="cpu"), path)
    return out


def _ref_extra(corpus):
    """G-T1's column by the reference's own expression (graph_index.py
    :119-120)."""
    c = jnp.asarray(corpus)
    n2 = jnp.sum(c * c, axis=-1)
    return np.asarray(jnp.sqrt(jnp.maximum(jnp.max(n2) - n2, 0.0)))


def _ref_draws(ref, corpus):
    """The reference's random draws and float sums, for ``_given``."""
    given = {"centroids": np.asarray(ref.seeds)}
    p = ref.store.params
    if p is not None:
        given["params"] = convert.quant_params_from_numpy(
            *(np.asarray(v) for v in (p.lo, p.hi, p.zero)), p.bits, p.scheme,
            device="cpu")
    if ref.aug:
        given["extra"] = _ref_extra(corpus)
    return given


def _index_space(corpus, aug):
    if not aug:
        return corpus.astype(np.float64)
    return np.concatenate([corpus, _ref_extra(corpus)[:, None]],
                          1).astype(np.float64)


def _same(got, want, *, stats=True):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    if stats:
        assert got.stats == want.stats


def _same_rerank(got, want):
    """``+r32``: the fp32 rerank tail sums in torch's order: ids and stats
    equal, scores within rtol 1e-6, as ``tests/test_torch_hnsw.py``."""
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6)
    assert got.stats == want.stats


def _seed_ids_equal_but_ties(port, ref, corpus):
    """Seed ids equal, or (G-T5) the two picks tie: both rows sit at the
    same f64 distance from the centroid to within f32 rounding of the
    negated-L2 formula's terms (a k-means cluster of two rows puts its
    centroid at their midpoint).  Returns the number of ties."""
    a, b = port.seed_ids.numpy(), np.asarray(ref.seed_ids)
    x = _index_space(corpus, ref.aug)
    c = np.asarray(ref.seeds, np.float64)
    ties = 0
    for s in np.nonzero(a != b)[0]:
        da, db = (((x[i] - c[s]) ** 2).sum() for i in (a[s], b[s]))
        scale = (c[s] ** 2).sum() + max((x[a[s]] ** 2).sum(),
                                        (x[b[s]] ** 2).sum())
        assert abs(da - db) <= 1e-6 * scale, (s, a[s], b[s], da, db)
        ties += 1
    return ties


# --------------------------------------------------------------------------
# search parity on reference-built indexes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("f", INT_ARMS)
@pytest.mark.parametrize("ef", [16, 40])
def test_search_bit_equal_on_reference_graphs(built, data, f, ef):
    """One-shot search; ``+r32`` also holds its walk (the plan at the
    rerank depth, before the fp32 tail) bit-equal."""
    _, queries = data
    ref, port, _ = built[f]
    got = port.search(queries, K, ef_search=ef)
    want = ref.search(queries, K, ef_search=ef)
    if not f.endswith("+r32"):
        _same(got, want)
        return
    _same_rerank(got, want)
    depth = 4 * K
    _same(port.plan(depth, SearchParams(ef_search=ef))(queries),
          ref.plan(depth, RParams(ef_search=ef))(jnp.asarray(queries)))


@pytest.mark.parametrize("f", INT_ARMS)
def test_bucketed_searcher_bit_equal_on_reference_graphs(built, data, f):
    """21 queries in buckets (8, 16): a full 16-slice and a padded 8."""
    _, queries = data
    ref, port, _ = built[f]
    want = ref.searcher(K, RParams(ef_search=24), batch_sizes=(8, 16))(queries)
    got = port.searcher(K, SearchParams(ef_search=24),
                        batch_sizes=(8, 16))(queries)
    (_same_rerank if f.endswith("+r32") else _same)(got, want)
    assert got.stats["padded_q"] == 3 and got.stats["bucket"] == 8


def test_fp32_arm_within_tolerance_on_the_same_graph(built, recall_queries):
    queries, gt = recall_queries
    ref, port, _ = built["graph8"]
    want = ref.search(queries, K, ef_search=40)
    got = port.search(queries, K, ef_search=40)
    r_rec = r_recall(gt, want.ids)
    t_rec = recall_at_k(torch.from_numpy(gt), got.ids)
    assert abs(t_rec - r_rec) <= 0.01, (t_rec, r_rec)
    # each returned id's internal (augmented l2) score against the
    # reference's score for that id
    score_set = r_engine.make_score_set(ref.store, "l2")
    for j in range(0, len(queries), 10):
        ids = got.ids[j].numpy()
        assert (ids >= 0).all()
        qa = jnp.concatenate([jnp.asarray(queries[j]), jnp.zeros(1)])
        ref_s = np.asarray(score_set(qa, jnp.asarray(ids)))
        np.testing.assert_allclose(got.scores[j].numpy(), ref_s, rtol=1e-6)
    assert got.stats == want.stats


def test_plan_entry_set_then_walk_then_search(built, data):
    """The plan's traps in order: the entry set (``engine.topk`` of the
    f32 augmented queries over the f32 seeds, n_entry = min(8, n_seeds),
    mapped through seed_ids), then the walk from those entries at ef =
    max(ef_search, k), then the cut to k and the stats."""
    _, queries = data
    ref, port, _ = built["graph8,lpq8@gaussian:3"]
    qa = np.concatenate([queries, np.zeros((NQ, 1), np.float32)], 1)
    n_entry = min(8, ref.seeds.shape[0])
    _, rp, _ = r_engine.topk(jnp.asarray(qa),
                             r_engine.CodeStore.dense(ref.seeds), n_entry,
                             "l2")
    r_entry = np.asarray(ref.seed_ids[rp])
    _, tp, _ = engine.topk(torch.from_numpy(qa),
                           engine.CodeStore.dense(port.seeds), n_entry, "l2")
    t_entry = port.seed_ids[tp.long()]
    np.testing.assert_array_equal(t_entry.numpy(), r_entry)
    ef = max(5, K)
    rs, ri = RG.beam_search_batch(ref.store.encode_queries(jnp.asarray(qa)),
                                  ref.adj, jnp.asarray(r_entry),
                                  r_engine.make_score_set(ref.store, "l2"), ef)
    ts, ti = G.beam_search_batch(port.prepare_queries(torch.from_numpy(qa)),
                                 port.adj, t_entry,
                                 engine.make_batch_score_set(port.store, "l2"),
                                 ef)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    got = port.search(queries, K, ef_search=5)
    np.testing.assert_array_equal(got.ids.numpy(), ti.numpy()[:, :K])
    bound = n_entry + 8 * ef * 8
    assert got.stats["ef_search"] == ef and got.stats["n_entry"] == n_entry
    assert got.stats["candidates"] == bound and got.stats["chunks"] == 1
    assert got.stats["bytes_read"] == NQ * bound * port.store.row_bytes


# --------------------------------------------------------------------------
# build parity and the build's traps
# --------------------------------------------------------------------------

@pytest.mark.parametrize("f", INT_ARMS)
def test_build_on_reference_draws_equals_reference_graph(built, data, f):
    corpus, _ = data
    ref, _, _ = built[f]
    port = GI.GraphIndex.build(corpus, f, device="cpu",
                               _given=_ref_draws(ref, corpus))
    np.testing.assert_array_equal(port.adj.numpy(), np.asarray(ref.adj))
    np.testing.assert_array_equal(port.store.data.numpy(),
                                  np.asarray(ref.store.data))
    np.testing.assert_array_equal(port.seeds.numpy(), np.asarray(ref.seeds))
    assert _seed_ids_equal_but_ties(port, ref, corpus) <= 2
    assert (port.aug, port.internal_metric) == (ref.aug, ref.internal_metric)
    assert port.memory_bytes() == ref.memory_bytes()
    assert set(port.build_parts) == {"self_join", "assembly", "seeds"}


def test_augmentation_column_and_refit_constants_g_t1(built, data):
    """G-T1: for ip the corpus gains sqrt(max ||x||^2 - ||x||^2) (the port
    sums it in torch's order: within rtol 1e-6 of the reference's), the
    walk runs on l2 at width d+1, pre-learned d-wide constants are dropped
    and re-fitted on the augmented corpus, and the rerank store stays in
    user space."""
    corpus, queries = data
    ref, _, _ = built["graph8,lpq8+r32"]
    port = make_index("graph8,lpq8+r32", corpus, device="cpu")
    assert port.aug and port.internal_metric == "l2"
    assert port.store.d == D + 1 and port.rerank_store.d == D
    norms2 = (corpus.astype(np.float64) ** 2).sum(1)
    want = np.sqrt(norms2.max() - norms2)
    got = port.store.params.zero.numpy()       # gaussian: the mean per dim
    np.testing.assert_allclose(got[-1], want.mean(), rtol=1e-5)
    np.testing.assert_allclose(port.store.params.lo.numpy(),
                               np.asarray(ref.store.params.lo), rtol=1e-5,
                               atol=1e-6)
    spec = as_spec("graph8,lpq8+r32")
    pre = spec.quant.learn(torch.from_numpy(corpus))          # d wide
    with_pre = spec.__class__(**{**spec.__dict__,
                                 "quant": spec.quant.with_params(pre)})
    again = GI.GraphIndex.build(corpus, with_pre, device="cpu",
                                _given=_ref_draws(ref, corpus))
    assert again.store.params.lo.shape == (D + 1,)
    np.testing.assert_array_equal(again.adj.numpy(), np.asarray(ref.adj))
    # queries enter in user space; the plan appends the zero column
    res = again.searcher(K)(queries)
    assert res.ids.shape == (NQ, K)


def test_query_width_is_user_space_under_augmentation(built, data):
    """Item 5: the Searcher checks user-space width on an ip graph
    (``store.d - 1``), as the reference's ``_query_dim`` does."""
    _, queries = data
    _, port, _ = built["graph8,lpq8@gaussian:3"]
    assert port.searcher(K)(queries).ids.shape == (NQ, K)
    padded = np.concatenate([queries, np.zeros((NQ, 1), np.float32)], 1)
    with pytest.raises(ValueError, match="query dim 33 != index dim 32"):
        port.searcher(K)(padded)
    _, l2, _ = built["graph8,lpq8,l2"]
    assert not l2.aug and l2.searcher(K)(queries).ids.shape == (NQ, K)


def test_own_draws_are_not_the_reference_s_g_t2(built, data,
                                                recall_queries):
    """G-T2: without ``_given`` the seeds come from the port's k-means on a
    torch generator, never the reference's ``jax.random`` draw, so the
    build is held statistically: recall@10 at ef_search 40 over 300
    queries within 0.01 (fp32) / 0.02 (int8) of the reference's, memory
    the reference's formula."""
    corpus, _ = data
    queries, gt = recall_queries
    for f, tol in (("graph8", 0.01), ("graph8,lpq8@gaussian:3", 0.02)):
        ref, _, _ = built[f]
        port = make_index(f, corpus, device="cpu")
        assert not np.allclose(port.seeds.numpy(), np.asarray(ref.seeds))
        r_rec = r_recall(gt, ref.search(queries, K, ef_search=40).ids)
        t_rec = recall_at_k(torch.from_numpy(gt),
                            port.search(queries, K, ef_search=40).ids)
        assert abs(t_rec - r_rec) <= tol, (f, t_rec, r_rec)
        store = N * (D + 1) + 3 * (D + 1) * 4 if port.quantized \
            else N * (D + 1) * 4
        assert port.memory_bytes() == store + N * 8 * 4 + 32 * (D + 1) * 4 \
            + 32 * 4
        assert port.build_seconds > 0


def test_self_join_in_blocks_equals_one_block_g_t3(built, data,
                                                    monkeypatch):
    """G-T3: the exact kNN self-join in blocks of a few queries gives the
    one-batch graph (each query's top-k does not depend on the others)."""
    corpus, _ = data
    ref, loaded, _ = built["graph8,lpq4"]
    monkeypatch.setattr(GI, "JOIN_BYTES", 4 * N * 7)          # 7 rows a block
    assert GI.join_block_rows(loaded.store, "l2", 5) == 7
    port = GI.GraphIndex.build(corpus, "graph8,lpq4", device="cpu",
                               _given=_ref_draws(ref, corpus))
    np.testing.assert_array_equal(port.adj.numpy(), np.asarray(ref.adj))


def test_column_zero_is_dropped_whatever_it_holds_g_t3():
    """G-T3: column 0 of the self-join is dropped as "self" (graph_index.py
    :146).  With duplicated rows the lower id wins the tie, so row i's
    column 0 can be its twin and i itself survives into the graph, in the
    reference and in the port alike."""
    rng = np.random.default_rng(5)
    corpus = rng.standard_normal((300, 8)).astype(np.float32)
    corpus[150:] = corpus[:150]                          # each row twice
    ref = RGraphIndex.build(jnp.asarray(corpus), "graph8,lpq8,l2")
    port = GI.GraphIndex.build(corpus, "graph8,lpq8,l2", device="cpu",
                               _given=_ref_draws(ref, corpus))
    np.testing.assert_array_equal(port.adj.numpy(), np.asarray(ref.adj))
    # the trap is live: rows whose own id survived into their adjacency
    self_rows = (port.adj.numpy() == np.arange(300)[:, None]).any(1)
    assert self_rows[150:].sum() >= 50 and not self_rows[:150].any()


def _onng_loop(nbr, degree):
    """The reference's literal loop (graph_index.py:148-160), the oracle."""
    n = nbr.shape[0]
    adj = np.full((n, degree), -1, np.int32)
    counts = np.zeros(n, np.int32)
    for i in range(n):
        for j in nbr[i]:
            if j < 0:
                continue
            if counts[i] < degree:
                adj[i, counts[i]] = j
                counts[i] += 1
            if counts[j] < degree:
                adj[j, counts[j]] = i
                counts[j] += 1
    return adj


def test_vectorized_onng_assembly_equals_the_loop_g_t4():
    """G-T4 on 200 random graphs: -1 pads, duplicate ids in a row, self
    ids, rows that fill past the cap, degrees 1 to 12."""
    rng = np.random.default_rng(0)
    for case in range(200):
        n = int(rng.integers(1, 60))
        half = int(rng.integers(1, 8))
        degree = int(rng.integers(1, 13))
        nbr = rng.integers(-1, n, (n, half)).astype(np.int32)
        if case % 3 == 0:
            nbr[:, 0] = np.arange(n)                       # self ids
        if case % 4 == 0 and half > 1:
            nbr[:, 1] = nbr[:, 0]                          # duplicates
        np.testing.assert_array_equal(
            GI.onng_adjacency(torch.from_numpy(nbr), degree).numpy(),
            _onng_loop(nbr, degree), err_msg=f"case {case}")


def test_seed_ids_take_the_first_maximum_g_t5():
    """G-T5: each seed is the row nearest its centroid by f32 negated L2
    over the index's (augmented) space, the lowest id on an exact tie."""
    rng = np.random.default_rng(8)
    corpus = rng.standard_normal((400, 16)).astype(np.float32)
    corpus[300:310] = corpus[40:50]                     # exact twins
    cents = corpus[[300, 305, 7, 41]]
    for f in ("graph8,lpq8,l2", "graph8,lpq8@gaussian:3"):
        ref = RGraphIndex.build(jnp.asarray(corpus), f, n_seeds=4)
        given = {**_ref_draws(ref, corpus)}
        aug = ref.aug
        given["centroids"] = (np.concatenate(
            [cents, given["extra"][[300, 305, 7, 41], None]], 1)
            if aug else cents)
        port = GI.GraphIndex.build(corpus, f, device="cpu", n_seeds=4,
                                   _given=given)
        np.testing.assert_array_equal(port.seed_ids.numpy(), [40, 45, 7, 41])


# --------------------------------------------------------------------------
# persistence, raises, device
# --------------------------------------------------------------------------

def test_port_saved_graph_searches_the_same_in_the_reference(built, data,
                                                             tmp_path):
    corpus, queries = data
    port = make_index("graph8,lpq4", corpus, device="cpu")
    path = tmp_path / "port.npz"
    port.save(path)
    ref = r_load(str(path))
    _same(port.search(queries, K, ef_search=40),
          ref.search(queries, K, ef_search=40))
    assert ref.aug == port.aug and ref.degree == port.degree
    ref_idx, loaded, ref_path = built["graph8,lpq8+r32"]
    arrays, meta = load_state(ref_path)
    conv = convert.graph_from_reference_state(arrays, meta, device="cpu")
    _same(conv.search(queries, K, ef_search=40),
          loaded.search(queries, K, ef_search=40))
    assert conv.memory_bytes() == loaded.memory_bytes() == ref_idx.memory_bytes()
    with np.load(ref_path) as a, np.load(path) as b:
        assert set(a.files) - {"rr_data"} == set(b.files)


def test_unported_parts_raise_naming_their_roadmap_item(built, data):
    corpus, queries = data
    _, port, path = built["graph8,lpq8@gaussian:3"]
    # per-seed constants (A11) now build, search and round-trip
    rg = make_index("graph8,lpq8,regions", corpus, device="cpu")
    assert rg.regions is not None and rg.region_store.d == corpus.shape[1]
    res = rg.search(queries[:3], K, ef_search=40)
    assert res.ids.shape == (3, K) and res.stats["regional"] is True
    with pytest.raises(ValueError, match="regions"):
        port.region_drift(corpus)
    rg_path = path.parent / "regions.npz"
    rg.save(rg_path)
    arrays, meta = load_state(rg_path)
    back = GI.GraphIndex.from_state(arrays, meta, device="cpu")
    assert "rg_regions" in meta and back.regions is not None
    assert torch.equal(back.search(queries[:3], K, ef_search=40).ids, res.ids)
    # the mesh plans run: replicated placement, equal to unsharded
    from repro_torch.dist import Placement, make_mesh

    mesh = make_mesh((2,), ("data",), ["cpu"] * 2)
    assert port.placement(2).kind == "replicated"
    q = queries[:5]
    un, sh = port.searcher(K)(q), port.searcher(K, shards=mesh)(q)
    assert torch.equal(un.ids, sh.ids) and torch.equal(un.scores, sh.scores)
    assert sh.stats["shards"] == 2 and sh.stats["placement"] == "replicated"
    with pytest.raises(ValueError, match="only replicates"):
        port.plan(K, mesh=mesh, placement=Placement.rows(port.n, 2))
    with pytest.raises(ValueError, match="SearchParams.filter must be"):
        port.searcher(K, SearchParams(filter=object()))
    with pytest.raises(ValueError, match="SearchParams.filter must be"):
        port.plan(K, SearchParams(filter=object()))


def test_graph_runs_on_the_card_unless_cpu_is_asked(data, monkeypatch):
    corpus, _ = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_index("graph8,lpq8", corpus[:200])
