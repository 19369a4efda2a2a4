"""The port's HNSW index (``repro_torch.knn.hnsw``) against the reference's
on identical inputs.

* Search parity on graphs the reference built and saved and the port
  loaded: the integer arms (int8 ip / l2 / angular, packed int4, int8 with
  an fp32 rerank tail) give bit-equal ids, scores and stats, one-shot and
  through a bucketed ``Searcher``.  The fp32 arm's walk sums floats in
  another order, so one near-tie can send it down another path: its
  recall@10 is held within 0.01 of the reference's, and every id it
  returns carries the reference's score for that id within rtol 1e-6.
* Build parity: given the reference's levels (``_levels``), the integer
  arms build the reference's adjacency and entry exactly (the build's
  traps B-T1 to B-T4 each name a case).  On the port's own levels recall@10
  is within 0.02 of the reference's and ``memory_bytes`` is the
  reference's formula.
* npz both ways, and the parts not ported yet raise naming their ROADMAP
  item.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import engine as r_engine  # noqa: E402
from repro.core.preserve import recall_at_k as r_recall  # noqa: E402
from repro.knn import SearchParams as RParams  # noqa: E402
from repro.knn import load_index as r_load  # noqa: E402
from repro.knn import make_index as r_make  # noqa: E402
from repro.tune import table as tunetable  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.preserve import recall_at_k  # noqa: E402
from repro_torch.knn import SearchParams, load_index, make_index  # noqa: E402
from repro_torch.knn import hnsw as H  # noqa: E402
from repro_torch.knn.base import load_state  # noqa: E402

N, D, NQ, K = 3000, 64, 21, 10
BUILD = {"ef_construction": 40, "batch_size": 128}
INT_ARMS = ["hnsw8,lpq8@gaussian:3", "hnsw8,lpq8,l2",
            "hnsw8,lpq8@global_absmax,angular", "hnsw8,lpq4",
            "hnsw8,lpq8+r32"]


@pytest.fixture(autouse=True)
def _no_tune_table():
    # the reference consults a process-wide TuneTable; compare untuned
    with tunetable.pinned(None):
        yield


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    corpus = rng.standard_normal((N, D)).astype(np.float32)
    queries = rng.standard_normal((NQ, D)).astype(np.float32)
    return corpus, queries


@pytest.fixture(scope="module")
def recall_queries(data):
    """300 queries and their exact fp32 top-10 (the recall checks: 21
    queries would move recall in steps of 1/210)."""
    corpus, _ = data
    q = np.random.default_rng(12).standard_normal((300, D)).astype(np.float32)
    return q, np.array(r_make("flat", corpus).search(q, K).ids)


@pytest.fixture(scope="module")
def built(data, tmp_path_factory):
    """Each arm built once by the reference, saved, and loaded by the port."""
    corpus, _ = data
    out = {}
    for f in INT_ARMS + ["hnsw8"]:
        ref = r_make(f, corpus, **BUILD)
        path = tmp_path_factory.mktemp("hnsw") / "ref.npz"
        ref.save(str(path))
        out[f] = (ref, load_index(path, device="cpu"), path)
    return out


def _same(got, want, *, stats=True):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    if stats:
        assert got.stats == want.stats


def _same_rerank(got, want):
    """``+r32``: the rerank tail re-scores in fp32 (``engine.rerank_among``),
    summed in another order than XLA's: ids and stats equal, scores within
    rtol 1e-6, as ``tests/test_torch_flat.py`` holds ``flat,lpq4+r32``."""
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6)
    assert got.stats == want.stats


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
    if f.endswith("+r32"):
        assert got.stats["reranked"] == 40 and got.stats["rerank_bytes"] > 0


def test_fp32_arm_within_tolerance_on_the_same_graph(built, recall_queries):
    """The fp32 walk sums floats in torch's order: its ids are not held
    equal (one near-tie can change the path), its recall and scores are."""
    queries, gt = recall_queries
    ref, port, _ = built["hnsw8"]
    want = ref.search(queries, K, ef_search=40)
    got = port.search(queries, K, ef_search=40)
    r_rec = r_recall(gt, want.ids)
    t_rec = recall_at_k(torch.from_numpy(gt), got.ids)
    assert abs(t_rec - r_rec) <= 0.01, (t_rec, r_rec)
    # each returned id's score against the reference's score for that id
    score_set = r_engine.make_score_set(ref.store, "ip")
    for j in range(0, len(queries), 10):
        ids = got.ids[j].numpy()
        assert (ids >= 0).all()
        ref_s = np.asarray(score_set(jnp.asarray(queries[j]), jnp.asarray(ids)))
        np.testing.assert_allclose(got.scores[j].numpy(), ref_s, rtol=1e-6)
    assert got.stats == want.stats


def test_port_saved_graph_searches_the_same_in_the_reference(built, data,
                                                             tmp_path):
    """npz both ways: the reference's file loads in the port (every test
    above), and a port-built, port-saved index loads in the reference with
    the same search results; ``convert`` gives the npz route's index."""
    corpus, queries = data
    port = make_index("hnsw8,lpq4", corpus, device="cpu", **BUILD)
    path = tmp_path / "port.npz"
    port.save(path)
    ref = r_load(str(path))
    _same(port.search(queries, K, ef_search=40),
          ref.search(queries, K, ef_search=40))
    assert ref.entry == port.entry and np.array_equal(ref.levels, port.levels)
    ref_idx, loaded, ref_path = built["hnsw8,lpq8+r32"]
    arrays, meta = load_state(ref_path)
    conv = convert.hnsw_from_reference_state(arrays, meta, device="cpu")
    _same(conv.search(queries, K, ef_search=40),
          loaded.search(queries, K, ef_search=40))
    assert conv.memory_bytes() == loaded.memory_bytes() == ref_idx.memory_bytes()


@pytest.mark.parametrize("f", [
    pytest.param("hnsw8,lpq8@gaussian:3", id="ip_levels_b_t1"),
    pytest.param("hnsw8,lpq4", id="int4_ties_b_t2"),
    pytest.param("hnsw8,lpq8@global_absmax,angular", id="angular_dot_prune_b_t3"),
    pytest.param("hnsw8,lpq8,l2", id="l2_mirror_b_t4"),
    pytest.param("hnsw8,lpq8+r32", id="rerank_store"),
])
def test_build_on_reference_levels_equals_reference_graph(built, data, f):
    """B-T1: the reference's levels go in through ``_levels``; the rest of
    the build is then deterministic.  B-T2: tied integer scores prune in
    numpy's argsort order.  B-T3: back-connections prune by the raw dot
    (angular too) and every point walks every layer.  B-T4: the walk reads
    a device mirror refreshed with each batch's committed rows."""
    corpus, _ = data
    ref, _, _ = built[f]
    port = H.HNSWIndex.build(corpus, f, device="cpu", _levels=ref.levels,
                             **BUILD)
    assert len(port.layers) == len(ref.layers)
    for a, b in zip(port.layers, ref.layers):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert port.entry == ref.entry
    assert port.memory_bytes() == ref.memory_bytes()


def test_a_stable_prune_would_drift_from_the_reference_b_t2(built, data,
                                                            monkeypatch):
    """B-T2 is live on this data: a stable sort in ``_prune`` orders tied
    int4 scores differently and the adjacency drifts."""
    corpus, _ = data
    ref, _, _ = built["hnsw8,lpq4"]

    def stable(ids, scores, cap):
        return ids[np.argsort(-scores, kind="stable")][:cap]

    monkeypatch.setattr(H, "_prune", stable)
    port = H.HNSWIndex.build(corpus, "hnsw8,lpq4", device="cpu",
                             _levels=ref.levels, **BUILD)
    assert any(not np.array_equal(a.numpy(), np.asarray(b))
               for a, b in zip(port.layers, ref.layers))


def test_levels_follow_the_key_on_every_device_b_t1():
    """B-T1: the port draws U from a CPU generator seeded by ``key`` and
    applies the reference's numpy floor(-ln U * mL)."""
    a, b, c = H.draw_levels(5000, 8, 0), H.draw_levels(5000, 8, 0), \
        H.draw_levels(5000, 8, 1)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.dtype == np.int32 and a.min() == 0 and a.max() >= 2
    # P(level >= 1) = 1/M
    assert abs((a >= 1).mean() - 1 / 8) < 0.02


@pytest.mark.parametrize("f", ["hnsw8,lpq8@gaussian:3", "hnsw8"])
def test_own_build_recall_and_memory(built, data, recall_queries, f):
    """On the port's own levels (seed 0, not the reference's draw): recall
    at ef_search 80 over 300 queries (about 0.80-0.83 here; three seeds of
    either package spread by under 0.01)."""
    corpus, _ = data
    queries, gt = recall_queries
    ref, _, _ = built[f]
    port = make_index(f, corpus, device="cpu", **BUILD)
    r_rec = r_recall(gt, ref.search(queries, K, ef_search=80).ids)
    t_rec = recall_at_k(torch.from_numpy(gt),
                        port.search(queries, K, ef_search=80).ids)
    assert abs(t_rec - r_rec) <= 0.02, (t_rec, r_rec)
    # the reference's formula: store + 4 bytes a pointer of every layer
    m = 8
    store = N * D + 3 * D * 4 if "lpq8" in f else N * D * 4
    graph = N * 2 * m * 4 + (len(port.layers) - 1) * N * m * 4
    assert port.memory_bytes() == store + graph
    assert port.build_seconds > 0


def test_unported_parts_raise_naming_their_roadmap_item(built, data):
    corpus, queries = data
    _, port, path = built["hnsw8,lpq8@gaussian:3"]
    # per-cell constants (A11) now build, search and round-trip
    rg = make_index("hnsw8,lpq8,regions", corpus[:300], device="cpu", **BUILD)
    assert rg.regions is not None and rg.regions.n_regions == 17
    res = rg.search(queries[:3], K, ef_search=40)
    assert res.ids.shape == (3, K) and res.stats["regional"] is True
    with pytest.raises(ValueError, match="regions"):
        port.region_drift(corpus)
    rg_path = path.parent / "regions.npz"
    rg.save(rg_path)
    arrays, meta = load_state(rg_path)
    back = H.HNSWIndex.from_state(arrays, meta, device="cpu")
    assert "rg_regions" in meta and back.regions is not None
    assert torch.equal(back.search(queries[:3], K, ef_search=40).ids, res.ids)
    st = make_index("stream(hnsw8,lpq8)", corpus[:300], device="cpu",
                    **BUILD)
    assert st.kind == "stream" and st.manifest.segments[0].index.kind == "hnsw"
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


def test_hnsw_runs_on_the_card_unless_cpu_is_asked(data, monkeypatch):
    corpus, _ = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_index("hnsw8,lpq8", corpus[:200])
