"""The port's IVF index (``repro_torch.knn.ivf.IVFIndex``) against the
reference's on identical inputs.

* Search parity on indexes the reference built and saved and the port
  loaded: the integer arms (int8 ip / l2 / angular, packed int4, int8 with
  an fp32 rerank tail) give bit-equal ids, scores and stats, one-shot and
  through a bucketed ``Searcher``.  The fp32 arm: recall@10 within 0.01 of
  the reference's and each returned id's score within rtol 1e-6.
* Build parity: given the reference's centroids (``_given``, I-T1) the
  lists are the reference's.  On the port's own k-means draw recall is
  held statistically and memory is the reference's formula.
* One test for each trap: I-T1 (first-maximum assignment, ascending lists,
  128-row padding), I-T2 (the probe ranks by the user's metric, nprobe
  clamped), I-T3 (candidate slot order decides integer ties; pad slots
  gathered as row 0 and masked), I-T4 (fine scoring in query blocks), I-T5
  (stats); npz both ways; the parts not ported yet raise naming their
  ROADMAP item.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import distances as RD  # noqa: E402
from repro.core.preserve import recall_at_k as r_recall  # noqa: E402
from repro.knn import SearchParams as RParams  # noqa: E402
from repro.knn import load_index as r_load  # noqa: E402
from repro.knn import make_index as r_make  # noqa: E402
from repro.tune import table as tunetable  # noqa: E402
from repro_torch import convert, engine  # noqa: E402
from repro_torch.core.preserve import recall_at_k  # noqa: E402
from repro_torch.knn import SearchParams, load_index, make_index  # noqa: E402
from repro_torch.knn import ivf as IV  # noqa: E402
from repro_torch.knn.base import load_state  # noqa: E402

N, D, NQ, K = 3000, 32, 21, 10
INT_ARMS = ["ivf16,lpq8@gaussian:3", "ivf16,lpq8,l2",
            "ivf16,lpq8@global_absmax,angular", "ivf16,lpq4",
            "ivf16,lpq8+r32"]


@pytest.fixture(autouse=True)
def _no_tune_table():
    with tunetable.pinned(None):
        yield


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(31)
    corpus = rng.standard_normal((N, D)).astype(np.float32)
    queries = rng.standard_normal((NQ, D)).astype(np.float32)
    return corpus, queries


@pytest.fixture(scope="module")
def recall_queries(data):
    corpus, _ = data
    q = np.random.default_rng(32).standard_normal((300, D)).astype(np.float32)
    return q, np.array(r_make("flat", corpus).search(q, K).ids)


@pytest.fixture(scope="module")
def built(data, tmp_path_factory):
    """Each arm built once by the reference, saved, and loaded by the port."""
    corpus, _ = data
    out = {}
    for f in INT_ARMS + ["ivf16"]:
        ref = r_make(f, corpus)
        path = tmp_path_factory.mktemp("ivf") / "ref.npz"
        ref.save(str(path))
        out[f] = (ref, load_index(path, device="cpu"), path)
    return out


def _same(got, want):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    assert got.stats == want.stats


def _same_rerank(got, want):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6)
    assert got.stats == want.stats


def _check(f):
    return _same_rerank if f.endswith("+r32") else _same


# --------------------------------------------------------------------------
# search parity on reference-built indexes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("f", INT_ARMS)
@pytest.mark.parametrize("nprobe", [2, 8])
def test_search_bit_equal_on_reference_lists(built, data, f, nprobe):
    _, queries = data
    ref, port, _ = built[f]
    _check(f)(port.search(queries, K, nprobe=nprobe),
              ref.search(queries, K, nprobe=nprobe))
    if f.endswith("+r32"):
        _same(port.plan(4 * K, SearchParams(nprobe=nprobe))(queries),
              ref.plan(4 * K, RParams(nprobe=nprobe))(jnp.asarray(queries)))


@pytest.mark.parametrize("f", INT_ARMS)
def test_bucketed_searcher_bit_equal_on_reference_lists(built, data, f):
    """21 queries in buckets (8, 16): a full 16-slice and a padded 8."""
    _, queries = data
    ref, port, _ = built[f]
    want = ref.searcher(K, RParams(nprobe=4), batch_sizes=(8, 16))(queries)
    got = port.searcher(K, SearchParams(nprobe=4),
                        batch_sizes=(8, 16))(queries)
    _check(f)(got, want)
    assert got.stats["padded_q"] == 3 and got.stats["bucket"] == 8


def test_fp32_arm_within_tolerance_on_the_same_lists(built, recall_queries):
    queries, gt = recall_queries
    ref, port, _ = built["ivf16"]
    want = ref.search(queries, K, nprobe=4)
    got = port.search(queries, K, nprobe=4)
    r_rec = r_recall(gt, want.ids)
    t_rec = recall_at_k(torch.from_numpy(gt), got.ids)
    assert abs(t_rec - r_rec) <= 0.01, (t_rec, r_rec)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6)
    assert got.stats == want.stats


# --------------------------------------------------------------------------
# build parity and the traps
# --------------------------------------------------------------------------

@pytest.mark.parametrize("f", INT_ARMS + ["ivf16"])
def test_build_on_reference_centroids_equals_reference_lists_i_t1(built, data,
                                                                  f):
    """I-T1: given the reference's centroids the assignment (f32 negated
    L2, first maximum) and the lists (ascending ids, padded with -1 to a
    multiple of 128) are the reference's."""
    corpus, queries = data
    ref, _, _ = built[f]
    port = IV.IVFIndex.build(corpus, f, device="cpu",
                             _given={"centroids": np.asarray(ref.centroids)})
    np.testing.assert_array_equal(port.lists.numpy(), np.asarray(ref.lists))
    assert port.max_list == ref.max_list and port.max_list % 128 == 0
    assert port.list_sizes() == ref.list_sizes()
    assert port.memory_bytes() == ref.memory_bytes()
    assert set(port.build_parts) == {"kmeans", "lists", "store"}
    if "lpq" in f and not f.endswith("+r32"):
        _same(port.search(queries, K, nprobe=4), ref.search(queries, K,
                                                            nprobe=4))


def test_assignment_takes_the_first_maximum_and_lists_ascend_i_t1():
    """Twin centroids: every row nearest the pair goes to the first one
    (the reference's ``argmax`` of ``l2_scores``); list members ascend, as
    the reference's ``np.where`` per list; pads are -1; ``max_list`` is the
    longest list rounded up to 128."""
    rng = np.random.default_rng(3)
    corpus = rng.standard_normal((500, 8)).astype(np.float32)
    cents = corpus[[3, 3, 77, 200]]
    port = IV.IVFIndex.build(corpus, "ivf4,lpq8,l2", device="cpu",
                             _given={"centroids": cents})
    assign = np.asarray(jnp.argmax(RD.l2_scores(jnp.asarray(corpus),
                                                jnp.asarray(cents)), -1))
    buckets = [np.where(assign == c)[0] for c in range(4)]
    width = -(-max(len(b) for b in buckets) // 128) * 128
    want = np.full((4, width), -1, np.int32)
    for c, b in enumerate(buckets):
        want[c, : len(b)] = b
    np.testing.assert_array_equal(port.lists.numpy(), want)
    assert port.list_sizes()[1] == 0 and port.list_sizes()[0] > 0
    assert port.max_list == width and sum(port.list_sizes()) == 500
    np.testing.assert_array_equal(
        IV.bucket_lists(np.array([2, 0, 2, 1, 0]), 4),
        np.concatenate([[[1, 4], [3, -1], [0, 2], [-1, -1]],
                        np.full((4, 126), -1)], 1))


def test_probe_ranks_by_the_user_metric_and_clamps_nprobe_i_t2(built, data):
    """I-T2: the coarse probe is ``engine.topk`` over the centroids in the
    index's own metric (ip here), not l2; nprobe past nlist clamps."""
    _, queries = data
    ref, port, _ = built["ivf16,lpq8@gaussian:3"]
    c = port.centroids.numpy().astype(np.float64)
    q = queries.astype(np.float64)
    by_ip = np.argsort(-(q @ c.T), 1, kind="stable")[:, :1]
    by_l2 = np.argsort(((q[:, None] - c[None]) ** 2).sum(-1), 1,
                       kind="stable")[:, :1]
    assert (by_ip != by_l2).any()
    got = port.search(queries, K, nprobe=1)
    lists = port.lists.numpy()
    for j in range(NQ):
        assert set(got.ids[j].tolist()) <= set(lists[by_ip[j, 0]].tolist())
    big = port.search(queries, K, nprobe=999)
    assert big.stats["nprobe"] == 16 and big.stats["chunks"] == 16
    _same(big, ref.search(queries, K, nprobe=999))


def test_candidate_slot_order_decides_integer_ties_i_t3(built, data):
    """I-T3: int4 scores tie often; ``topk_among`` keeps the earlier slot
    (probe order, then list order).  Reordering the candidates by id gives
    the same scores but other ids, so the port keeps the reference's
    order."""
    _, queries = data
    ref, port, _ = built["ivf16,lpq4"]
    want = ref.search(queries, K, nprobe=8)
    _same(port.search(queries, K, nprobe=8), want)
    qf = torch.from_numpy(queries)
    _, probe, _ = engine.topk(qf, engine.CodeStore.dense(port.centroids), 8,
                              "ip")
    cand = port.lists[probe.long()].reshape(NQ, -1)
    s, i = engine.topk_among(port.prepare_queries(qf), port.store, cand, K,
                             "ip")
    np.testing.assert_array_equal(i.numpy(), np.asarray(want.ids))
    by_id = torch.sort(torch.where(cand < 0, N, cand), 1).values
    by_id = torch.where(by_id == N, -1, by_id)
    s2, i2 = engine.topk_among(port.prepare_queries(qf), port.store, by_id, K,
                               "ip")
    assert torch.equal(s2, s) and not torch.equal(i2, i)


def test_pad_slots_are_masked_and_short_results_pad_i_t3(built, data):
    """I-T3: pad slots are gathered (as row 0) and masked; with k past the
    members of one probed list the tail is (float32 min, -1) as the
    reference's."""
    _, queries = data
    ref, port, _ = built["ivf16,lpq8,l2"]
    k = port.max_list
    got = port.search(queries, k, nprobe=1)
    _same(got, ref.search(queries, k, nprobe=1))
    assert (got.ids == -1).any() and not (got.ids[:, 0] == -1).any()
    assert bool(((got.ids == -1) == (got.scores == engine.NEG)).all())


def test_fine_scoring_in_query_blocks_equals_one_block_i_t4(built, data,
                                                            monkeypatch):
    """I-T4: fine scoring in blocks of 3 queries gives the one-block
    result; a block's bytes are the gathered rows with room for a float64
    copy each."""
    _, queries = data
    ref, port, _ = built["ivf16,lpq8@gaussian:3"]
    width = 4 * port.max_list
    monkeypatch.setattr(IV, "FINE_BYTES", 3 * width * D * 9)
    assert IV.fine_block_rows(port.store, width) == 3
    _same(port.search(queries, K, nprobe=4), ref.search(queries, K, nprobe=4))
    _, port4, _ = built["ivf16,lpq4"]
    _same(port4.search(queries, K, nprobe=4),
          built["ivf16,lpq4"][0].search(queries, K, nprobe=4))


def test_stats_i_t5(built, data):
    _, queries = data
    _, port, _ = built["ivf16,lpq4"]
    st = port.search(queries, K, nprobe=4).stats
    w = 4 * port.max_list
    assert st["kind"] == "ivf" and st["nprobe"] == 4 and st["chunks"] == 4
    assert st["candidates"] == w
    assert st["bytes_read"] == NQ * w * port.store.row_bytes
    assert st["bits"] == 4 and st["packed"] is True


def test_own_kmeans_draw_is_held_statistically(built, data, recall_queries):
    """The port's k-means draws from a torch generator, not ``jax.random``:
    recall@10 at nprobe 4 over 300 queries within 0.01 (fp32) / 0.02
    (int8) of the reference's, memory its formula."""
    corpus, _ = data
    queries, gt = recall_queries
    for f, tol in (("ivf16", 0.01), ("ivf16,lpq8@gaussian:3", 0.02)):
        ref, _, _ = built[f]
        port = make_index(f, corpus, device="cpu")
        assert not np.allclose(port.centroids.numpy(),
                               np.asarray(ref.centroids))
        r_rec = r_recall(gt, ref.search(queries, K, nprobe=4).ids)
        t_rec = recall_at_k(torch.from_numpy(gt),
                            port.search(queries, K, nprobe=4).ids)
        assert abs(t_rec - r_rec) <= tol, (f, t_rec, r_rec)
        store = N * D + 3 * D * 4 if port.quantized else N * D * 4
        assert port.memory_bytes() == (store + 16 * D * 4
                                       + 16 * port.max_list * 4)


# --------------------------------------------------------------------------
# persistence, raises, device
# --------------------------------------------------------------------------

def test_port_saved_ivf_searches_the_same_in_the_reference(built, data,
                                                           tmp_path):
    corpus, queries = data
    port = make_index("ivf16,lpq4", corpus, device="cpu")
    path = tmp_path / "port.npz"
    port.save(path)
    ref = r_load(str(path))
    _same(port.search(queries, K, nprobe=4), ref.search(queries, K, nprobe=4))
    assert ref.max_list == port.max_list and ref.nlist == port.nlist
    ref_idx, loaded, ref_path = built["ivf16,lpq8+r32"]
    arrays, meta = load_state(ref_path)
    conv = convert.ivf_from_reference_state(arrays, meta, device="cpu")
    _same(conv.search(queries, K, nprobe=4), loaded.search(queries, K,
                                                           nprobe=4))
    assert conv.memory_bytes() == loaded.memory_bytes() == ref_idx.memory_bytes()


def test_unported_parts_raise_naming_their_roadmap_item(built, data):
    corpus, _ = data
    _, port, path = built["ivf16,lpq8@gaussian:3"]
    # per-list constants (A11) now build, search and round-trip
    rg = make_index("ivf16,lpq8,regions", corpus, device="cpu")
    assert rg.regions is not None and rg.regions.n_regions == 16
    res = rg.search(corpus[:3], K, nprobe=4)
    assert res.ids.shape == (3, K) and res.stats["regional"] is True
    with pytest.raises(ValueError, match="regions"):
        port.region_drift(corpus)
    rg_path = path.parent / "regions.npz"
    rg.save(rg_path)
    arrays, meta = load_state(rg_path)
    back = IV.IVFIndex.from_state(arrays, meta, device="cpu")
    assert "rg_regions" in meta and back.regions is not None
    assert torch.equal(back.search(corpus[:3], K, nprobe=4).ids, res.ids)
    # the mesh plans run: lists placement, equal to unsharded
    from repro_torch.dist import Placement, make_mesh

    mesh = make_mesh((2,), ("data",), ["cpu"] * 2)
    assert port.placement(2).kind == "lists"
    q = corpus[:5]
    un, sh = port.searcher(K)(q), port.searcher(K, shards=mesh)(q)
    assert torch.equal(un.ids, sh.ids) and torch.equal(un.scores, sh.scores)
    assert sh.stats["shards"] == 2 and sh.stats["placement"] == "lists"
    with pytest.raises(ValueError, match="place whole lists"):
        port.plan(K, mesh=mesh, placement=Placement.rows(port.n, 2))
    with pytest.raises(ValueError, match="SearchParams.filter must be"):
        port.searcher(K, SearchParams(filter=object()))
    with pytest.raises(ValueError, match="SearchParams.filter must be"):
        port.plan(K, SearchParams(filter=object()))


def test_ivf_runs_on_the_card_unless_cpu_is_asked(data, monkeypatch):
    corpus, _ = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_index("ivf8,lpq8", corpus[:200])


def test_quant_params_from_numpy_defaults_to_the_card(monkeypatch):
    """``convert.quant_params_from_numpy`` resolves ``device=None`` to the
    card, as every other converter does: without one it raises."""
    lo, hi, zero = (np.full(4, v, np.float32) for v in (-1.0, 1.0, 0.0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.quant_params_from_numpy(lo, hi, zero, 8, "gaussian")
    p = convert.quant_params_from_numpy(lo, hi, zero, 8, "gaussian",
                                        device="cpu")
    assert p.lo.device.type == "cpu" and p.bits == 8
