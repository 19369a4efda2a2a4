"""The port's graph walk (``repro_torch.knn.graph``) against the
reference's (``repro.knn.graph``) on the same int8 codes and adjacency.

Integer scores are exact, so ids and scores must be bit-equal: the batched
walk, the one-query walk and the greedy descent, over a reference-built
HNSW graph and over hand-built graphs for the walk's traps:

* T1 the visited scatter is an OR: a ``-1`` pad (clipped to node 0, not
  fresh) must not clear node 0's mark;
* T2 an id listed twice in one adjacency row is scored twice and can sit
  in the beam twice (fresh is computed before the visited update);
* T3 ties: the expand pick takes the first maximum and the beam keeps the
  lowest position first, as ``jnp.argmax`` and ``lax.top_k`` do;
* T4 entry sets: more entries than ef, ``-1`` entries, and the
  ``max_iters`` cap.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import engine as r_engine  # noqa: E402
from repro.core import quant as r_quant  # noqa: E402
from repro.knn import graph as RG  # noqa: E402
from repro.knn import make_index as r_make  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.engine import CodeStore  # noqa: E402
from repro_torch.knn import graph as G  # noqa: E402

N, D, NQ = 1500, 32, 24


def _stores(codes: np.ndarray):
    """The same int8 codes as a reference and a port CodeStore."""
    d = codes.shape[1]
    lo, hi, zero = (np.full(d, v, np.float32) for v in (-1.0, 1.0, 0.0))
    rp = r_quant.QuantParams(lo=jnp.asarray(lo), hi=jnp.asarray(hi),
                             zero=jnp.asarray(zero), bits=8, scheme="gaussian")
    tp = convert.quant_params_from_numpy(lo, hi, zero, 8, "gaussian",
                                         device="cpu")
    return (r_engine.CodeStore.from_codes(jnp.asarray(codes), rp),
            CodeStore.from_codes(torch.from_numpy(codes), tp))


def _equal(got, want):
    (gs, gi), (ws, wi) = got, want
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


@pytest.fixture(scope="module")
def walk():
    """A reference-built HNSW graph over int8 codes, its layers on both
    sides, and encoded queries."""
    rng = np.random.default_rng(3)
    corpus = rng.standard_normal((N, D)).astype(np.float32)
    queries = rng.standard_normal((NQ, D)).astype(np.float32)
    ref = r_make("hnsw8,lpq8@gaussian:3", corpus, ef_construction=40,
                 batch_size=128)
    arrays, meta = ref.store.state()
    port_store = CodeStore.from_state(
        {k: np.asarray(v) for k, v in arrays.items()}, meta, device="cpu")
    return {
        "ref_store": ref.store, "store": port_store,
        "r_q": ref.store.encode_queries(jnp.asarray(queries)),
        "q": port_store.encode_queries(torch.from_numpy(queries)),
        "r_layers": ref.layers,
        "layers": [torch.from_numpy(np.array(a)) for a in ref.layers],
        "entry": ref.entry,
    }


def _entries(kind: str, ef: int, rng) -> np.ndarray:
    if kind == "shared":
        return np.array([5], np.int32)
    if kind == "per_query":
        return rng.integers(0, N, (NQ, 1)).astype(np.int32)
    if kind == "more_than_ef":                   # T4: e > ef
        return rng.integers(0, N, (NQ, ef + 5)).astype(np.int32)
    e = rng.integers(0, N, (NQ, 4)).astype(np.int32)  # T4: -1 padded
    e[:, 1::2] = -1
    e[:3] = -1                                   # no valid entry at all
    return e


@pytest.mark.parametrize("ef", [1, 7, 32])
@pytest.mark.parametrize("entries", ["shared", "per_query", "more_than_ef",
                                     "minus_one"])
def test_beam_search_batch_bit_equal_to_reference(walk, ef, entries):
    rng = np.random.default_rng(ef)
    e = _entries(entries, ef, rng)
    want = RG.beam_search_batch(
        walk["r_q"], walk["r_layers"][0], jnp.asarray(e),
        score_set=r_engine.make_score_set(walk["ref_store"], "ip"), ef=ef)
    got = G.beam_search_batch(
        walk["q"], walk["layers"][0], torch.from_numpy(e),
        engine.make_batch_score_set(walk["store"], "ip"), ef)
    _equal(got, want)


@pytest.mark.parametrize("metric", ["ip", "l2", "angular"])
def test_batched_walk_equals_the_one_query_walk(walk, metric):
    """Every query of a batch gets its one-query walk, with both the port's
    and the reference's one-query ``beam_search``."""
    e = np.random.default_rng(1).integers(0, N, (NQ, 2)).astype(np.int32)
    s, i = G.beam_search_batch(
        walk["q"], walk["layers"][0], torch.from_numpy(e),
        engine.make_batch_score_set(walk["store"], metric), 16)
    one = engine.make_score_set(walk["store"], metric)
    r_one = r_engine.make_score_set(walk["ref_store"], metric)
    for j in range(0, NQ, 3):
        got = G.beam_search(walk["q"][j], walk["layers"][0],
                            torch.from_numpy(e[j]), one, 16)
        _equal((s[j], i[j]), (got[0].numpy(), got[1].numpy()))
        want = RG.beam_search(walk["r_q"][j], walk["r_layers"][0],
                              jnp.asarray(e[j]), score_set=r_one, ef=16)
        _equal(got, want)


@pytest.mark.parametrize("max_iters", [1, 3, 40])
def test_walk_reaching_max_iters_t4(walk, max_iters):
    """T4: the cap stops the walk with unexpanded entries left (max_iters
    1 and 3 stop every query early; 40 < ef lets none converge)."""
    want = RG.beam_search_batch(
        walk["r_q"], walk["r_layers"][0], jnp.asarray([walk["entry"]]),
        score_set=r_engine.make_score_set(walk["ref_store"], "l2"), ef=64,
        max_iters=max_iters)
    before = dict(G.STEPS)
    got = G.beam_search_batch(
        walk["q"], walk["layers"][0], torch.tensor([walk["entry"]]),
        engine.make_batch_score_set(walk["store"], "l2"), 64, max_iters)
    _equal(got, want)
    assert G.STEPS["beam_iters"] - before["beam_iters"] == NQ * max_iters


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_greedy_descent_bit_equal_to_reference(walk, metric):
    """Every upper layer from the entry, batched and one query at a time."""
    r_set = r_engine.make_score_set(walk["ref_store"], metric)
    t_set = engine.make_batch_score_set(walk["store"], metric)
    one = engine.make_score_set(walk["store"], metric)
    assert len(walk["layers"]) > 2
    for l in range(len(walk["layers"]) - 1, 0, -1):
        adj_r, adj_t = walk["r_layers"][l], walk["layers"][l]
        # entries: the index's entry and nodes present on this layer
        on_layer = np.nonzero(np.asarray(adj_r)[:, 0] >= 0)[0]
        entry = np.resize(np.concatenate([[walk["entry"]], on_layer]), NQ)
        rn, rs = jax.vmap(lambda qq, ee: RG.greedy_descent(
            qq, adj_r, ee, r_set))(walk["r_q"], jnp.asarray(entry, jnp.int32))
        tn, ts = G.greedy_descent_batch(walk["q"], adj_t,
                                        torch.from_numpy(entry), t_set)
        _equal((ts, tn), (rs, rn))
        for j in (0, NQ - 1):
            n1, s1 = G.greedy_descent(walk["q"][j], adj_t, int(entry[j]), one)
            assert int(n1) == int(tn[j]) and float(s1) == float(ts[j])


def test_greedy_descent_stops_at_its_cap(walk):
    r_set = r_engine.make_score_set(walk["ref_store"], "ip")
    adj_r, adj_t = walk["r_layers"][0], walk["layers"][0]
    entry = np.zeros(NQ, np.int32)
    rn, rs = jax.vmap(lambda qq, ee: RG.greedy_descent(
        qq, adj_r, ee, r_set, max_iters=2))(walk["r_q"], jnp.asarray(entry))
    tn, ts = G.greedy_descent_batch(
        walk["q"], adj_t, torch.from_numpy(entry),
        engine.make_batch_score_set(walk["store"], "ip"), max_iters=2)
    _equal((ts, tn), (rs, rn))


# --------------------------------------------------------------------------
# hand-built graphs
# --------------------------------------------------------------------------

def _both(codes, adj, entries, ef, q, max_iters=None):
    r_store, t_store = _stores(codes)
    want = RG.beam_search_batch(
        jnp.asarray(q), jnp.asarray(adj), jnp.asarray(entries),
        score_set=r_engine.make_score_set(r_store, "ip"), ef=ef,
        max_iters=max_iters)
    got = G.beam_search_batch(
        torch.from_numpy(q), torch.from_numpy(adj), torch.from_numpy(entries),
        engine.make_batch_score_set(t_store, "ip"), ef, max_iters)
    _equal(got, want)
    return got


def test_visited_scatter_is_an_or_t1():
    """T1: node 0 is visited first (the entry); node 1's row then holds
    -1 pads (clipped to 0, not fresh) beside new ids, and node 3's row lists
    0 again.  A plain assignment of ``fresh`` would clear node 0's mark at
    the pads and score 0 a second time."""
    codes = np.array([[4, 0], [3, 0], [2, 1], [5, 1], [1, 1], [0, 3]], np.int8)
    adj = np.array([[1, -1, -1, 2],
                    [-1, 3, -1, -1],
                    [-1, -1, -1, -1],
                    [0, 4, -1, 5],
                    [-1, -1, -1, -1],
                    [-1, -1, -1, -1]], np.int32)
    q = np.array([[3, 1], [1, 2]], np.int8)
    s, i = _both(codes, adj, np.array([0], np.int32), 6, q)
    for row in i.numpy():
        ids = row[row >= 0]
        assert len(ids) == len(set(ids.tolist())) == 6


def test_duplicate_neighbours_are_kept_t2():
    """T2: fresh is computed before the visited scatter, so an id listed
    twice in one row is scored twice and both copies enter the beam."""
    codes = np.array([[1, 0], [4, 4], [2, 1], [0, 3]], np.int8)
    adj = np.array([[1, 1, 2, -1],
                    [0, -1, -1, -1],
                    [3, 3, 3, -1],
                    [-1, -1, -1, -1]], np.int32)
    q = np.array([[2, 1]], np.int8)
    s, i = _both(codes, adj, np.array([0], np.int32), 8, q)
    assert (i.numpy()[0] == 1).sum() == 2 and (i.numpy()[0] == 3).sum() == 3


def test_tied_scores_keep_the_reference_order_t3():
    """T3: many rows with one code tie on every query; the expand pick and
    the beam's cut must both keep the reference's first-position order."""
    rng = np.random.default_rng(7)
    codes = np.repeat(rng.integers(-3, 4, (5, 4)).astype(np.int8), 12, 0)
    n = codes.shape[0]
    adj = rng.integers(-1, n, (n, 6)).astype(np.int32)
    q = rng.integers(-3, 4, (6, 4)).astype(np.int8)
    entries = rng.integers(0, n, (6, 3)).astype(np.int32)
    for ef in (1, 4, 9, 30):
        _both(codes, adj, entries, ef, q)


def test_minus_one_entries_and_more_entries_than_ef_t4():
    """T4 on a hand-built graph: entries padded with -1 (one query has
    none), and more entries than ef with ties among them."""
    codes = np.array([[1, 1], [2, 0], [1, 1], [0, 2], [3, 3]], np.int8)
    adj = np.array([[1, 2], [3, -1], [4, 0], [-1, -1], [0, 1]], np.int32)
    q = np.array([[1, 0], [0, 1], [1, 1]], np.int8)
    entries = np.array([[-1, 2, -1], [-1, -1, -1], [3, -1, 0]], np.int32)
    s, i = _both(codes, adj, entries, 4, q)
    assert (i.numpy()[1] == -1).all()
    many = np.array([[0, 1, 2, 3, 4, 2], [4, 3, 2, 1, 0, -1],
                     [2, 2, 0, 0, -1, 4]], np.int32)
    for ef in (1, 2, 3):
        _both(codes, adj, many, ef, q)
