"""The port's filter module (``repro_torch.filter``) against the reference's
``repro.filter``: the bitmap constructors, the boolean algebra,
``aligned``, the content digest and ``overfetch``, plus the pad-sentinel
contract of filtered search on every ported kind."""

import numpy as np
import pytest

from repro.filter import Filter as RFilter
from repro.filter import overfetch as r_overfetch
from repro_torch.filter import Filter, overfetch
from repro_torch.knn import SearchParams, make_index

NEG = float(np.finfo(np.float32).min)

#: (seed, n, selectivity) bitmaps the algebra is held on
CASES = [(0, 1, 0.5), (1, 7, 0.0), (2, 64, 1.0), (3, 97, 0.25),
         (4, 512, 0.02), (5, 1000, 0.9), (6, 4097, 0.5)]


def _mask(seed: int, n: int, sel: float) -> np.ndarray:
    return np.random.default_rng(seed).random(n) < sel


def _same(port: Filter, ref) -> None:
    np.testing.assert_array_equal(port.mask, np.asarray(ref.mask))
    assert port.digest == ref.digest
    assert (port.n, port.count) == (ref.n, ref.count)
    assert port.selectivity == ref.selectivity
    np.testing.assert_array_equal(port.ids(), ref.ids())


@pytest.mark.parametrize("seed,n,sel", CASES)
def test_bitmap_and_digest_match_the_reference(seed, n, sel):
    m = _mask(seed, n, sel)
    f, r = Filter.from_mask(m), RFilter.from_mask(m)
    _same(f, r)
    assert not f.mask.flags.writeable
    _same(Filter.from_ids(f.ids(), n), RFilter.from_ids(r.ids(), n))
    assert Filter.from_ids(f.ids(), n) == f
    assert hash(Filter.from_ids(f.ids(), n)) == hash(f)
    assert repr(f) == repr(r)


@pytest.mark.parametrize("seed,n,sel", CASES)
def test_algebra_and_aligned_match_the_reference(seed, n, sel):
    ma, mb = _mask(seed, n, sel), _mask(seed + 100, n, 1.0 - sel)
    fa, fb = Filter.from_mask(ma), Filter.from_mask(mb)
    ra, rb = RFilter.from_mask(ma), RFilter.from_mask(mb)
    _same(fa & fb, ra & rb)
    _same(fa | fb, ra | rb)
    _same(~fa, ~ra)
    for m in (1, max(1, n // 2), n, n + 5, 2 * n + 3):
        np.testing.assert_array_equal(fa.aligned(m), np.asarray(ra.aligned(m)))


def test_column_and_predicate_constructors_match_the_reference():
    col = np.random.default_rng(3).integers(0, 5, 300)
    prices = np.random.default_rng(4).random(300) * 50
    for value in (1, {0, 2}, [3, 4], (1,), np.array([2, 4])):
        _same(Filter.from_column(col, value), RFilter.from_column(col, value))
    _same(Filter.from_predicate(prices, lambda p: p < 30.0, 300),
          RFilter.from_predicate(prices, lambda p: p < 30.0, 300))
    assert Filter.from_column(col, 1) == Filter.from_column(col, [1])


@pytest.mark.parametrize("call,match", [
    (lambda F: F.from_ids([0, 9], 5), "filter ids must lie"),
    (lambda F: F.from_ids([-1], 5), "filter ids must lie"),
    (lambda F: F.from_mask(np.ones((2, 2), bool)), "must be 1-D"),
    (lambda F: F.from_column(np.ones((2, 2)), 1), "must be 1-D"),
    (lambda F: F.from_predicate(np.arange(4), lambda c: c[:2] > 0),
     "one bool per row"),
    (lambda F: F.from_predicate(np.arange(4), lambda c: c > 0, 5),
     "covers 4 rows"),
    (lambda F: F.from_mask(np.ones(4, bool)) & F.from_mask(np.ones(5, bool)),
     "compose"),
])
def test_refusals_match_the_reference(call, match):
    for F in (Filter, RFilter):
        with pytest.raises(ValueError, match=match):
            call(F)


#: (k, selectivity, n) with k <= n, where both packages must agree
OVERFETCH = [(k, sel, n) for k in (1, 5, 10, 64, 100)
             for sel in (0.0, 1e-12, 0.001, 0.02, 0.25, 0.5, 0.9, 0.999, 1.0,
                         1.5)
             for n in (1, 7, 100, 408, 5008, 10 ** 6) if k <= n]


def test_overfetch_equals_the_reference_where_k_fits():
    for k, sel, n in OVERFETCH:
        assert overfetch(k, sel, n) == r_overfetch(k, sel, n), (k, sel, n)
    assert overfetch(100, 0.25, 10 ** 6) == 408
    assert overfetch(100, 0.02, 10 ** 6) == 5008


@pytest.mark.parametrize("k,sel,n", [(10, 0.0, 5), (64, 0.5, 3),
                                     (100, 0.25, 99), (2, 0.001, 1)])
def test_overfetch_clamps_to_n_where_the_reference_does_not_c1(k, sel, n):
    """ROADMAP C1: the reference returns ``max(k, min(want, n))``
    (``src/repro/filter/filter.py:208``), which is k > n here, against its
    docstring ("clamped to the corpus").  The port follows the docstring:
    ``min(n, max(k, ceil(k/sel) + 8))``; these cases are left out of the
    parity test above and pinned here."""
    assert overfetch(k, sel, n) == n
    assert r_overfetch(k, sel, n) == k > n


def test_overfetch_meets_the_reference_bounds_test():
    """The properties of the reference's ``test_overfetch_bounds`` (which
    its own ``overfetch`` fails at k > n, C1) hold for the port's."""
    rng = np.random.default_rng(0)
    for _ in range(500):
        k = int(rng.integers(1, 65))
        sel = float(rng.random()) if rng.random() < 0.9 else 0.0
        n = int(rng.integers(1, 100001))
        of = overfetch(k, sel, n)
        assert k <= of + max(0, k - n)
        assert min(k, n) <= of <= max(n, k)
        if sel > 0:
            assert of >= min(n, int(np.ceil(k / max(sel, 1e-9))))
        assert overfetch(k, 0.0, n) == n


def test_filter_rides_search_params():
    a = SearchParams(filter=Filter.from_ids([1, 2], 10))
    b = SearchParams(filter=Filter.from_ids([1, 2], 10))
    c = SearchParams(filter=Filter.from_ids([1, 3], 10))
    assert hash(a) == hash(b) and a == b and a != c
    assert a.validate() is a
    for bad in ("not a filter", RFilter.from_ids([1], 10), object()):
        with pytest.raises(ValueError, match="SearchParams.filter must be"):
            SearchParams(filter=bad).validate()


N, D, K = 200, 16, 10


@pytest.fixture(scope="module")
def corpus_queries():
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((N, D)).astype(np.float32) * 0.1
    queries = rng.standard_normal((6, D)).astype(np.float32) * 0.1
    return corpus, queries


@pytest.mark.parametrize("factory", [
    "flat", "flat,lpq4", "flat,lpq8+r32", "pq8+lpq", "pq8x4,lpq8", "pq8",
    "ivf8,lpq8", "hnsw8,lpq8", "graph8,lpq8", "stream(flat,lpq8)",
    "stream(flat,lpq4)+r32"])
def test_survivors_below_k_pad_with_the_sentinel(factory, corpus_queries):
    """Fewer allowed rows than k: exactly the allowed ids come back, and
    the tail is (float32 min, -1); an all-allowed filter equals no filter
    bit for bit; an all-denied one returns only sentinels."""
    corpus, queries = corpus_queries
    idx = make_index(factory, corpus, device="cpu", kmeans_iters=2,
                     ef_construction=40, seal_threshold=64)
    keep = np.array([3, 17, 42])
    res = idx.search(queries, K, SearchParams(
        filter=Filter.from_ids(keep, N), nprobe=8, ef_search=N))
    ids, scores = res.ids.numpy(), res.scores.numpy()
    width = (ids >= 0).sum(1)
    if factory.startswith("graph"):
        # the graph kind's walk, like the reference's, need not reach
        # every row of a 200-row graph and can hold a row twice when two
        # entry seeds reach it: held on allowed ids only
        assert all(set(r[r >= 0].tolist()) <= set(keep.tolist())
                   for r in ids)
    else:
        assert all(sorted(r[r >= 0].tolist()) == keep.tolist() for r in ids)
        assert (width == len(keep)).all()
    for r in range(ids.shape[0]):
        assert (ids[r, width[r]:] == -1).all()
        assert (scores[r, width[r]:] == NEG).all()
    assert res.stats["filter_selectivity"] == round(3 / N, 6)
    sp = SearchParams(nprobe=8)
    plain = idx.search(queries, K, sp)
    allf = idx.search(queries, K, SearchParams(
        nprobe=8, filter=Filter.from_mask(np.ones(N, bool))))
    assert np.array_equal(plain.ids.numpy(), allf.ids.numpy())
    assert np.array_equal(plain.scores.numpy(), allf.scores.numpy())
    none = idx.search(queries, K, SearchParams(
        nprobe=8, filter=Filter.from_mask(np.zeros(N, bool))))
    assert (none.ids.numpy() == -1).all()
    assert (none.scores.numpy() == NEG).all()
