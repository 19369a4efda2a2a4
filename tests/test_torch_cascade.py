"""The port's cascade kind and per-region Eq. 1 constants
(``repro_torch.cascade``, ``engine.refine_among`` /
``topk_among_regional`` / ``regional_stats``) and the rest of ``core``
against the reference's, on identical inputs at ``tests/test_cascade.py``'s
sizes (N=384, D=32, the first third of the rows concentrated).

* Grammar and budgets: every check of ``tests/test_cascade.py:35-160``,
  run on both packages, with the same errors.
* Search parity on indexes the reference built and saved and the port
  loaded: integer heads and integer final stages bit-equal, ids, scores
  and stats; fp32 final stages and regional re-scores within rtol 1e-6
  of the row scale, ids equal outside near-ties (``fp32_near_equal``).
* ``RegionQuant``: the density scales and sigmas are the reference's
  numpy expressions, bit-equal; the per-region statistics are float sums
  in torch's order (rtol 1e-6, as ``core.stats``); given the reference's
  statistics (``_stats``) the constants are bit-equal, and given the same
  constants the codes are.
* Builds from the reference's draws (``_given``: centroids, levels, region
  constants) equal the reference's codes, lists / graphs and results.
* npz both ways, through ``load_index`` and ``convert``.
* The five A1 functions ``knn_recall``, ``order_agreement``,
  ``quantization_error``, ``pairwise_distance`` and ``qip_scores_packed``.
"""

import dataclasses
import io

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import engine as r_engine  # noqa: E402
from repro.cascade import RegionQuant as RRegionQuant  # noqa: E402
from repro.cascade import density_scales as r_density  # noqa: E402
from repro.core import distances as RD  # noqa: E402
from repro.core import pack as RPK  # noqa: E402
from repro.core import preserve as RPR  # noqa: E402
from repro.core import quant as RQ  # noqa: E402
from repro.knn import SearchParams as RParams  # noqa: E402
from repro.knn import load_index as r_load  # noqa: E402
from repro.knn import make_index as r_make  # noqa: E402
from repro.knn import parse_factory as r_parse  # noqa: E402
from repro_torch import convert, core, engine  # noqa: E402
from repro_torch.cascade import RegionQuant, density_scales  # noqa: E402
from repro_torch.core import stats as TS  # noqa: E402
from repro_torch.knn import SearchParams, load_index, make_index  # noqa: E402
from repro_torch.knn import parse_factory as t_parse  # noqa: E402
from repro_torch.knn import graph_index as GI  # noqa: E402
from repro_torch.knn import hnsw as H  # noqa: E402
from repro_torch.knn import ivf as IV  # noqa: E402
from repro_torch.knn.base import load_state  # noqa: E402
from repro_torch.testing import fp32_near_equal  # noqa: E402

K = 10
N, D = 384, 32
PARSERS = [pytest.param(r_parse, id="reference"),
           pytest.param(t_parse, id="port")]

#: cascades held against the reference: (factory, build overrides,
#: budgets, integer final stage)
CASCADES = {
    "cascade(pq16x4|lpq8|r32)": ({"kmeans_iters": 4}, (128, 32), False),
    "cascade(flat,lpq4|r32)": ({}, (64,), False),
    "cascade(flat,lpq4|lpq8)": ({}, (64,), True),
    "cascade(ivf8,lpq8|lpq8|r8)": ({"kmeans_iters": 4}, (96, 40), True),
}
#: regions arms: factory -> build overrides
REGIONS = {
    "ivf8,lpq8,regions": {"kmeans_iters": 4},
    "hnsw8,lpq8,regions": {"ef_construction": 40, "batch_size": 128},
    "graph16,lpq8,regions": {"n_seeds": 16},
}
REGION_SP = dict(nprobe=8, ef_search=40)


@pytest.fixture(scope="module")
def corpus_queries():
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((N, D)).astype(np.float32) * 0.05
    # density contrast: per-region constants differ from the global fit
    corpus[: N // 3] *= 0.2
    queries = rng.standard_normal((8, D)).astype(np.float32) * 0.05
    return corpus, queries


def _ref_and_port(f, corpus, over):
    ref = r_make(f, corpus, key=jax.random.PRNGKey(0), **over)
    buf = io.BytesIO()
    ref.save(buf)
    return ref, load_index(io.BytesIO(buf.getvalue()), device="cpu"), buf


@pytest.fixture(scope="module")
def cascades(corpus_queries):
    corpus, _ = corpus_queries
    return {f: _ref_and_port(f, corpus, over)
            for f, (over, _b, _i) in CASCADES.items()}


@pytest.fixture(scope="module")
def regional(corpus_queries):
    corpus, _ = corpus_queries
    return {f: _ref_and_port(f, corpus, over) for f, over in REGIONS.items()}


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _bit_equal(got, want, stats=True):
    np.testing.assert_array_equal(_np(got.ids), np.asarray(want.ids))
    np.testing.assert_array_equal(_np(got.scores), np.asarray(want.scores))
    if stats:
        assert got.stats == want.stats


def _near(got, want, stats=True):
    held, _ = fp32_near_equal(_np(got.scores), _np(got.ids),
                              np.asarray(want.scores), np.asarray(want.ids),
                              1e-6)
    assert held
    if stats:
        assert got.stats == want.stats


# --------------------------------------------------------------------------
# grammar (tests/test_cascade.py:35-72), both packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("parse", PARSERS)
def test_cascade_factory_round_trip(parse):
    for factory in ("cascade(pq16x4|lpq8|r32)", "cascade(flat,lpq4|r32)",
                    "cascade(ivf8,lpq8|lpq8|r8)"):
        spec = parse(factory)
        assert spec.kind == "cascade"
        assert parse(spec.to_factory()) == spec
        assert spec.to_factory() == r_parse(factory).to_factory()


@pytest.mark.parametrize("parse", PARSERS)
def test_regions_factory_round_trip(parse):
    for factory in ("ivf8,lpq8,regions", "hnsw8,lpq4,regions",
                    "graph16,lpq8@absmax,regions"):
        spec = parse(factory)
        assert spec.params.get("regions") is True
        assert parse(spec.to_factory()) == spec


@pytest.mark.parametrize("parse", PARSERS)
def test_cascade_needs_two_stages(parse):
    with pytest.raises(ValueError, match="stage"):
        parse("cascade(flat,lpq8)")


@pytest.mark.parametrize("parse", PARSERS)
def test_cascade_rejects_plus_r_suffix(parse):
    with pytest.raises(ValueError, match="cascade"):
        parse("cascade(flat,lpq4|lpq8)+r32")
    with pytest.raises(ValueError, match="final stage IS the rerank"):
        parse("cascade(flat,lpq4|r32)+r8")


@pytest.mark.parametrize("parse", PARSERS)
def test_regions_need_quant_fragment(parse):
    with pytest.raises(ValueError, match="lpq"):
        parse("ivf8,regions")


@pytest.mark.parametrize("parse", PARSERS)
def test_regions_rejected_for_unpartitioned_kinds(parse):
    for factory in ("flat,lpq8,regions", "pq16,regions"):
        with pytest.raises(ValueError):
            parse(factory)
    with pytest.raises(ValueError, match="partitioned"):
        dataclasses.replace(parse("flat,lpq8"), params={"regions": True})
    with pytest.raises(ValueError, match="partitioned"):
        dataclasses.replace(parse("pq16"),
                            params={**parse("pq16").params, "regions": True})


# --------------------------------------------------------------------------
# budgets and per-stage stats (tests/test_cascade.py:79-160), on the
# reference's index loaded by the port and on the port's own build
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def own_cascade(corpus_queries):
    corpus, _ = corpus_queries
    return make_index("cascade(pq16x4|lpq8|r32)", corpus, device="cpu",
                      kmeans_iters=4)


@pytest.mark.parametrize("which", ["reference", "port", "own"])
def test_non_monotone_budgets_raise_pointed_error(which, cascades,
                                                  own_cascade, corpus_queries):
    _, queries = corpus_queries
    ref, port, _ = cascades["cascade(pq16x4|lpq8|r32)"]
    idx, P = {"reference": (ref, RParams), "port": (port, SearchParams),
              "own": (own_cascade, SearchParams)}[which]
    with pytest.raises(ValueError, match="never invent them"):
        idx.search(queries, K, P(budgets=(32, 128)))
    with pytest.raises(ValueError, match="never invent them"):
        idx.search(queries, K, P(budgets=(64, K - 1)))
    with pytest.raises(ValueError, match="one fetch depth per"):
        idx.search(queries, K, P(budgets=(64,)))


def test_budget_errors_name_the_same_stage(cascades, corpus_queries):
    _, queries = corpus_queries
    ref, port, _ = cascades["cascade(pq16x4|lpq8|r32)"]
    for budgets in ((32, 128), (64, K - 1), (64,), (1, 2, 3)):
        with pytest.raises(ValueError) as want:
            ref.search(queries, K, RParams(budgets=budgets))
        with pytest.raises(ValueError) as got:
            port.search(queries, K, SearchParams(budgets=budgets))
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("which", ["port", "own"])
def test_per_stage_stats_ride_on_results(which, cascades, own_cascade,
                                         corpus_queries):
    _, queries = corpus_queries
    idx = (cascades["cascade(pq16x4|lpq8|r32)"][1] if which == "port"
           else own_cascade)
    res = idx.search(queries, K, SearchParams(budgets=(128, 32)))
    stages = res.stats["stages"]
    assert res.stats["kind"] == "cascade"
    assert res.stats["cascade_stages"] == 3 == len(stages)
    assert isinstance(stages, tuple) and all(isinstance(r, tuple)
                                             for r in stages)
    labels = [row[0] for row in stages]
    assert labels[0].startswith("head:") and labels[1:] == ["lpq8", "r32"]
    assert [row[1] for row in stages] == [128, 128, 32]
    assert [row[3] for row in stages] == [4, 8, 32]
    assert res.stats["bytes_read"] == sum(row[2] for row in stages)


@pytest.mark.parametrize("which", ["port", "own"])
def test_budgets_ride_in_searcher_plans(which, cascades, own_cascade,
                                        corpus_queries):
    _, queries = corpus_queries
    idx = (cascades["cascade(pq16x4|lpq8|r32)"][1] if which == "port"
           else own_cascade)
    sp = SearchParams(budgets=(128, 32))
    eager = idx.search(queries, K, sp)
    planned = idx.searcher(K, sp, batch_sizes=(4, 16))(queries)
    assert torch.equal(eager.ids, planned.ids)
    assert torch.equal(eager.scores, planned.scores)
    # without budgets the Searcher hands the cascade its rerank depth
    # (handles_rerank): final budget 4k, each earlier stage 4x wider
    res = idx.searcher(K, batch_sizes=(8,))(queries)
    assert [row[1] for row in res.stats["stages"]] == [160, 160, 40]
    assert res.stats["reranked"] == 40
    res = idx.searcher(K, batch_sizes=(8,), rerank=60)(queries)
    assert [row[1] for row in res.stats["stages"]] == [240, 240, 60]


def test_final_fp32_stage_at_full_depth_is_exact(corpus_queries):
    """cascade(...|r32) with the final budget n equals the exact fp32
    search: ids exactly, scores within the reference test's rtol 1e-5
    (the stage scores through the batched candidate product, the flat scan
    through the full matrix product), and bit-equal to the +r32 tail at
    depth n, the same body."""
    corpus, queries = corpus_queries
    exact = make_index("flat", corpus, device="cpu").search(queries, K)
    idx = make_index("cascade(flat,lpq4|r32)", corpus, device="cpu")
    res = idx.search(queries, K, SearchParams(budgets=(N,)))
    assert torch.equal(res.ids, exact.ids)
    np.testing.assert_allclose(res.scores.numpy(), exact.scores.numpy(),
                               rtol=1e-5)
    tail = make_index("flat,lpq4+r32", corpus, device="cpu").searcher(
        K, batch_sizes=None, strict=False, rerank=N)(queries)
    assert torch.equal(res.ids, tail.ids)
    assert torch.equal(res.scores, tail.scores)


@pytest.mark.parametrize("f", sorted(CASCADES))
def test_search_on_reference_cascades(f, cascades, corpus_queries):
    """Integer final stages bit-equal (ids, scores, stats, the stage rows
    included); fp32 final stages within rtol 1e-6; at explicit budgets and
    at the Searcher's derived ones."""
    _, queries = corpus_queries
    ref, port, _ = cascades[f]
    _over, budgets, integer = CASCADES[f]
    same = _bit_equal if integer else _near
    same(port.search(queries, K, SearchParams(budgets=budgets)),
         ref.search(queries, K, RParams(budgets=budgets)))
    same(port.search(queries, K), ref.search(queries, K))
    same(port.searcher(K, batch_sizes=(4, 16))(queries),
         ref.searcher(K, batch_sizes=(4, 16))(queries))
    assert port.memory_bytes() == ref.memory_bytes()
    assert port.stages == ref.stages and port.n == ref.n == N


def test_integer_head_and_stages_bit_equal(cascades, corpus_queries):
    """Every stage of an all-integer cascade, one at a time: the head's
    candidates, then each refine_among, ids and scores bit-equal."""
    _, queries = corpus_queries
    ref, port, _ = cascades["cascade(ivf8,lpq8|lpq8|r8)"]
    budgets = (96, 40)
    want = ref.head.search(queries, budgets[0], RParams())
    got = port.head.search(queries, budgets[0], SearchParams())
    _bit_equal(got, want)
    rids, tids = want.ids, got.ids
    for (rst, tst), out_k in zip(zip(ref.stage_stores, port.stage_stores),
                                 (budgets[1], K)):
        rs, rids, rstats = r_engine.refine_among(
            jnp.asarray(queries), rst, rids, out_k, "ip")
        ts, tids, tstats = engine.refine_among(
            torch.from_numpy(queries), tst, tids, out_k, "ip")
        np.testing.assert_array_equal(tids.numpy(), np.asarray(rids))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
        assert tstats == rstats


@pytest.mark.parametrize("f", ["cascade(pq16x4|lpq8|r32)",
                               "cascade(flat,lpq4|lpq8)"])
def test_cascade_npz_both_ways(f, cascades, corpus_queries, tmp_path):
    corpus, queries = corpus_queries
    ref, port, buf = cascades[f]
    budgets = CASCADES[f][1]
    sp, rsp = SearchParams(budgets=budgets), RParams(budgets=budgets)
    # the reference's npz through convert
    arrays, meta = load_state(io.BytesIO(buf.getvalue()))
    conv = convert.cascade_from_reference_state(arrays, meta, device="cpu")
    _bit_equal(conv.search(queries, K, sp), port.search(queries, K, sp))
    # the port's own build, saved, loads in both packages
    own = make_index(f, corpus, device="cpu", **CASCADES[f][0])
    path = tmp_path / "cascade.npz"
    own.save(path)
    back = load_index(path, device="cpu")
    assert back.stages == own.stages
    a, b = own.search(queries, K, sp), back.search(queries, K, sp)
    _bit_equal(b, a)
    r = r_load(str(path))
    assert r.stages == own.stages
    (_bit_equal if CASCADES[f][2] else _near)(a, r.search(queries, K, rsp))
    with np.load(path) as z, np.load(io.BytesIO(buf.getvalue())) as y:
        assert set(z.files) == set(y.files)


def test_stream_of_cascades_matches_the_reference(corpus_queries):
    """stream(cascade(flat,lpq8|r32)): a bulk load, then upserts that seal
    a second segment; each sealed segment is a cascade, and the merged
    fp32 result is the reference's within rtol 1e-6."""
    corpus, queries = corpus_queries
    f = "stream(cascade(flat,lpq8|r32))"
    ref = r_make(f, corpus[:200], seal_threshold=128,
                 key=jax.random.PRNGKey(0))
    port = make_index(f, corpus[:200], device="cpu", seal_threshold=128)
    ids = np.arange(200, N)
    ref.upsert(ids, corpus[200:])
    port.upsert(ids, corpus[200:])
    assert [s.index.kind for s in port.manifest.segments] == ["cascade"] * 2
    assert port.n == ref.n
    _near(port.search(queries, K), ref.search(queries, K), stats=False)


# --------------------------------------------------------------------------
# RegionQuant and density scales
# --------------------------------------------------------------------------

@pytest.mark.parametrize("counts", [[1000, 10, 0], [0, 0, 0], [7],
                                    [3, 300, 33, 0, 1, 64]])
def test_density_scales_equal_the_reference(counts):
    got, want = density_scales(np.array(counts)), r_density(np.array(counts))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if counts == [1000, 10, 0]:
        assert got[0] < 1.0 < got[1]
        assert (got >= 0.5).all() and (got <= 2.0).all()


def _fit_both(corpus, assign, R, bits, scheme, sigmas):
    ref = RRegionQuant.fit(corpus, assign, R, bits=bits, scheme=scheme,
                           sigmas=sigmas)
    port = RegionQuant.fit(corpus, assign, R, bits=bits, scheme=scheme,
                           sigmas=sigmas)
    return ref, port


@pytest.mark.parametrize("scheme,bits,sigmas", [
    ("gaussian", 8, 1.0), ("gaussian", 4, 3.0), ("minmax", 8, 1.0),
    ("absmax", 4, 1.0), ("global_minmax", 8, 1.0), ("uniform", 8, 2.0)])
def test_region_fit_and_encode(scheme, bits, sigmas, corpus_queries):
    """Given the same assignment: sigmas bit-equal; constants within rtol
    1e-6 from the rows and, given the reference's statistics, bit-equal
    (the pooled ``uniform`` scheme within rtol 1e-6: pooling over the
    dimensions is itself a float sum in each library's order); codes
    bit-equal given the same constants; dequant bit-equal."""
    corpus, _ = corpus_queries
    R = 6
    assign = np.random.default_rng(5).integers(0, R - 1, N).astype(np.int32)
    assign[: N // 3] = 0                    # a dense region; region 5 empty
    ref, port = _fit_both(corpus, assign, R, bits, scheme, sigmas)
    np.testing.assert_array_equal(port.sigmas.numpy(), np.asarray(ref.sigmas))
    np.testing.assert_array_equal(port.assign.numpy(), np.asarray(ref.assign))
    for f in ("lo", "hi", "zero"):
        a, b = getattr(port, f).numpy(), np.asarray(getattr(ref, f))
        live = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a), live)
        np.testing.assert_allclose(a[live], b[live], rtol=1e-6, atol=1e-8)
    r_stats = TS.DimStats(**{f: torch.from_numpy(np.array(getattr(
        ref.stats, f))) for f in TS.STATS_FIELDS})
    given = RegionQuant.fit(corpus, assign, R, bits=bits, scheme=scheme,
                            sigmas=sigmas, _stats=r_stats)
    for f in ("lo", "hi", "zero", "sigmas"):
        a, b = getattr(given, f).numpy(), np.asarray(getattr(ref, f))
        if scheme == "uniform" and f != "sigmas":
            np.testing.assert_allclose(a, b, rtol=1e-6)
        else:
            np.testing.assert_array_equal(a, b)
    for f in TS.STATS_FIELDS:
        np.testing.assert_allclose(getattr(port.stats, f).numpy(),
                                   np.asarray(getattr(ref.stats, f)),
                                   rtol=1e-5, atol=1e-9)
    # codes under the same constants
    same = RegionQuant.from_state(*ref.state(), device="cpu")
    codes = same.encode(corpus)
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(ref.encode(corpus)))
    np.testing.assert_array_equal(given.encode(corpus).numpy(), codes.numpy())
    rows = np.arange(0, N, 7)
    np.testing.assert_array_equal(
        same.dequant(codes[rows], torch.from_numpy(rows)).numpy(),
        np.asarray(ref.dequant(jnp.asarray(codes.numpy()[rows]),
                               jnp.asarray(rows))))
    np.testing.assert_array_equal(same.scale.numpy(), np.asarray(ref.scale))
    p, rp = same.region_params(1), ref.region_params(1)
    assert (p.bits, p.scheme) == (rp.bits, rp.scheme)
    np.testing.assert_array_equal(p.zero.numpy(), np.asarray(rp.zero))
    assert same.memory_bytes() == ref.memory_bytes()


def test_region_encode_rounds_half_to_even_in_the_reference_order():
    """2^B (x - zero) / span landing on m + 0.5 rounds to the even m."""
    x = ((np.arange(-300, 300, dtype=np.float32) + 0.5) / 256)[None, :]
    x = np.repeat(x, 2, axis=0)
    st = {"count": np.array([1.0, 1.0], np.float32)}
    for f in ("mean", "m2", "amax", "vmin", "vmax"):
        st[f] = np.zeros((2, 600), np.float32)
    arrays = {"rg_assign": np.array([0, 1], np.int32),
              "rg_lo": np.full((2, 600), -0.5, np.float32),
              "rg_hi": np.full((2, 600), 0.5, np.float32),
              "rg_zero": np.zeros((2, 600), np.float32),
              "rg_sigmas": np.ones(2, np.float32),
              **{f"rg_st_{f}": v for f, v in st.items()}}
    meta = {"rg_regions": {"n_regions": 2, "bits": 8, "scheme": "gaussian"}}
    want = np.asarray(RRegionQuant.from_state(arrays, meta).encode(x))
    got = RegionQuant.from_state(arrays, meta, device="cpu").encode(x)
    np.testing.assert_array_equal(got.numpy(), want)


def test_drift_report_and_npz_fragments(corpus_queries):
    corpus, _ = corpus_queries
    R = 5
    assign = np.arange(N, dtype=np.int32) % (R - 1)      # region 4 empty
    ref = RRegionQuant.fit(corpus, assign, R)
    port = RegionQuant.from_state(*ref.state(), device="cpu")
    shifted = corpus + 0.01
    for live, live_assign in ((corpus, assign), (shifted, assign),
                              (shifted, (assign + 1) % R)):
        want = ref.drift_report(live, live_assign)
        got = port.drift_report(live, live_assign)
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-6)
    assert np.isinf(got[4 if np.array_equal(live_assign, assign) else 0])
    a, m = port.state(prefix="rg_")
    ra, rm = ref.state(prefix="rg_")
    assert set(a) == set(ra) and m == rm
    for key in a:
        np.testing.assert_array_equal(a[key], ra[key])
        assert a[key].dtype == ra[key].dtype


# --------------------------------------------------------------------------
# regions through ivf, hnsw and graph
# --------------------------------------------------------------------------

@pytest.mark.parametrize("f", sorted(REGIONS))
def test_search_on_reference_region_builds(f, regional, corpus_queries):
    """The reference's regional index, loaded by the port: the regional
    re-score within rtol 1e-6, ids equal outside near-ties, the regional
    stats equal; filtered too; one-shot and bucketed."""
    from repro.filter import Filter as RFilter
    from repro_torch.filter import Filter

    _, queries = corpus_queries
    ref, port, _ = regional[f]
    assert port.regions is not None
    got = port.search(queries, K, SearchParams(**REGION_SP))
    want = ref.search(queries, K, RParams(**REGION_SP))
    _near(got, want)
    assert got.stats["regional"] is True
    _near(port.searcher(K, SearchParams(**REGION_SP), batch_sizes=(4, 16))(
        queries), ref.searcher(K, RParams(**REGION_SP),
                               batch_sizes=(4, 16))(queries))
    allow = np.random.default_rng(3).random(N) < 0.25
    _near(port.search(queries, K, SearchParams(
        **REGION_SP, filter=Filter.from_mask(allow))),
        ref.search(queries, K, RParams(**REGION_SP,
                                       filter=RFilter.from_mask(allow))))
    assert port.memory_bytes() == ref.memory_bytes()


@pytest.mark.parametrize("f", sorted(REGIONS))
def test_region_drift_and_npz_both_ways(f, regional, corpus_queries,
                                        tmp_path):
    corpus, queries = corpus_queries
    ref, port, buf = regional[f]
    # the reference's statistics against the port's of the same rows: 0 up
    # to the two reductions' rounding (the port's own build: exactly 0,
    # test_own_region_build_fits_on_its_own_assignment)
    dr = port.region_drift(corpus)
    finite = np.isfinite(dr)
    assert finite.any()
    np.testing.assert_array_equal(finite, np.isfinite(ref.region_drift(corpus)))
    np.testing.assert_allclose(dr[finite], 0.0, atol=1e-6)
    want = ref.region_drift(corpus + 0.5)
    got = port.region_drift(corpus + 0.5)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert (got[np.isfinite(got)] > 0).all()
    np.testing.assert_allclose(got[np.isfinite(got)],
                               want[np.isfinite(want)], rtol=1e-5)
    # the reference's npz through convert, and the port's npz back
    arrays, meta = load_state(io.BytesIO(buf.getvalue()))
    conv = {"ivf": convert.ivf_from_reference_state,
            "hnsw": convert.hnsw_from_reference_state,
            "graph": convert.graph_from_reference_state}[port.kind](
        arrays, meta, device="cpu")
    sp = SearchParams(**REGION_SP)
    a = port.search(queries, K, sp)
    _bit_equal(conv.search(queries, K, sp), a)
    path = tmp_path / "regions.npz"
    port.save(path)
    with np.load(path) as z, np.load(io.BytesIO(buf.getvalue())) as y:
        assert set(z.files) == set(y.files)
        for key in z.files:
            if key.startswith(("rg_", "rgs_")):
                np.testing.assert_array_equal(z[key], y[key], err_msg=key)
    _near(a, r_load(str(path)).search(queries, K, RParams(**REGION_SP)))


def _params(p):
    return convert.quant_params_from_numpy(
        *(np.asarray(v) for v in (p.lo, p.hi, p.zero)), p.bits, p.scheme,
        device="cpu")


def _regions_of(ref):
    arrays, meta = ref.regions.state()
    return RegionQuant.from_state(arrays, meta, device="cpu")


@pytest.mark.parametrize("f", sorted(REGIONS))
def test_build_from_reference_draws(f, regional, corpus_queries):
    """Given the reference's draws (k-means centroids or HNSW levels and
    cells, Eq. 1 constants, region constants) the port's build holds the
    reference's codes, structure and results."""
    corpus, queries = corpus_queries
    ref, _, _ = regional[f]
    spec = t_parse(f)
    spec = dataclasses.replace(spec, quant=spec.quant.with_params(
        _params(ref.store.params)))
    over = REGIONS[f]
    if spec.kind == "ivf":
        port = IV.IVFIndex.build(corpus, spec, device="cpu", _given={
            "centroids": np.asarray(ref.centroids),
            "regions": _regions_of(ref)}, **over)
        np.testing.assert_array_equal(port.lists.numpy(),
                                      np.asarray(ref.lists))
        assert set(port.build_parts) == {"kmeans", "lists", "regions",
                                         "store"}
    elif spec.kind == "hnsw":
        port = H.HNSWIndex.build(corpus, spec, device="cpu",
                                 _levels=ref.levels, _given={
                                     "region_centroids":
                                         np.asarray(ref.region_cents),
                                     "regions": _regions_of(ref)}, **over)
        for a, b in zip(port.layers, ref.layers):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert port.entry == ref.entry
        np.testing.assert_array_equal(port.region_store.data.numpy(),
                                      np.asarray(ref.region_store.data))
    else:
        port = GI.GraphIndex.build(corpus, spec, device="cpu", _given={
            "centroids": np.asarray(ref.seeds),
            "regions": _regions_of(ref)}, **over)
        np.testing.assert_array_equal(port.adj.numpy(), np.asarray(ref.adj))
        np.testing.assert_array_equal(port.region_store.data.numpy(),
                                      np.asarray(ref.region_store.data))
    np.testing.assert_array_equal(port.store.data.numpy(),
                                  np.asarray(ref.store.data))
    assert port.memory_bytes() == ref.memory_bytes()
    _near(port.search(queries, K, SearchParams(**REGION_SP)),
          ref.search(queries, K, RParams(**REGION_SP)))


@pytest.mark.parametrize("f", sorted(REGIONS))
def test_own_region_build_fits_on_its_own_assignment(f, corpus_queries):
    """Without draws: every row's region is its nearest centroid / cell /
    seed (user space), the constants are RegionQuant.fit of that
    assignment, and the regional store holds RegionQuant.encode."""
    corpus, queries = corpus_queries
    idx = make_index(f, corpus, device="cpu", **REGIONS[f])
    rg = idx.regions
    x = torch.from_numpy(corpus)
    if idx.kind == "ivf":
        cents, store = idx.centroids, idx.store
    elif idx.kind == "hnsw":
        cents, store = idx.region_cents, idx.region_store
        assert rg.n_regions == round(N ** 0.5)
    else:
        cents, store = idx.seeds[:, :D], idx.region_store
    want = torch.argmax(core.l2_scores(x, cents), dim=-1)
    assert torch.equal(rg.assign.long(), want)
    refit = RegionQuant.fit(corpus, want, rg.n_regions, bits=8)
    assert torch.equal(refit.lo, rg.lo) and torch.equal(refit.zero, rg.zero)
    assert torch.equal(store.data, rg.encode(corpus))
    dr = idx.region_drift(corpus)
    assert np.isfinite(dr).any()
    np.testing.assert_array_equal(dr[np.isfinite(dr)], 0.0)
    res = idx.search(queries, K, SearchParams(**REGION_SP))
    assert res.stats["regional"] is True and bool((res.ids >= 0).all())
    scale = np.asarray(rg.scale)
    live = np.bincount(rg.assign.numpy(), minlength=rg.n_regions) > 1
    assert live.sum() >= 2 and np.ptp(scale[live].mean(axis=1)) > 0


def test_global_build_degrades_gracefully(corpus_queries, tmp_path):
    """No 'regions' fragment: no regions attached, no regional stats key,
    region_drift raises, a bit-exact round trip."""
    corpus, queries = corpus_queries
    idx = make_index("ivf8,lpq8", corpus, device="cpu", kmeans_iters=4)
    assert idx.regions is None
    res = idx.search(queries, K, SearchParams(nprobe=8))
    assert "regional" not in res.stats
    with pytest.raises(ValueError, match="regions"):
        idx.region_drift(corpus)
    path = tmp_path / "global.npz"
    idx.save(path)
    restored = load_index(path, device="cpu")
    assert restored.regions is None
    _bit_equal(restored.search(queries, K, SearchParams(nprobe=8)), res)
    with np.load(path) as z:
        assert not any(key.startswith("rg") for key in z.files)


def test_regional_scorer_equals_the_reference(regional, corpus_queries):
    """topk_among_regional and regional_stats on the same store, constants
    and candidates (with empty slots and a mask): scores within rtol 1e-6
    of the row scale, ids equal outside near-ties, pads (NEG, -1)."""
    corpus, queries = corpus_queries
    ref, port, _ = regional["ivf8,lpq8,regions"]
    rng = np.random.default_rng(4)
    cand = rng.integers(-1, N, (queries.shape[0], 40)).astype(np.int32)
    mask = rng.random(N) < 0.5
    for metric in ("ip", "l2", "angular"):
        for k in (K, 60):
            rs, ri = r_engine.topk_among_regional(
                jnp.asarray(queries), ref.store, ref.regions.scale,
                ref.regions.zero, ref.regions.assign, jnp.asarray(cand), k,
                metric, mask=jnp.asarray(mask))
            ts, ti = engine.topk_among_regional(
                torch.from_numpy(queries), port.store, port.regions.scale,
                port.regions.zero, port.regions.assign,
                torch.from_numpy(cand), k, metric,
                mask=torch.from_numpy(mask))
            held, _ = fp32_near_equal(ts.numpy(), ti.numpy(), np.asarray(rs),
                                      np.asarray(ri), 1e-6)
            assert held, (metric, k)
    assert engine.regional_stats(port.store, torch.from_numpy(cand)) == \
        r_engine.regional_stats(ref.store, jnp.asarray(cand))


# --------------------------------------------------------------------------
# A1: the rest of core
# --------------------------------------------------------------------------

def _qp(x, bits=8, scheme="gaussian"):
    rp = RQ.learn_params(jnp.asarray(x), bits=bits, scheme=scheme)
    return rp, _params(rp)


@pytest.mark.parametrize("metric", ["ip", "l2", "angular"])
def test_order_agreement_on_the_reference_triples(metric, corpus_queries):
    corpus, queries = corpus_queries
    rp, tp = _qp(corpus)
    key = jax.random.PRNGKey(3)
    ka, kb, kq = jax.random.split(key, 3)
    triples = tuple(np.asarray(jax.random.randint(kk, (2048,), 0, hi))
                    for kk, hi in ((ka, N), (kb, N), (kq, len(queries))))
    for mq in (0.0, 0.5):
        want = float(RPR.order_agreement(
            jnp.asarray(corpus), jnp.asarray(queries), rp, metric,
            n_triples=2048, key=key, margin_quantile=mq))
        got = core.order_agreement(corpus, queries, tp, metric,
                                   n_triples=2048, margin_quantile=mq,
                                   _triples=triples)
        assert abs(got - want) <= 1e-6, (mq, got, want)
    own = core.order_agreement(corpus, queries, tp, metric, n_triples=2048,
                               key=3)
    assert own == core.order_agreement(corpus, queries, tp, metric,
                                       n_triples=2048, key=3)
    assert 0.5 < own <= 1.0


@pytest.mark.parametrize("metric", ["ip", "l2", "angular"])
@pytest.mark.parametrize("bits", [8, 4])
def test_knn_recall_and_quantization_error(metric, bits, corpus_queries):
    """knn_recall equal to the reference's; quantization_error (a float32
    mean over N x D squared errors, summed in each library's order) within
    rtol 1e-5."""
    corpus, queries = corpus_queries
    rp, tp = _qp(corpus, bits=bits)
    want = float(RPR.knn_recall(jnp.asarray(corpus), jnp.asarray(queries),
                                rp, metric, k=K))
    assert abs(core.knn_recall(corpus, queries, tp, metric, k=K)
               - want) <= 1e-6
    np.testing.assert_allclose(
        float(core.quantization_error(torch.from_numpy(corpus), tp)),
        float(RQ.quantization_error(jnp.asarray(corpus), rp)), rtol=1e-5)


@pytest.mark.parametrize("metric", ["ip", "l2", "angular"])
def test_pairwise_distance_and_packed_scores(metric, corpus_queries):
    corpus, _ = corpus_queries
    rp, tp = _qp(corpus)
    codes = np.asarray(RQ.quantize(jnp.asarray(corpus[:2]), rp))
    for quantized, (a, b) in ((False, corpus[:2]), (True, codes)):
        want = float(RD.pairwise_distance(jnp.asarray(a), jnp.asarray(b),
                                          metric, quantized))
        got = float(core.pairwise_distance(torch.from_numpy(a),
                                           torch.from_numpy(b), metric,
                                           quantized))
        if quantized and metric != "angular":
            assert got == want
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6)
    rng = np.random.default_rng(9)
    c = rng.integers(-8, 8, (50, D)).astype(np.int8)
    qc = rng.integers(-8, 8, (5, D)).astype(np.int8)
    packed = np.asarray(RPK.pack_int4(jnp.asarray(c)))
    from repro_torch.core import pack as TPK

    np.testing.assert_array_equal(
        TPK.qip_scores_packed(torch.from_numpy(qc),
                              torch.from_numpy(packed)).numpy(),
        np.asarray(RPK.qip_scores_packed(jnp.asarray(qc),
                                         jnp.asarray(packed))))


def test_core_exports_the_reference_names():
    import repro.core as rcore

    missing = set(rcore.__all__) - set(dir(core)) - {"distributed_stats"}
    assert not missing, missing
