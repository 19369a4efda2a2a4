"""The port's stream kind (``repro_torch.stream``) and the pieces it stands
on, against the reference (``repro.stream``, DESIGN.md §10):

  * ``core.stats``: ``StreamingStats``, ``merge_stats``,
    ``calibration_drift`` within rtol 1e-5 of the reference, and the npz
    fragments round-trip;
  * ``CodeStore.concat`` / ``append`` bit-equal to the reference's, with
    its refusals;
  * one write sequence run on both packages (upserts that replace rows,
    new ids, deletes, seals, auto compaction with and without drift, then
    ``compact(full=True)``): manifests, live bitmaps, counters, epochs
    and recalibration decisions equal, drifts within rtol 1e-5, filtered
    searches equal (bit-exact on a single-source integer plan; a
    multi-source merge re-scores in fp32 and is held within rtol 1e-6);
  * npz files in both directions, through ``load_index`` and
    ``convert.stream_from_reference_state``;
  * the invariants: full compaction equals a from-scratch inner build bit
    for bit, the filtered-merge starvation regression, filter and
    tombstone churn against a ``live_items()`` oracle;
  * what raises, naming its ROADMAP item.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

from repro import engine as r_engine
from repro.core import quant as RQz
from repro.core import stats as RSt
from repro.filter import Filter as RFilter
from repro.knn import SearchParams as RSearchParams
from repro.knn import load_index as r_load_index
from repro.knn import make_index as r_make_index
from repro_torch import convert, engine
from repro_torch.core import quant as Qz
from repro_torch.core import stats as St
from repro_torch.filter import Filter
from repro_torch.knn import SearchParams, load_index, make_index
from repro_torch.knn.base import load_state
from repro_torch.stream import CompactionPolicy, MutableIndex
from repro_torch.stream.mutable import as_key, split_key

K = 10
D = 24
NEG = float(np.finfo(np.float32).min)


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(0)
    corpus = (rng.standard_normal((600, D)) * 0.3 + 0.1).astype(np.float32)
    queries = corpus[rng.choice(600, 12, replace=False)] + \
        rng.standard_normal((12, D)).astype(np.float32) * 0.05
    return corpus, queries.astype(np.float32)


def _stats_close(port: St.DimStats, ref, rtol=1e-5):
    for f in St.STATS_FIELDS:
        np.testing.assert_allclose(getattr(port, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=rtol,
                                   atol=1e-6, err_msg=f)


# ==========================================================================
# core.stats
# ==========================================================================

def test_streaming_stats_and_merge_match_the_reference(rows):
    corpus, _ = rows
    import jax.numpy as jnp

    port, ref = St.StreamingStats(D), RSt.StreamingStats(D)
    for a, b in ((0, 0), (0, 37), (37, 38), (38, 300), (300, 600)):
        port.update(torch.from_numpy(corpus[a:b]))
        ref.update(jnp.asarray(corpus[a:b]))
    _stats_close(port.stats, ref.stats)
    _stats_close(port.stats, RSt.corpus_stats(jnp.asarray(corpus)))
    m = St.merge_stats(St.corpus_stats(torch.from_numpy(corpus[:100])),
                       St.corpus_stats(torch.from_numpy(corpus[100:])))
    _stats_close(m, RSt.merge_stats(RSt.corpus_stats(jnp.asarray(corpus[:100])),
                                    RSt.corpus_stats(jnp.asarray(corpus[100:]))))
    other = St.StreamingStats(D).update(torch.from_numpy(corpus[:50]))
    merged = St.StreamingStats(D).merge(other).merge(St.empty_stats(D))
    _stats_close(merged.stats, RSt.corpus_stats(jnp.asarray(corpus[:50])))


def test_zero_count_guards():
    ss = St.StreamingStats(4)
    ss.update(torch.zeros((0, 4)))
    assert not torch.isnan(ss.stats.mean).any()
    ss.update(torch.full((5, 4), 2.0))
    assert torch.allclose(ss.stats.mean, torch.full((4,), 2.0))
    bad = dataclasses.replace(St.empty_stats(3), mean=torch.full((3,), float("nan")),
                              m2=torch.full((3,), float("nan")))
    m = St.merge_stats(bad, St.corpus_stats(torch.ones((4, 3))))
    assert not torch.isnan(m.mean).any() and not torch.isnan(m.std).any()
    e = St.merge_stats(St.empty_stats(3), St.empty_stats(3))
    assert float(e.count) == 0.0 and not torch.isnan(e.std).any()


@pytest.mark.parametrize("shift,scale", [(0.0, 1.0), (0.5, 1.0), (2.0, 3.0),
                                         (-1.0, 0.2)])
def test_calibration_drift_matches_the_reference(rows, shift, scale):
    corpus, _ = rows
    import jax.numpy as jnp

    live = corpus[300:] * scale + shift
    port = St.calibration_drift(St.corpus_stats(torch.from_numpy(corpus[:300])),
                                St.corpus_stats(torch.from_numpy(live)))
    ref = RSt.calibration_drift(RSt.corpus_stats(jnp.asarray(corpus[:300])),
                                RSt.corpus_stats(jnp.asarray(live)))
    assert port == pytest.approx(ref, rel=1e-5)
    s = St.corpus_stats(torch.from_numpy(corpus))
    assert St.calibration_drift(St.empty_stats(D), s) == float("inf")
    assert St.calibration_drift(s, s) == pytest.approx(0.0, abs=1e-6)


def test_stats_arrays_round_trip_in_the_reference_layout(rows):
    corpus, _ = rows
    import jax.numpy as jnp

    s = St.corpus_stats(torch.from_numpy(corpus))
    arrays = St.stats_arrays("cal_", s)
    ref = RSt.stats_arrays("cal_", RSt.corpus_stats(jnp.asarray(corpus)))
    assert arrays.keys() == ref.keys()
    for key in arrays:
        assert arrays[key].dtype == ref[key].dtype, key
        assert arrays[key].shape == ref[key].shape, key
    back = St.stats_from_arrays("cal_", arrays)
    for f in St.STATS_FIELDS:
        assert torch.equal(getattr(back, f), getattr(s, f)), f
    _stats_close(St.stats_from_arrays("cal_", ref), RSt.stats_from_arrays(
        "cal_", ref))


# ==========================================================================
# CodeStore.concat / append
# ==========================================================================

def _port_store(ref_store):
    arrays, meta = ref_store.state()
    return engine.CodeStore.from_state({k: np.asarray(v)
                                        for k, v in arrays.items()}, meta,
                                       device="cpu")


@pytest.mark.parametrize("bits,packed,d", [(32, False, D), (8, False, D),
                                           (4, True, D), (4, True, 7),
                                           (4, False, D)])
def test_concat_and_append_bit_equal_to_the_reference(rows, bits, packed, d):
    corpus, _ = rows
    import jax.numpy as jnp

    x = corpus[:, :d]
    if bits == 32:
        ra = r_engine.CodeStore.dense(jnp.asarray(x[:200]))
        rb = r_engine.CodeStore.dense(jnp.asarray(x[200:350]))
    else:
        spec = RQz.learn_params(jnp.asarray(x), bits=bits,
                                scheme="global_minmax")
        enc = lambda v: r_engine.CodeStore.from_codes(   # noqa: E731
            RQz.quantize(jnp.asarray(v), spec), spec, pack=packed)
        ra, rb = enc(x[:200]), enc(x[200:350])
    rc = r_engine.CodeStore.concat([ra, rb], base=7)
    pc = engine.CodeStore.concat([_port_store(ra), _port_store(rb)], base=7)
    assert (pc.n, pc.d, pc.bits, pc.packed, pc.base) == \
        (rc.n, rc.d, rc.bits, rc.packed, rc.base)
    assert np.array_equal(pc.data.numpy(), np.asarray(rc.data))
    rp = rc.append(jnp.asarray(x[350:]))
    pp = pc.append(x[350:])
    assert (pp.n, pp.base) == (rp.n, rp.base)
    assert np.array_equal(pp.data.numpy(), np.asarray(rp.data))


def test_concat_refusals_match_the_reference(rows):
    corpus, _ = rows
    import jax.numpy as jnp

    x = jnp.asarray(corpus)
    p8 = RQz.learn_params(x[:100], bits=8, scheme="global_minmax")
    q8 = RQz.learn_params(x[100:], bits=8, scheme="global_minmax")
    r8 = r_engine.CodeStore.from_codes(RQz.quantize(x[:100], p8), p8)
    r8b = r_engine.CodeStore.from_codes(RQz.quantize(x[100:], q8), q8)
    rd = r_engine.CodeStore.dense(x[:10])
    cases = [([r8, r8b], "different quantization constants"),
             ([r8, rd], "layout-incompatible"), ([], "zero stores")]
    for stores, match in cases:
        with pytest.raises(ValueError, match=match):
            r_engine.CodeStore.concat(stores)
        with pytest.raises(ValueError, match=match):
            engine.CodeStore.concat([_port_store(s) for s in stores])
    with pytest.raises(ValueError, match="append dim"):
        _port_store(rd).append(corpus[:3, :5])


# ==========================================================================
# one write sequence on both packages
# ==========================================================================

LIFECYCLE_ARMS = ["stream(flat)", "stream(flat,lpq8@global_minmax)",
                  "stream(flat,lpq4@global_absmax)+r32"]


def _write_sequence(idx, corpus, checkpoint):
    """Upserts that replace rows and add ids, deletes, seals, auto
    compaction (one round of shifted rows makes the drift policy
    recalibrate), then full compaction; ``checkpoint(tag)`` after each."""
    rng = np.random.default_rng(11)
    checkpoint("build")
    replace = rng.choice(300, 60, replace=False)
    idx.upsert(replace, corpus[300:360])
    idx.upsert(np.arange(1000, 1090), corpus[360:450])
    checkpoint("upserts")
    idx.delete(rng.choice(300, 40, replace=False))
    idx.delete(np.arange(1000, 1090, 9))
    checkpoint("deletes")
    for r in range(6):                         # seals and auto compaction
        ids = np.arange(2000 + 40 * r, 2040 + 40 * r)
        shift = 2.5 if r == 3 else 0.0
        idx.upsert(ids, corpus[450 + 20 * r:490 + 20 * r] + shift)
        idx.delete(rng.choice(300, 5, replace=False))
    checkpoint("churn")
    idx.compact()
    checkpoint("compact")
    idx.compact(full=True)
    checkpoint("full")


def _state_of(idx):
    st = idx.stats()
    segs = [(s.n, s.ext_ids.tolist(), s.live.tolist())
            for s in idx.manifest.segments]
    mv, mi = idx.memtable.snapshot()
    return {"segs": segs, "mem_ids": mi.tolist(), "mem": mv,
            "counters": dict(idx.counters), "epoch": st["epoch"],
            "drift": st["drift"], "live": st["live"],
            "tombstones": st["tombstones"]}


@pytest.fixture(scope="module")
def lifecycles(rows):
    """Each arm's write sequence on the reference and on the port (CPU):
    the state and a filtered search at every checkpoint."""
    import jax

    corpus, queries = rows
    allow = np.random.default_rng(3).random(2400) < 0.3
    out = {}
    for f in LIFECYCLE_ARMS:
        runs = {}
        for name, make, F, SP, kw in (
                ("ref", r_make_index, RFilter, RSearchParams,
                 {"key": jax.random.PRNGKey(0)}),
                ("port", make_index, Filter, SearchParams, {"device": "cpu"})):
            idx = make(f, corpus[:300], seal_threshold=64, max_segments=4,
                       **kw)
            log = []

            def checkpoint(tag, idx=idx, F=F, SP=SP, log=log):
                sp = SP(filter=F.from_mask(allow))
                res = idx.searcher(K, sp)(queries)
                log.append((tag, _state_of(idx), np.asarray(res.scores),
                            np.asarray(res.ids),
                            len(idx.manifest.segments)))

            _write_sequence(idx, corpus, checkpoint)
            runs[name] = log
        out[f] = runs
    return out


@pytest.mark.parametrize("f", LIFECYCLE_ARMS)
def test_lifecycle_state_equals_the_reference(lifecycles, f):
    ref, port = lifecycles[f]["ref"], lifecycles[f]["port"]
    assert [t for t, *_ in ref] == [t for t, *_ in port]
    for (tag, rs, *_), (_t, ps, *_) in zip(ref, port):
        for key in ("segs", "mem_ids", "counters", "epoch", "live",
                    "tombstones"):
            assert ps[key] == rs[key], (f, tag, key)
        assert np.array_equal(ps["mem"], rs["mem"]), (f, tag)
        np.testing.assert_allclose(ps["drift"], rs["drift"], rtol=1e-5,
                                   err_msg=f"{f} {tag}")
    counters = port[-1][1]["counters"]
    assert counters["compactions"] >= 3 and counters["recalibrations"] >= 2


def _held(gs, gi, rs, ri, msg, rtol=1e-6):
    """ids and scores of a fp32 merge: scores within rtol of the row scale,
    ids equal outside near-ties."""
    assert np.array_equal(gi >= 0, ri >= 0), msg
    scale = np.abs(rs).max(axis=1, keepdims=True) + 1.0
    live = ri >= 0
    assert (np.abs(gs - rs)[live] <= rtol * np.broadcast_to(
        scale, gs.shape)[live]).all(), msg
    for r in range(gi.shape[0]):
        for c in np.flatnonzero(gi[r] != ri[r]):
            near = np.abs(rs[r] - rs[r, c]) <= 2 * rtol * scale[r]
            assert gi[r, c] in ri[r][near], f"{msg} row {r} col {c}"


@pytest.mark.parametrize("f", LIFECYCLE_ARMS)
def test_lifecycle_filtered_search_equals_the_reference(lifecycles, f):
    """Filtered Searchers at every checkpoint: bit-exact where the plan is
    one integer source passed through (a fresh build and after full
    compaction of ``stream(flat,lpq8@global_minmax)``), within rtol 1e-6
    where the merge re-scores in fp32."""
    allow = np.random.default_rng(3).random(2400) < 0.3
    for (tag, _rs, rsc, rid, nseg), (_t, _ps, psc, pid, _n) in zip(
            lifecycles[f]["ref"], lifecycles[f]["port"]):
        assert allow[pid[pid >= 0]].all(), (f, tag)
        exact = ("lpq8" in f and nseg == 1
                 and tag in ("build", "full"))
        if exact:
            assert np.array_equal(pid, rid) and np.array_equal(psc, rsc), \
                (f, tag)
        else:
            _held(psc, pid, rsc, rid, f"{f} {tag}")


# ==========================================================================
# npz files in both directions
# ==========================================================================

def _churned(make, corpus, f, **kw):
    idx = make(f, corpus[:250], seal_threshold=100, auto_compact=False,
               kmeans_iters=2, **kw)
    for a in (250, 350, 450):                         # 2 seals + memtable
        idx.upsert(np.arange(a, min(a + 100, 480)), corpus[a:min(a + 100, 480)])
    idx.delete(np.arange(0, 250, 6))
    idx.upsert(np.arange(10, 20), corpus[500:510])
    return idx


def test_reference_saved_stream_searches_the_same_in_the_port(rows):
    import jax

    corpus, queries = rows
    # 32 dims, so the inner pq16x4 splits them into 16 subspaces
    corpus = np.hstack([corpus, corpus[:, :8]])
    queries = np.hstack([queries, queries[:, :8]])
    ref = _churned(r_make_index, corpus, "stream(pq16x4,lpq8)",
                   key=jax.random.PRNGKey(0))
    assert len(ref.manifest.segments) == 3 and ref.memtable.live_count
    assert ref.manifest.tombstones > 0
    buf = io.BytesIO()
    ref.save(buf)
    via_load = load_index(io.BytesIO(buf.getvalue()), device="cpu")
    arrays, meta = load_state(io.BytesIO(buf.getvalue()))
    via_convert = convert.stream_from_reference_state(arrays, meta,
                                                      device="cpu")
    allow = np.random.default_rng(1).random(520) < 0.4
    want = ref.search(queries, K, RSearchParams(filter=RFilter.from_mask(allow)))
    for port in (via_load, via_convert):
        assert isinstance(port, MutableIndex)
        assert port.stats()["segment_rows"] == ref.stats()["segment_rows"]
        assert port.counters == meta["counters"]
        assert np.array_equal(port._key, np.asarray(arrays["rng_key"]))
        got = port.search(queries, K, SearchParams(
            filter=Filter.from_mask(allow)))
        _held(got.scores.numpy(), got.ids.numpy(), np.asarray(want.scores),
              np.asarray(want.ids), "reference-saved stream")
    a, b = (p.search(queries, K) for p in (via_load, via_convert))
    assert torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)


def test_port_saved_stream_loads_in_the_reference(rows, tmp_path):
    corpus, queries = rows
    port = _churned(make_index, corpus, "stream(flat,lpq8@global_minmax)+r32",
                    device="cpu", key=5)
    path = tmp_path / "s.npz"
    port.save(path)
    arrays, _meta = load_state(path)
    assert arrays["rng_key"].dtype == np.uint32
    assert arrays["rng_key"].shape == (2,)
    ref = r_load_index(str(path))
    assert ref.stats()["segment_rows"] == port.stats()["segment_rows"]
    assert ref.stats()["tombstones"] == port.stats()["tombstones"]
    assert np.asarray(ref._key).tolist() == port._key.tolist()
    allow = np.random.default_rng(2).random(520) < 0.25
    want = ref.search(queries, K, RSearchParams(filter=RFilter.from_mask(allow)))
    got = port.search(queries, K, SearchParams(filter=Filter.from_mask(allow)))
    _held(got.scores.numpy(), got.ids.numpy(), np.asarray(want.scores),
          np.asarray(want.ids), "port-saved stream")
    back = load_index(path, device="cpu")
    again = back.search(queries, K, SearchParams(filter=Filter.from_mask(allow)))
    assert torch.equal(again.ids, got.ids)
    assert torch.equal(again.scores, got.scores)
    assert back.counters == port.counters


def test_keys_split_deterministically():
    assert as_key(None).tolist() == [0, 0]
    assert as_key(7).tolist() == [0, 7]
    assert as_key(np.array([3, 4], np.uint32)).tolist() == [3, 4]
    k1, s1 = split_key(as_key(0))
    k2, s2 = split_key(as_key(0))
    assert k1.tolist() == k2.tolist() and s1 == s2 and 0 <= s1 < 2 ** 31
    assert split_key(k1)[1] != s1
    with pytest.raises(ValueError, match="uint32"):
        as_key(np.zeros(3))


# ==========================================================================
# invariants
# ==========================================================================

@pytest.mark.parametrize("f,inner", [
    ("stream(flat,lpq8@gaussian:3)", "flat,lpq8@gaussian:3"),
    ("stream(flat,lpq4)+r32", "flat,lpq4+r32"),
    ("stream(flat)", "flat")])
def test_full_compaction_equals_a_from_scratch_build(rows, f, inner):
    """DESIGN.md §10's exact-parity invariant, bit for bit, at every
    Searcher bucket: after churn and ``compact(full=True)``, the stream
    index searches as a fresh build of its inner factory on
    ``live_items()`` (ids mapped to external ids)."""
    corpus, queries = rows
    idx = make_index(f, corpus[:300], device="cpu", seal_threshold=64,
                     key=3)
    idx.upsert(np.arange(100, 160), corpus[300:360])
    idx.upsert(np.arange(700, 800), corpus[360:460])
    idx.delete(np.arange(0, 300, 4))
    idx.compact(full=True)
    assert idx.stats()["segments"] == 1 and idx.stats()["tombstones"] == 0
    ext, vecs = idx.live_items()
    scratch = make_index(inner, vecs, device="cpu")
    for nq in (1, 8, 12):
        a = idx.searcher(K)(queries[:nq])
        b = scratch.searcher(K)(queries[:nq])
        mapped = torch.where(b.ids >= 0,
                             torch.from_numpy(ext)[b.ids.clamp_min(0).long()]
                             .to(torch.int32), -1)
        assert torch.equal(a.ids, mapped), (f, nq)
        assert torch.equal(a.scores, b.scores), (f, nq)


def test_segment_overfetch_survives_selective_filter():
    """The reference's starvation regression (``tests/test_filter.py``):
    per-segment over-fetch must count filtered-out rows as well as
    tombstones.  n=97 rows sealed in 10-row chunks, disallowed rows
    boosted above the allowed ones."""
    n, d, k = 97, 8, 5
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((4, d)).astype(np.float32)
    allow = np.random.default_rng(9).random(n) < 0.25
    allow[:3] = True
    boost = queries.mean(axis=0)
    boost /= np.linalg.norm(boost)
    vecs[~allow] += 4.0 * boost
    idx = make_index("stream(flat)", np.zeros((0, d), np.float32),
                     device="cpu", seal_threshold=10, max_segments=64,
                     auto_compact=False)
    for start in range(0, n, 10):
        idx.upsert(np.arange(start, min(start + 10, n)),
                   vecs[start:start + 10])
    idx.seal()
    assert idx.stats()["segments"] >= 9
    res = idx.searcher(k, SearchParams(filter=Filter.from_mask(allow)))(
        queries)
    s = queries @ vecs[allow].T
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    assert np.array_equal(res.ids.numpy(), np.flatnonzero(allow)[order])


def test_filtered_search_after_churn_matches_a_live_oracle(rows):
    """Upsert / delete churn, then a filtered search equals brute force over
    ``live_items()`` cut to the filter (fp32, the merge's space); the next
    plan sees the next delete."""
    corpus, queries = rows
    n = 200
    idx = make_index("stream(flat)+r32", corpus[:n], device="cpu",
                     seal_threshold=64)
    rng = np.random.default_rng(5)
    idx.delete(rng.choice(n, 40, replace=False))
    new_ids = np.arange(n, n + 90)
    idx.upsert(new_ids, corpus[n:n + 90])
    idx.delete(new_ids[::7])
    idx.upsert(np.arange(10, 30), corpus[400:420])
    allow = (np.arange(n + 90) % 2) == 0
    sp = SearchParams(filter=Filter.from_mask(allow))
    res = idx.searcher(K, sp, rerank=idx.n)(queries)
    ext, vecs = idx.live_items()
    keep = allow[ext]
    s = (queries @ vecs[keep].T).astype(np.float32)
    order = np.argsort(-s, axis=1, kind="stable")[:, :K]
    assert np.array_equal(res.ids.numpy(), ext[keep][order])
    np.testing.assert_allclose(res.scores.numpy(),
                               np.take_along_axis(s, order, 1), rtol=1e-6)
    first = int(res.ids[0, 0])
    idx.delete([first])
    res2 = idx.searcher(K, sp, rerank=idx.n)(queries)
    assert first not in res2.ids[0].tolist()


def test_background_compaction_swap_and_conflict(rows):
    corpus, queries = rows
    idx = make_index("stream(flat,lpq8)", corpus[:100], device="cpu",
                     seal_threshold=50, auto_compact=False)
    for a in (100, 150, 200):
        idx.upsert(np.arange(a, a + 50), corpus[a:a + 50])
    assert idx.stats()["segments"] == 4
    pending = idx.compact_snapshot()
    idx.delete([int(pending.group[0].ext_ids[0])])     # lands mid-build
    assert idx.apply_compaction(pending)
    assert idx.stats()["segments"] == 3
    dead = int(pending.group[0].ext_ids[0])
    assert dead not in idx.live_items()[0].tolist()
    stale = idx.compact_snapshot(full=True)
    idx.compact()
    assert not idx.apply_compaction(stale)
    assert idx.counters["swap_conflicts"] == 1
    assert idx.refresh_rerank_store() in (True, False)
    res = idx.search(queries, K)
    assert dead not in res.ids.numpy()


def test_empty_index_and_write_errors():
    idx = make_index("stream(flat,lpq8)", np.zeros((0, D), np.float32),
                     device="cpu")
    assert idx.n == 0
    res = idx.search(np.zeros((2, D), np.float32), 3)
    assert res.ids.tolist() == [[-1] * 3] * 2
    with pytest.raises(ValueError, match="ids"):
        idx.upsert([-1], np.zeros((1, D), np.float32))
    with pytest.raises(ValueError, match="duplicate"):
        idx.upsert([1, 1], np.zeros((2, D), np.float32))
    with pytest.raises(ValueError):
        idx.upsert([1], np.zeros((1, D + 1), np.float32))
    assert idx.delete([42]) == 0
    with pytest.raises(ValueError, match="stream cannot wrap stream"):
        MutableIndex(d=4, metric="ip", inner_factory="stream(flat)",
                     device="cpu")
    with pytest.raises(ValueError, match="redundant"):
        MutableIndex(d=4, metric="ip", inner_factory="flat,lpq8+r32",
                     device="cpu")
    assert CompactionPolicy().max_segments == 8


def test_unported_parts_raise_naming_their_roadmap_item(rows):
    corpus, queries = rows
    # a cascade inner kind (A11) now builds: each sealed segment is one
    casc = make_index("stream(cascade(flat,lpq8|r32))", corpus[:50],
                      device="cpu")
    assert casc.manifest.segments[0].index.kind == "cascade"
    assert casc.search(queries[:2], K).ids.shape == (2, K)
    idx = make_index("stream(flat,lpq8)", corpus[:50], device="cpu")
    with pytest.raises(NotImplementedError, match="A14"):
        idx.placement(2)
    with pytest.raises(NotImplementedError, match="A14"):
        idx.plan(K, mesh=object())
    with pytest.raises(NotImplementedError, match="A14"):
        idx.searcher(K, shards=object())


def test_stream_runs_on_the_card_unless_cpu_is_asked(rows, monkeypatch):
    corpus, _ = rows
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_index("stream(flat,lpq8)", corpus[:50])
    idx = make_index("stream(flat,lpq8)", corpus[:50], device="cpu")
    buf = io.BytesIO()
    idx.save(buf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_index(io.BytesIO(buf.getvalue()))
    assert idx.device.type == "cpu"
    assert idx.manifest.segments[0].index.device.type == "cpu"


def test_quant_params_are_shared_across_reused_constants(rows):
    """The compactor's reuse path: a merge that does not recalibrate
    rebuilds under group[0]'s constants, bit-identically."""
    corpus, _ = rows
    idx = make_index("stream(flat,lpq8@global_minmax)", corpus[:128],
                     device="cpu", seal_threshold=64, auto_compact=False,
                     drift_threshold=1e9)
    p = idx.params
    spec = idx._inner_spec(p)
    idx.upsert(np.arange(128, 256), corpus[128:256])
    for seg in idx.manifest.segments[1:]:
        seg.index = make_index(spec, seg.raw, device="cpu")
    assert idx.compact(recalibrate=None)
    merged = idx.manifest.segments
    assert any(torch.equal(s.index.params.lo, p.lo) for s in merged)
    assert idx.counters["recalibrations"] == 0
    assert isinstance(p, Qz.QuantParams)
