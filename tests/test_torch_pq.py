"""The PQ slice — ``repro_torch.knn.pq`` behind ``engine.topk`` and the
Searcher — against the reference on identical inputs.

* Engine: ``build_pq_lut`` within rtol 1e-6 of the reference's (each entry
  against its query's table abs-max: torch sums the d/M terms in dimension
  order, XLA's dot in its own order, with FMA); ``quantize_pq_lut`` bit-equal
  on the same f32 LUT; ``_topk_pq_from_lut`` given the reference's own int8
  LUT bit-equal in ids and scores, given its f32 LUT within rtol 1e-6 with
  ids equal outside near-ties.
* Search parity: a reference-built, reference-saved npz loads in the port
  (``device="cpu"``) and searches the same, one-shot and through the
  Searcher, stats included.  int8-LUT arms are bit-equal in ids and scores
  (their int8 LUTs are checked equal first: an ulp in the f32 LUT could
  only matter at a .5 rounding point); fp32-LUT arms and the ``,r32`` tail
  within rtol 1e-6, ids equal outside near-ties.  Port-saved npz files are
  byte-identical and load in the reference; ``convert`` gives the npz
  route's index.
* Build parity is statistical: the reference draws its k-means inits from
  ``jax.random``, the port from ``torch.Generator``.  recall@10 against
  the fp32 flat arm is within 0.06 of the reference's (its own spread over
  k-means seeds at this size reaches 0.05), and ``memory_bytes`` is equal.
"""

import io

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.preserve import recall_at_k as r_recall  # noqa: E402
from repro.engine import scorer as RS  # noqa: E402
from repro.knn import SearchParams as RParams  # noqa: E402
from repro.knn import load_index as r_load  # noqa: E402
from repro.knn import make_index as r_make  # noqa: E402
from repro.tune import table as tunetable  # noqa: E402
from repro_torch import convert, engine  # noqa: E402
from repro_torch.core.preserve import recall_at_k as t_recall  # noqa: E402
from repro_torch.engine import scorer as TS  # noqa: E402
from repro_torch.knn import SearchParams, kinds, load_index, make_index  # noqa: E402
from repro_torch.knn.pq import PQIndex  # noqa: E402

N, D, K = 2048, 48, 10
BASE = ["pq8", "pq8x4", "pq8+lpq", "pq8x4+lpq", "pq7x4+lpq", "pq8+lpq,r32"]
ARMS = BASE + [f + ",l2" for f in BASE]


def _dim(factory):
    return 14 if factory.startswith("pq7") else D


def _int_exact(factory):
    return "lpq" in factory and "r32" not in factory


@pytest.fixture(autouse=True)
def _no_tune_table():
    # the reference consults a process-wide TuneTable; compare untuned
    with tunetable.pinned(None):
        yield


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    out = {}
    for d in (D, 14):
        corpus = (rng.standard_normal((N, d)) * 0.05).astype(np.float32)
        queries = (rng.standard_normal((37, d)) * 0.05).astype(np.float32)
        out[d] = (corpus, queries)
    return out


@pytest.fixture(scope="module")
def ref_built(data):
    with tunetable.pinned(None):
        out = {}
        for f in ARMS:
            idx = r_make(f, jnp.asarray(data[_dim(f)][0]), kmeans_iters=4)
            buf = io.BytesIO()
            idx.save(buf)
            out[f] = (idx, buf.getvalue())
    return out


def _close(got, want):
    """fp32: scores within rtol 1e-6 of each row's scale, and an id may
    differ only where the two scores at that rank are within it."""
    (gs, gi), (ws, wi) = got, want
    tol = 1e-6 * (np.abs(ws).max(axis=1, keepdims=True) + 1.0)
    assert np.all(np.abs(gs - ws) <= tol)
    diff = gi != wi
    assert np.all((np.abs(gs - ws) <= tol)[diff])
    assert diff.mean() < 0.05


def _match(got, want, factory):
    g = tuple(np.asarray(a) for a in (got.scores, got.ids))
    w = tuple(np.asarray(a) for a in (want.scores, want.ids))
    if _int_exact(factory):
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[0], w[0])
    else:
        _close(g, w)
    assert dict(got.stats) == dict(want.stats)


# -- engine ---------------------------------------------------------------

@pytest.mark.parametrize("factory", ["pq8", "pq8x4", "pq8,l2", "pq8x4,l2",
                                     "pq7x4+lpq"])
def test_lut_build_and_quantization(factory, data, ref_built):
    _, queries = data[_dim(factory)]
    ref, blob = ref_built[factory]
    port = load_index(io.BytesIO(blob), device="cpu")
    rl = np.array(RS.build_pq_lut(jnp.asarray(queries), ref.store, ref.metric))
    tl = TS.build_pq_lut(torch.from_numpy(queries), port.store, port.metric)
    assert tl.shape == rl.shape and tl.dtype == torch.float32
    scale = np.abs(rl).max(axis=(1, 2), keepdims=True)
    assert np.all(np.abs(tl.numpy() - rl) <= 1e-6 * scale)
    rq = np.asarray(RS.quantize_pq_lut(jnp.asarray(rl)))
    tq = TS.quantize_pq_lut(torch.from_numpy(rl))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), rq)


def test_quantize_pq_lut_rounds_half_to_even_per_query():
    # entries landing exactly on .5 after lut / amax * 127, one query at a
    # huge scale that must not move the other's
    lut = np.zeros((2, 1, 4), np.float32)
    lut[0, 0] = [127.0, 0.5, 1.5, -2.5]
    lut[1, 0] = [1e6, -1e6, 3.0, 0.0]
    rq = np.asarray(RS.quantize_pq_lut(jnp.asarray(lut)))
    tq = TS.quantize_pq_lut(torch.from_numpy(lut)).numpy()
    np.testing.assert_array_equal(tq, rq)
    assert tq[0, 0].tolist() == [127, 0, 2, -2]


@pytest.mark.parametrize("factory", ["pq8+lpq", "pq8x4+lpq", "pq7x4+lpq",
                                     "pq8+lpq,l2", "pq8x4+lpq,l2"])
@pytest.mark.parametrize("masked", [False, True])
def test_topk_from_the_reference_int8_lut_is_bit_equal(factory, masked, data,
                                                       ref_built):
    _, queries = data[_dim(factory)]
    ref, blob = ref_built[factory]
    port = load_index(io.BytesIO(blob), device="cpu")
    lut = RS._prepare_pq_lut(jnp.asarray(queries), ref.store, ref.metric)
    assert str(lut.dtype) == "int8"
    mask = None
    if masked:
        mask = np.random.default_rng(3).random(N) < 0.5
    rmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    t = TS._topk_pq_from_lut(torch.from_numpy(np.asarray(lut)), port.store,
                             K, port.metric, 300, mask=tmask)
    scan = RS._topk_pq_from_lut(lut, ref.store, K, ref.metric, 300,
                                mask=rmask)
    fused = RS._topk_pq_from_lut(lut, ref.store, K, ref.metric, 300,
                                 interpret=True, mask=rmask)
    for want in (scan, fused):
        np.testing.assert_array_equal(t[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(t[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("factory", ["pq8", "pq8x4", "pq8,l2", "pq8x4,l2"])
def test_topk_from_the_reference_fp32_lut_within_tolerance(factory, data,
                                                           ref_built):
    _, queries = data[_dim(factory)]
    ref, blob = ref_built[factory]
    port = load_index(io.BytesIO(blob), device="cpu")
    lut = RS._prepare_pq_lut(jnp.asarray(queries), ref.store, ref.metric)
    assert str(lut.dtype) == "float32"
    s, i = TS._topk_pq_from_lut(torch.from_numpy(np.asarray(lut)), port.store,
                                K, port.metric, 300)
    rs, ri = RS._topk_pq_from_lut(lut, ref.store, K, ref.metric, 300)
    _close((s.numpy(), i.numpy()), (np.asarray(rs), np.asarray(ri)))


# -- indexes ------------------------------------------------------------------

@pytest.mark.parametrize("factory", ARMS)
def test_reference_saved_index_searches_the_same(factory, data, ref_built):
    _, queries = data[_dim(factory)]
    ref, blob = ref_built[factory]
    port = load_index(io.BytesIO(blob), device="cpu")
    assert isinstance(port, PQIndex)
    assert port.memory_bytes() == ref.memory_bytes()
    assert port.store.code_bytes == ref.store.code_bytes
    if _int_exact(factory):                  # the premise of bit-equality
        np.testing.assert_array_equal(
            TS._prepare_pq_lut(torch.from_numpy(queries), port.store,
                               port.metric).numpy(),
            np.asarray(RS._prepare_pq_lut(jnp.asarray(queries), ref.store,
                                          ref.metric)))
    _match(port.search(queries, K), ref.search(jnp.asarray(queries), K), factory)
    ts, rs = port.searcher(K), ref.searcher(K)
    for rows in (1, 7, 37):
        _match(ts(queries[:rows]), rs(jnp.asarray(queries[:rows])), factory)
    assert ts.trace_counts == rs.trace_counts == {1: 1, 8: 1, 256: 1}


@pytest.mark.parametrize("factory", ARMS)
def test_port_saved_index_loads_in_the_reference(factory, data, ref_built):
    _, queries = data[_dim(factory)]
    _, blob = ref_built[factory]
    port = load_index(io.BytesIO(blob), device="cpu")
    buf = io.BytesIO()
    port.save(buf)
    assert buf.getvalue() == blob                    # byte-identical npz
    back = r_load(io.BytesIO(buf.getvalue()))
    _match(port.search(queries, K), back.search(jnp.asarray(queries), K),
           factory)


@pytest.mark.parametrize("factory", ["pq8x4+lpq", "pq7x4+lpq,l2",
                                     "pq8+lpq,r32", "pq8,l2"])
def test_convert_matches_the_npz_route(factory, data, ref_built):
    _, queries = data[_dim(factory)]
    ref, blob = ref_built[factory]
    arrays, meta = ref.store.state()
    if ref.rerank_store is not None:
        rr_a, rr_m = ref.rerank_store.state(prefix="rr_")
        arrays = {**arrays, **rr_a}
        meta = {**meta, **rr_m}
    meta.update(kind="pq", metric=ref.metric)
    via_convert = convert.pq_from_reference_state(
        {k: np.asarray(v) for k, v in arrays.items()}, meta, device="cpu")
    via_npz = load_index(io.BytesIO(blob), device="cpu")
    a, b = via_convert.search(queries, K), via_npz.search(queries, K)
    assert torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)
    assert torch.equal(via_convert.codes, via_npz.codes)
    assert (via_convert.rerank_store is None) == (ref.rerank_store is None)


@pytest.mark.parametrize("factory", ["pq8", "pq8x4+lpq", "pq7x4+lpq",
                                     "pq8+lpq,l2", "pq8+lpq,r32"])
def test_build_parity_recall_and_memory(factory, data):
    d = _dim(factory)
    corpus, _ = data[d]
    queries = (np.random.default_rng(1).standard_normal((200, d))
               * 0.05).astype(np.float32)
    metric = "l2" if factory.endswith("l2") else "ip"
    r_fp = r_make("flat", jnp.asarray(corpus), metric=metric)
    r_q = r_make(factory, jnp.asarray(corpus))
    t_fp = make_index("flat", corpus, metric=metric, device="cpu")
    t_q = make_index(factory, corpus, device="cpu")
    r_rec = float(r_recall(r_fp.search(jnp.asarray(queries), K).ids,
                           r_q.search(jnp.asarray(queries), K).ids))
    t_rec = t_recall(t_fp.search(queries, K).ids, t_q.search(queries, K).ids)
    assert abs(t_rec - r_rec) <= 0.06, (t_rec, r_rec)
    assert t_q.memory_bytes() == r_q.memory_bytes()
    assert t_q.codebooks.shape == r_q.codebooks.shape
    assert t_q.codes.dtype == torch.uint8 and t_q.codes.shape == r_q.codes.shape


def test_tiny_corpus_pads_the_codebooks():
    x = (np.random.default_rng(2).standard_normal((40, 16)) * 0.05).astype(np.float32)
    t = make_index("pq4", x, device="cpu")
    r = r_make("pq4", jnp.asarray(x))
    assert tuple(t.codebooks.shape) == tuple(r.codebooks.shape) == (4, 256, 4)
    assert torch.all(t.codebooks[:, 40:] == 0)
    assert t.memory_bytes() == r.memory_bytes()
    assert t.search(x[:3], 5).ids.shape == (3, 5)


# -- C2: one LUT build on both paths ------------------------------------------

@pytest.mark.parametrize("factory", ["pq16", "pq16x4"])
def test_searcher_matches_one_shot_on_fp32_lut_arms(factory):
    """The reference's own test fails on these arms (ROADMAP C2: its
    Searcher and one-shot LUTs differ by up to 1.8e-7 relative).  The port
    builds every LUT through ``_prepare_pq_lut`` with a per-query fixed sum
    order, so a padded bucket and a one-shot call agree bit for bit; both
    stay within rtol 1e-6 of the reference.  Same corpus and knobs as
    ``tests/test_conformance.py``."""
    corpus = jax.random.normal(jax.random.PRNGKey(0), (384, 32)) * 0.05
    queries = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, 32)) * 0.05)
    with tunetable.pinned(None):
        ref = r_make(factory, corpus, key=jax.random.PRNGKey(0), kmeans_iters=4)
        buf = io.BytesIO()
        ref.save(buf)
        r_eager = ref.search(jnp.asarray(queries), K,
                             RParams(nprobe=8, ef_search=40))
    port = load_index(io.BytesIO(buf.getvalue()), device="cpu")
    sp = SearchParams(nprobe=8, ef_search=40)
    eager = port.search(queries, K, sp)
    planned = port.searcher(K, sp, batch_sizes=(4, 16))(queries)
    assert torch.equal(eager.ids, planned.ids)
    assert torch.equal(eager.scores, planned.scores)
    _close((eager.scores.numpy(), eager.ids.numpy()),
           (np.asarray(r_eager.scores), np.asarray(r_eager.ids)))


# -- errors and entry points --------------------------------------------------

def test_errors_raise_like_the_reference(data):
    corpus, queries = data[D]
    for call in (r_make, lambda f, x: make_index(f, x, device="cpu")):
        with pytest.raises(ValueError, match="ip and l2 only"):
            call("pq8,angular", corpus)
        with pytest.raises(ValueError, match="regions"):
            call("pq8,lpq8,regions", corpus)
        with pytest.raises(ValueError, match="codeword width"):
            call("pq8x3", corpus)
        with pytest.raises(AssertionError):
            call("pq5", corpus)                     # 48 % 5 != 0
    with pytest.raises(ValueError, match="codeword width"):
        PQIndex.build(corpus, m=8, bits=3, device="cpu")
    idx = make_index("pq8+lpq", corpus, device="cpu", kmeans_iters=1)
    with pytest.raises(ValueError, match="ip and l2 only"):
        engine.topk(torch.from_numpy(queries), idx.store, K, "angular")


def test_pq_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, data,
                                                        tmp_path):
    corpus, queries = data[D]
    assert kinds() == ("cascade", "flat", "graph", "hnsw", "ivf", "pq",
                       "stream")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_index("pq8+lpq", corpus)
    idx = make_index("pq8+lpq", corpus, device="cpu", kmeans_iters=1)
    assert idx.device.type == "cpu" and idx.codes.device.type == "cpu"
    idx.save(tmp_path / "p.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_index(tmp_path / "p.npz")
    back = load_index(tmp_path / "p.npz", device="cpu")
    assert torch.equal(back.search(queries, K).ids, idx.search(queries, K).ids)
    res = idx.searcher(K)(queries)
    assert res.stats["kind"] == "pq" and res.stats["lpq_tables"] is True
    assert res.stats["tuned"] is False and res.stats["bits"] == 8
    with pytest.raises(ValueError, match="query dim"):
        idx.searcher(K)(queries[:, :5])
