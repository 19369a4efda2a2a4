"""The whole slice — ``repro_torch.knn`` flat indexes behind the Searcher —
against the reference on identical inputs.

* Search parity: a reference-built, reference-saved npz loads in the port
  (``load_index(path, device="cpu")``), and ``search`` / ``Searcher``
  results and stats match the reference's.  Integer arms (int8, packed
  int4) are bit-equal in ids and scores; fp32 (the ``flat`` arm, the
  ``+r32`` tail, angular cosines) within rtol 1e-6 of each row's scale,
  ids equal outside near-ties.  Port-saved npz files load in the
  reference with the same results, and ``convert`` gives the same index
  as the npz route.
* Build parity: the port's own build of the same numpy corpus reaches the
  reference's recall@k against fp32 within 0.005, with the identical
  memory ratio (builds learn constants in a different fp32 summation
  order, so a few codes may round the other way).
"""

import ast
import io
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.preserve import recall_at_k as r_recall  # noqa: E402
from repro.knn import load_index as r_load  # noqa: E402
from repro.knn import make_index as r_make  # noqa: E402
from repro.knn import parse_factory as r_parse  # noqa: E402
from repro.tune import table as tunetable  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.preserve import recall_at_k as t_recall  # noqa: E402
from repro_torch.knn import SearchParams, kinds, load_index, make_index  # noqa: E402
from repro_torch.knn import parse_factory as t_parse  # noqa: E402
from repro_torch.knn.base import load_state  # noqa: E402

N, D, K = 2048, 48, 10
SLICE = ["flat", "flat,lpq8@gaussian:3", "flat,lpq4", "flat,lpq4+r32",
         "flat,lpq8,l2", "flat,lpq8@global_absmax,angular"]
INT_EXACT = {"flat,lpq8@gaussian:3", "flat,lpq4", "flat,lpq8,l2"}


@pytest.fixture(autouse=True)
def _no_tune_table():
    # the reference consults a process-wide TuneTable; compare untuned
    with tunetable.pinned(None):
        yield


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    corpus = (rng.standard_normal((N, D)) * 0.05).astype(np.float32)
    queries = (rng.standard_normal((37, D)) * 0.05).astype(np.float32)
    return corpus, queries


@pytest.fixture(scope="module")
def ref_built(data):
    corpus, _ = data
    with tunetable.pinned(None):
        out = {}
        for f in SLICE:
            idx = r_make(f, jnp.asarray(corpus))
            buf = io.BytesIO()
            idx.save(buf)
            out[f] = (idx, buf.getvalue())
    return out


def _match(got, want, factory):
    gs, gi = (np.asarray(a) for a in (got.scores, got.ids))
    ws, wi = (np.asarray(a) for a in (want.scores, want.ids))
    if factory in INT_EXACT:
        assert np.array_equal(gi, wi) and np.array_equal(gs, ws)
    else:
        scale = np.abs(ws).max(axis=1, keepdims=True) + 1.0
        assert np.all(np.abs(gs - ws) <= 1e-6 * scale)
        assert (gi != wi).mean() < 0.02
    assert dict(got.stats) == dict(want.stats)


@pytest.mark.parametrize("factory", SLICE)
def test_reference_saved_index_searches_the_same(factory, data, ref_built):
    _, queries = data
    ref, blob = ref_built[factory]
    port = load_index(io.BytesIO(blob), device="cpu")
    assert port.memory_bytes() == ref.memory_bytes()
    _match(port.search(queries, K), ref.search(jnp.asarray(queries), K), factory)
    ts = port.searcher(K)
    rs = ref.searcher(K)
    for rows in (1, 7, 37):
        _match(ts(queries[:rows]), rs(jnp.asarray(queries[:rows])), factory)
    assert ts.trace_counts == rs.trace_counts == {1: 1, 8: 1, 256: 1}


@pytest.mark.parametrize("factory", SLICE)
def test_port_saved_index_loads_in_the_reference(factory, data, ref_built):
    _, queries = data
    ref, blob = ref_built[factory]
    port = load_index(io.BytesIO(blob), device="cpu")
    buf = io.BytesIO()
    port.save(buf)
    assert buf.getvalue() == blob                    # byte-identical npz
    back = r_load(io.BytesIO(buf.getvalue()))
    _match(port.search(queries, K), back.search(jnp.asarray(queries), K), factory)


@pytest.mark.parametrize("factory", SLICE)
def test_convert_matches_the_npz_route(factory, data, ref_built):
    _, queries = data
    ref, blob = ref_built[factory]
    arrays, meta = ref.store.state()
    if ref.rerank_store is not None:
        rr_a, rr_m = ref.rerank_store.state(prefix="rr_")
        arrays.update(rr_a)
        meta.update(rr_m)
    meta.update(kind="flat", metric=ref.metric)
    via_convert = convert.flat_from_reference_state(
        {k: np.asarray(v) for k, v in arrays.items()}, meta, device="cpu")
    via_npz = load_index(io.BytesIO(blob), device="cpu")
    a, b = via_convert.search(queries, K), via_npz.search(queries, K)
    assert torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)
    if ref.params is not None:
        p = convert.quant_params_from_numpy(
            *(np.asarray(v) for v in (ref.params.lo, ref.params.hi, ref.params.zero)),
            bits=ref.params.bits, scheme=ref.params.scheme, device="cpu")
        assert torch.equal(p.lo, via_npz.params.lo) and p.bits == ref.params.bits


@pytest.mark.parametrize("factory", ["flat,lpq8@gaussian:3", "flat,lpq4",
                                     "flat,lpq4+r32", "flat,lpq8,l2",
                                     "flat,lpq8@global_absmax,angular"])
def test_build_parity_recall_and_memory(factory, data):
    corpus, queries = data
    metric = r_parse(factory).metric
    k = 20
    r_fp = r_make("flat", jnp.asarray(corpus), metric=metric)
    r_q = r_make(factory, jnp.asarray(corpus))
    t_fp = make_index("flat", corpus, metric=metric, device="cpu")
    t_q = make_index(factory, corpus, device="cpu")
    r_rec = float(r_recall(r_fp.search(jnp.asarray(queries), k).ids,
                           r_q.search(jnp.asarray(queries), k).ids))
    t_rec = t_recall(t_fp.search(queries, k).ids, t_q.search(queries, k).ids)
    assert abs(t_rec - r_rec) <= 0.005, (t_rec, r_rec)
    assert (t_q.memory_bytes() / t_fp.memory_bytes()
            == r_q.memory_bytes() / r_fp.memory_bytes())


def _conformance_factories():
    src = (Path(__file__).parent / "test_conformance.py").read_text()
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "FACTORIES":
            return list(ast.literal_eval(node.value))
    raise AssertionError("FACTORIES not found in test_conformance.py")


@pytest.mark.parametrize("factory", _conformance_factories())
def test_factory_grammar_round_trips_like_the_reference(factory):
    t, r = t_parse(factory), r_parse(factory)
    assert t.to_factory() == r.to_factory()
    assert (t.kind, t.metric, t.rerank_bits, dict(t.params)) == \
        (r.kind, r.metric, r.rerank_bits, dict(r.params))


@pytest.mark.parametrize("bad", ["bogus42", "pq8,lpq4", "pq16x3",
                                 "stream(stream(flat))", "flat,lpq9",
                                 "flat,r16", "cascade(flat)"])
def test_factory_grammar_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        r_parse(bad)
    with pytest.raises(ValueError):
        t_parse(bad)


def test_unported_kinds_and_options_raise_clearly(data):
    corpus, queries = data
    assert kinds() == ("cascade", "flat", "graph", "hnsw", "ivf", "pq",
                       "stream")
    st = make_index("stream(flat,lpq8)", corpus, device="cpu")
    assert st.kind == "stream" and st.n == N
    st = make_index("stream(ivf8,lpq4)+r32", corpus, device="cpu")
    assert st.kind == "stream" and st.rerank_bits == 32
    casc = make_index("cascade(flat,lpq4|r32)", corpus, device="cpu")
    assert casc.kind == "cascade" and casc.stages == "flat,lpq4|r32"
    assert casc.search(queries, K).ids.shape == (queries.shape[0], K)
    idx = make_index("flat,lpq8", corpus, device="cpu")
    with pytest.raises(ValueError, match="SearchParams.filter must be"):
        idx.searcher(K, SearchParams(filter=object()))
    with pytest.raises(ValueError, match="exceeds the corpus size"):
        idx.searcher(N + 1)
    with pytest.raises(ValueError, match="query dim"):
        idx.searcher(K)(queries[:, :5])


def test_tune_meta_key_is_ignored_on_load(data, tmp_path):
    corpus, queries = data
    idx = make_index("flat,lpq4", corpus, device="cpu")
    path = tmp_path / "i.npz"
    idx.save(path)
    arrays, meta = load_state(path)
    with np.load(path) as z:
        import json
        raw = json.loads(bytes(z["__meta__"].tobytes()))
    raw["tune"] = {"stamp": {}, "entries": {}}
    from repro_torch.knn.base import save_state
    save_state(path, arrays, raw)
    again = load_index(path, device="cpu")
    assert torch.equal(again.search(queries, K).ids, idx.search(queries, K).ids)
    assert "tune" not in load_state(path)[1]


def test_searcher_rerank_depth_and_stats(data):
    corpus, queries = data
    idx = make_index("flat,lpq4+r32", corpus, device="cpu")
    s = idx.searcher(K)
    assert s.rerank.depth == 4 * K
    res = s(queries)
    assert res.stats["reranked"] == 4 * K and res.stats["padded_q"] == 256 - 37
    assert res.stats["bucket"] == 256 and res.stats["shards"] == 1
    assert res.stats["tuned"] is False
    off = idx.searcher(K, rerank=False)(queries)
    assert off.stats["reranked"] == 0
    assert s.buckets_for(300) == (256, 256)
