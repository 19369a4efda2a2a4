"""Filtered search through every ported kind (DESIGN.md §16), held two ways.

  * Against the arm's own exhaustive ranking cut down to the allowed rows
    (the reference's ``tests/test_conformance.py`` filtered matrix): ef
    and the rerank depth are pinned to N, so walks and merges rank every
    candidate and the filter acts as a pure id mask.  Scores bit-equal,
    ids equal up to order inside tie groups.
  * Against the reference's filtered search on an index the reference
    built and the port loaded: bit-exact on the integer arms, within rtol
    1e-6 of the row scale on the fp32 ones (fp32 arms: ``flat``, ``pq16``'s
    fp32 LUT, and every stream arm, whose multi-source merge re-scores in
    fp32), ids equal outside near-ties.

The stream arms are built with writes after the bulk load, so they hold a
memtable and more than one segment.  The cascade arms and the regions
arms are the reference's own conformance factories.
"""

import io

import numpy as np
import pytest

from repro.filter import Filter as RFilter
from repro.knn import SearchParams as RSearchParams
from repro.knn import make_index as r_make_index
from repro_torch.filter import Filter
from repro_torch.knn import SearchParams, kinds, load_index, make_index
from repro_torch.knn import parse_factory
from repro_torch.testing import (build_with_writes, fp32_near_equal,
                                 post_filter, tie_groups_equal)

K = 10
N, D = 384, 32

#: factory -> build overrides; every ported kind appears at least once
FACTORIES = {
    "flat": {},
    "flat,lpq8@global_minmax": {},
    "flat,lpq4+r32": {},
    "pq16+lpq": {"kmeans_iters": 4},
    "pq16x4,lpq8": {"kmeans_iters": 4},
    "pq16": {"kmeans_iters": 4},
    "ivf8,lpq8@global_minmax": {"kmeans_iters": 4},
    "hnsw8,lpq8@global_minmax": {"ef_construction": 40, "batch_size": 128},
    "graph16,lpq8@global_minmax": {"n_seeds": 16},
    "stream(flat,lpq4@global_absmax)+r32": {"seal_threshold": 128},
    "stream(pq16x4,lpq8)+r32": {"seal_threshold": 128, "kmeans_iters": 4},
    # the cascade kind and per-region constants, with the reference's own
    # conformance overrides (tests/test_conformance.py:44-53)
    "cascade(flat,lpq4|r32)": {},
    "cascade(pq16x4|lpq8|r32)": {"kmeans_iters": 4},
    "stream(cascade(flat,lpq8|r32))": {"seal_threshold": 128},
    "ivf8,lpq8,regions": {"kmeans_iters": 4},
    "hnsw8,lpq8,regions": {"ef_construction": 40, "batch_size": 128},
    "graph16,lpq4,regions": {"n_seeds": 16},
}

#: arms whose final scores are fp32 (held within rtol against the
#: reference): fp32 stores and LUTs, fp32 merges and final cascade stages,
#: and regional re-scores (fp32 queries against dequantized rows)
FP32_ARMS = {"flat", "flat,lpq4+r32", "pq16",
             "stream(flat,lpq4@global_absmax)+r32",
             "stream(pq16x4,lpq8)+r32",
             "cascade(flat,lpq4|r32)", "cascade(pq16x4|lpq8|r32)",
             "stream(cascade(flat,lpq8|r32))", "ivf8,lpq8,regions",
             "hnsw8,lpq8,regions", "graph16,lpq4,regions"}

#: survivors < k (0.02 of 384 leaves ~8 rows), a mid-band filter, and a
#: nearly transparent one
SELECTIVITIES = (0.02, 0.25, 0.9)

#: rows the stream arms bulk-load; the rest arrive as upserts
BULK = 200


def _allow(sel: float) -> np.ndarray:
    rng = np.random.default_rng(int(sel * 1000) + 7)
    mask = rng.random(N) < sel
    if not mask.any():
        mask[0] = True
    return mask


def _build(make, factory, corpus, **kw):
    """Build an arm; a stream arm bulk-loads BULK rows, then takes the rest
    as upserts (one seal at 128 rows, a memtable tail) and a few deletes
    that the filter never sees, upserted back at the tail."""
    over = FACTORIES[factory]
    if not factory.startswith("stream"):
        return make(factory, corpus, **over, **kw)
    return build_with_writes(make, factory, corpus, bulk=BULK, chunk=N,
                             dead=np.arange(5, 40, 7), revive=True,
                             **over, **kw)


@pytest.fixture(scope="module")
def corpus_queries():
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((N, D)).astype(np.float32) * 0.05
    queries = rng.standard_normal((8, D)).astype(np.float32) * 0.05
    return corpus, queries


@pytest.fixture(scope="module")
def built(corpus_queries):
    """The port's own CPU builds."""
    corpus, _ = corpus_queries
    return {f: _build(make_index, f, corpus, device="cpu") for f in FACTORIES}


@pytest.fixture(scope="module")
def reference_built(corpus_queries):
    """Each arm built by the reference, and the same index loaded in the
    port from the reference's npz."""
    import jax

    corpus, _ = corpus_queries
    out = {}
    for f in FACTORIES:
        ref = _build(r_make_index, f, corpus, key=jax.random.PRNGKey(0))
        buf = io.BytesIO()
        ref.save(buf)
        out[f] = (ref, load_index(io.BytesIO(buf.getvalue()), device="cpu"))
    return out


def _depth_searcher(idx, k, sp):
    """A one-shot searcher whose rerank depth is the whole corpus, so an
    arm that owns a re-scoring stage ranks every candidate."""
    kw = {}
    if getattr(idx, "handles_rerank", False) or \
            getattr(idx, "rerank_store", None) is not None:
        kw["rerank"] = N
    return idx.searcher(k, sp, batch_sizes=None, strict=False, **kw)


def test_filtered_matrix_covers_every_ported_kind():
    """A new kind cannot dodge filtered conformance: FACTORIES (with the
    stream arms' inner kinds) covers every kind ``kinds()`` lists."""
    covered = {parse_factory(f).kind for f in FACTORIES}
    covered |= {parse_factory(parse_factory(f).params["inner"]).kind
                for f in FACTORIES if parse_factory(f).kind == "stream"}
    assert covered == set(kinds()), set(kinds()) - covered


@pytest.mark.parametrize("sel", SELECTIVITIES)
@pytest.mark.parametrize("factory", sorted(FACTORIES))
def test_filtered_search_matches_post_filter_oracle(factory, sel,
                                                    corpus_queries, built):
    _corpus, queries = corpus_queries
    idx = built[factory]
    allow = _allow(sel)
    filt = Filter.from_mask(allow)
    full = _depth_searcher(idx, N, SearchParams(nprobe=8, ef_search=N))(
        queries)
    oscores, oids = post_filter(full.scores.numpy(), full.ids.numpy(),
                                allow, K)
    res = _depth_searcher(idx, K, SearchParams(nprobe=8, ef_search=N,
                                               filter=filt))(queries)
    scores, ids = res.scores.numpy(), res.ids.numpy()
    assert allow[ids[ids >= 0]].all(), f"{factory}@{sel}: disallowed id"
    assert res.stats["filter_selectivity"] == round(filt.selectivity, 6)
    np.testing.assert_array_equal(scores, oscores, err_msg=factory)
    assert tie_groups_equal(scores, ids, oids), f"{factory}@{sel}"


@pytest.mark.parametrize("sel", SELECTIVITIES)
@pytest.mark.parametrize("factory", sorted(FACTORIES))
def test_filtered_search_equals_the_reference(factory, sel, corpus_queries,
                                              reference_built):
    """The reference's filtered one-shot search and the port's, on the
    index the reference built (the port loaded its npz)."""
    _corpus, queries = corpus_queries
    ref, port = reference_built[factory]
    allow = _allow(sel)
    want = ref.search(queries, K, RSearchParams(
        nprobe=4, ef_search=60, filter=RFilter.from_mask(allow)))
    got = port.search(queries, K, SearchParams(
        nprobe=4, ef_search=60, filter=Filter.from_mask(allow)))
    rs, ri = np.asarray(want.scores), np.asarray(want.ids)
    gs, gi = got.scores.numpy(), got.ids.numpy()
    assert allow[gi[gi >= 0]].all()
    if factory in FP32_ARMS:
        assert fp32_near_equal(gs, gi, rs, ri, 1e-6)[0], f"{factory}@{sel}"
    else:
        np.testing.assert_array_equal(gi, ri, err_msg=f"{factory}@{sel}")
        np.testing.assert_array_equal(gs, rs, err_msg=f"{factory}@{sel}")
    for key in ("filter_selectivity", "filter_lists_skipped"):
        assert got.stats.get(key) == want.stats.get(key), key
