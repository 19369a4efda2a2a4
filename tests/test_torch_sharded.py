"""Sharded plans (DESIGN.md §15) on the CPU: every kind on a mesh of 2 and
4 shards returns what its unsharded plan returns, bit for bit.

* The arms are the reference's ``SHARDED_ARMS``
  (``tests/test_conformance.py``), plus ``flat``, ``flat,lpq4+r32`` and
  ``pq16+lpq``; each is built once by the reference and loaded in the port
  (``device="cpu"``) from its npz.  On ``make_mesh((s,), ("data",),
  ["cpu"] * s)`` for s = 2 and 4, a Searcher's ids and scores equal the
  unsharded Searcher's bit for bit, unfiltered and filtered at 0.02 /
  0.25 / 0.9, with ``stats["shards"]`` and ``["placement"]`` checked.
* At 1 shard the port's mesh plan equals the reference's own mesh plan on
  a one-device ``jax.make_mesh``, in process: bit for bit on the integer
  arms, within rtol 1e-6 with ids equal outside near-ties on the arms
  whose final scores are fp32 (as the unsharded port-to-reference tests).
  At 2 and 4 shards the chain is closed by the reference's own matrix
  (``tests/test_conformance.py``: its sharded plans equal its unsharded
  ones bit for bit), the port's unsharded plans against the reference's
  (``tests/test_torch_conformance.py`` and each kind's file), and this
  file's sharded-to-unsharded equality.
* The fp32-LUT PQ arms (``pq16``, ``pq16x4``) are held within rtol 1e-6:
  the gather-sum scan adds each row's M table entries with ``torch.sum``,
  whose rounding follows the width of the row tile, and a shard's tiles
  are narrower (ROADMAP queue C).
* The pad-aliasing cases of the reference (300 rows, 2 shards, chunk 128;
  97 rows, chunk 10), empty shards, the placement-mismatch errors, a
  ``save`` left byte-identical by a sharded Searcher, and
  ``make_retrieval_sharded`` against ``make_retrieval``.
"""

import io

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.filter import Filter as RFilter  # noqa: E402
from repro.knn import SearchParams as RSearchParams  # noqa: E402
from repro.knn import make_index as r_make_index  # noqa: E402
from repro_torch.dist import make_mesh  # noqa: E402
from repro_torch.dist.placement import Placement  # noqa: E402
from repro_torch.filter import Filter  # noqa: E402
from repro_torch.knn import SearchParams, load_index, make_index  # noqa: E402
from repro_torch.knn import kinds, parse_factory  # noqa: E402
from repro_torch.testing import fp32_near_equal  # noqa: E402

K = 10
N, D = 384, 32

#: the reference's sharded parity arms (tests/test_conformance.py:195)
SHARDED_ARMS = {
    "flat,lpq4": {},
    "ivf8,lpq8": {"kmeans_iters": 4},
    "ivf8,lpq8,regions": {"kmeans_iters": 4},
    "pq16x4,lpq8": {"kmeans_iters": 4},
    "pq16+lpq,l2": {"kmeans_iters": 4},
    "hnsw8,lpq8,regions": {"ef_construction": 40, "batch_size": 128},
    "graph16,lpq4,regions": {"n_seeds": 16},
    "stream(ivf8,lpq8)+r32": {"seal_threshold": 128, "kmeans_iters": 4},
    "cascade(flat,lpq4|r32)": {},
}
ARMS = {**SHARDED_ARMS, "flat": {}, "flat,lpq4+r32": {},
        "pq16+lpq": {"kmeans_iters": 4}}

#: arms whose final scores are fp32: held to the reference within rtol
FP32_ARMS = {"flat", "flat,lpq4+r32", "ivf8,lpq8,regions",
             "hnsw8,lpq8,regions", "graph16,lpq4,regions",
             "stream(ivf8,lpq8)+r32", "cascade(flat,lpq4|r32)"}

#: the placement each arm elects
PLACEMENT = {"flat": "rows", "pq": "rows", "ivf": "lists",
             "hnsw": "replicated", "graph": "replicated",
             "stream": "segments", "cascade": "rows"}

SELECTIVITIES = (0.02, 0.25, 0.9)
SP = dict(nprobe=8, ef_search=40)


def _mesh(s: int):
    return make_mesh((s,), ("data",), ["cpu"] * s)


def _allow(sel: float) -> np.ndarray:
    rng = np.random.default_rng(int(sel * 1000) + 7)
    mask = rng.random(N) < sel
    if not mask.any():
        mask[0] = True
    return mask


@pytest.fixture(scope="module")
def corpus_queries():
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((N, D)).astype(np.float32) * 0.05
    queries = rng.standard_normal((8, D)).astype(np.float32) * 0.05
    return corpus, queries


@pytest.fixture(scope="module")
def built(corpus_queries):
    """factory -> (the reference's index, the port's load of its npz)."""
    corpus, _ = corpus_queries
    out = {}
    for f, over in ARMS.items():
        ref = r_make_index(f, corpus, key=jax.random.PRNGKey(0), **over)
        buf = io.BytesIO()
        ref.save(buf)
        out[f] = (ref, load_index(io.BytesIO(buf.getvalue()), device="cpu"))
    return out


def _equal(a, b, tag):
    np.testing.assert_array_equal(a.ids.numpy(), b.ids.numpy(), err_msg=tag)
    np.testing.assert_array_equal(a.scores.numpy(), b.scores.numpy(),
                                  err_msg=tag)


def test_arms_cover_every_kind():
    covered = {parse_factory(f).kind for f in SHARDED_ARMS}
    covered |= {parse_factory(parse_factory(f).params["inner"]).kind
                for f in SHARDED_ARMS if parse_factory(f).kind == "stream"}
    assert covered == set(kinds()), set(kinds()) - covered


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("factory", sorted(ARMS))
def test_sharded_equals_unsharded(factory, shards, corpus_queries, built):
    _corpus, queries = corpus_queries
    _ref, idx = built[factory]
    sp = SearchParams(**SP)
    un = idx.searcher(K, sp)(queries)
    sh = idx.searcher(K, sp, shards=_mesh(shards))(queries)
    _equal(un, sh, f"{factory} @ {shards} shards")
    assert sh.stats["shards"] == shards
    assert sh.stats["placement"] == PLACEMENT[parse_factory(factory).kind]
    assert "placement_balance" in sh.stats
    if sh.stats["placement"] in ("rows", "lists"):
        assert sh.stats["merge_wire_bytes"] > 0


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("sel", SELECTIVITIES)
@pytest.mark.parametrize("factory", sorted(SHARDED_ARMS))
def test_filtered_sharded_equals_unsharded(factory, sel, shards,
                                           corpus_queries, built):
    _corpus, queries = corpus_queries
    _ref, idx = built[factory]
    allow = _allow(sel)
    sp = SearchParams(**SP, filter=Filter.from_mask(allow))
    un = idx.searcher(K, sp)(queries)
    ids = un.ids.numpy()
    assert allow[ids[ids >= 0]].all()
    sh = idx.searcher(K, sp, shards=_mesh(shards))(queries)
    _equal(un, sh, f"{factory}@{sel} @ {shards} shards")


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("factory", sorted(ARMS))
def test_one_shard_equals_the_reference_mesh_plan(factory, filtered,
                                                  corpus_queries, built):
    """The reference's own sharded Searcher on a one-device mesh, in this
    process, against the port's on a one-shard mesh."""
    _corpus, queries = corpus_queries
    ref, idx = built[factory]
    allow = _allow(0.25)
    rsp = RSearchParams(**SP, filter=RFilter.from_mask(allow)
                        if filtered else None)
    tsp = SearchParams(**SP, filter=Filter.from_mask(allow)
                       if filtered else None)
    want = ref.searcher(K, rsp, shards=jax.make_mesh((1,), ("data",)))(
        queries)
    got = idx.searcher(K, tsp, shards=_mesh(1))(queries)
    ws, wi = np.asarray(want.scores), np.asarray(want.ids)
    gs, gi = got.scores.numpy(), got.ids.numpy()
    if factory in FP32_ARMS:
        assert fp32_near_equal(gs, gi, ws, wi, 1e-6)[0], factory
    else:
        np.testing.assert_array_equal(gi, wi, err_msg=factory)
        np.testing.assert_array_equal(gs, ws, err_msg=factory)
    for key in ("shards", "placement", "placement_balance"):
        assert got.stats[key] == want.stats[key], key


@pytest.mark.parametrize("factory", ["stream(ivf8,lpq8)+r32",
                                     "stream(flat,lpq4)+r32"])
def test_written_stream_shards_by_segments(factory, corpus_queries):
    """A stream with sealed segments and a memtable (bulk load, upserts,
    deletes upserted back): its placement has one unit a source, and its
    sharded plans equal the unsharded one, filtered too."""
    from repro_torch.testing import build_with_writes

    corpus, queries = corpus_queries
    idx = build_with_writes(make_index, factory, corpus, bulk=200, chunk=N,
                            dead=np.arange(5, 40, 7), revive=True,
                            device="cpu", seal_threshold=64, kmeans_iters=4)
    for s in (2, 4):
        pl = idx.placement(s)
        assert pl.kind == "segments"
        assert pl.n_units == len(idx.manifest.segments) + 1   # + memtable
        for sp in (SearchParams(**SP), SearchParams(
                **SP, filter=Filter.from_mask(_allow(0.25)))):
            un = idx.searcher(K, sp)(queries)
            sh = idx.searcher(K, sp, shards=_mesh(s))(queries)
            _equal(un, sh, f"{factory} @ {s} shards")
            assert sh.stats["placement_balance"] == pl.summary()["balance"]


@pytest.mark.parametrize("factory", ["pq16", "pq16x4"])
def test_fp32_lut_arms_within_the_fp32_contract(factory, corpus_queries):
    corpus, queries = corpus_queries
    idx = make_index(factory, corpus, device="cpu", kmeans_iters=4)
    un = idx.searcher(K)(queries)
    for s in (2, 4):
        sh = idx.searcher(K, shards=_mesh(s))(queries)
        assert fp32_near_equal(sh.scores.numpy(), sh.ids.numpy(),
                               un.scores.numpy(), un.ids.numpy(), 1e-6)[0]


@pytest.mark.parametrize("factory", ["flat", "flat,lpq8@gaussian:3",
                                     "flat,lpq4", "pq8+lpq", "pq8x4,lpq8"])
def test_pad_aliasing_and_empty_shards(factory):
    """The reference's aliasing regressions (300 rows over 2 shards at
    chunk 128; 97 rows at chunk 10) and more shards than rows.  One fp32
    case is held within rtol 1e-6: with one row a shard, the CPU's fp32
    product of the plain scan takes a matrix-vector path that rounds
    otherwise than the matrix product of the unsharded scan (on the card
    B2 fp32 sums each dot in one order whatever the shape)."""
    rng = np.random.RandomState(0)
    for n, chunk, k, meshes in ((300, 128, 20, (2, 3)), (97, 10, 20, (2, 4)),
                                (3, 16384, 3, (4, 7))):
        corpus = rng.randn(n, 16).astype(np.float32)
        queries = rng.randn(9, 16).astype(np.float32)
        idx = make_index(factory, corpus, device="cpu", kmeans_iters=2)
        sp = SearchParams(chunk=chunk)
        un = idx.searcher(k, sp)(queries)
        for s in meshes:
            sh = idx.searcher(k, sp, shards=_mesh(s))(queries)
            if factory == "flat" and n < s * 2:
                assert fp32_near_equal(sh.scores.numpy(), sh.ids.numpy(),
                                       un.scores.numpy(), un.ids.numpy(),
                                       1e-6)[0]
            else:
                _equal(un, sh, f"{factory} n={n} @ {s} shards")
            assert (sh.ids.numpy() < n).all()
        # k past n: the uniform [Q, k] contract pads (NEG, -1)
        one = idx.searcher(n + 5, sp, shards=_mesh(2), strict=False)(queries)
        ref = idx.searcher(n + 5, sp, strict=False)(queries)
        assert one.ids.shape == (9, n + 5)
        np.testing.assert_array_equal(one.ids.numpy()[:, n:], -1)
        if factory != "flat":
            _equal(ref, one, f"{factory} n={n} k > n")


def test_placement_mismatches_raise(built):
    mesh = _mesh(2)
    sp = SearchParams(**SP)
    ivf = built["ivf8,lpq8"][1]
    graph = built["graph16,lpq4,regions"][1]
    hnsw = built["hnsw8,lpq8,regions"][1]
    flat = built["flat"][1]
    pq = built["pq16+lpq"][1]
    stream = built["stream(ivf8,lpq8)+r32"][1]
    with pytest.raises(ValueError, match="place whole lists"):
        ivf.plan(K, sp, mesh=mesh, placement=Placement.rows(ivf.n, 2))
    with pytest.raises(ValueError, match="covers 3 shards but the mesh has 2"):
        ivf.plan(K, sp, mesh=mesh,
                 placement=Placement.lists(ivf.list_sizes(), 3))
    for walk in (graph, hnsw):
        with pytest.raises(ValueError, match="only replicates"):
            walk.plan(K, sp, mesh=mesh, placement=Placement.rows(walk.n, 2))
    with pytest.raises(ValueError, match="shards contiguous row blocks"):
        flat.plan(K, sp, mesh=mesh, placement=Placement.lists([flat.n], 2))
    with pytest.raises(ValueError, match="covers 4 shards but the mesh has 2"):
        flat.plan(K, sp, mesh=mesh, placement=Placement.rows(flat.n, 4))
    with pytest.raises(ValueError, match="shards contiguous row blocks"):
        pq.plan(K, sp, mesh=mesh, placement=Placement.replicated(pq.n, 2))
    with pytest.raises(ValueError, match="place whole segments"):
        stream.plan(K, sp, mesh=mesh, placement=Placement.rows(stream.n, 2))


@pytest.mark.parametrize("factory", ["flat,lpq4", "pq16+lpq", "pq16x4,lpq8"])
def test_a_rows_placement_is_scanned_as_given(factory, built, corpus_queries):
    """A ``rows`` placement other than ``Placement.rows`` (uneven blocks,
    one shard owning two of them, an empty one) is scanned block by block
    as it says, bit-equal to the unsharded plan; one built for another
    row count raises."""
    _corpus, queries = corpus_queries
    idx = built[factory][1]
    sp = SearchParams(**SP)
    un = idx.searcher(K, sp)(queries)
    given = Placement("rows", 2, (1, 0, 1, 0), (5, 0, N - 105, 100))
    sh = idx.plan(K, sp, mesh=_mesh(2),
                  placement=given)(torch.from_numpy(queries))
    _equal(un, sh, f"{factory} on {given}")
    assert sh.stats["placement"] == "rows"
    with pytest.raises(ValueError, match=f"covers {N - 1} rows but the "
                       f"store holds {N}"):
        idx.plan(K, sp, mesh=_mesh(2), placement=Placement.rows(N - 1, 2))


def test_a_based_store_refuses_a_sharded_scan():
    from repro_torch import engine
    from repro_torch.knn.searcher import sharded_scan_plan

    store = engine.CodeStore.dense(torch.zeros(8, 4), base=5)
    with pytest.raises(ValueError, match="base-0 store"):
        sharded_scan_plan(store, "ip", 3, _mesh(2))


def test_a_sharded_searcher_leaves_save_byte_identical(built, tmp_path,
                                                       corpus_queries):
    """After an unsharded plan (whose first plan of a stream builds the
    merge store and counts it), a sharded one changes nothing saved."""
    _corpus, queries = corpus_queries
    for f in ("ivf8,lpq8", "stream(ivf8,lpq8)+r32", "flat,lpq4"):
        idx = built[f][1]
        idx.searcher(K, SearchParams(**SP))(queries)
        before, after = tmp_path / "a.npz", tmp_path / "b.npz"
        idx.save(before)
        idx.searcher(K, SearchParams(**SP), shards=_mesh(4))(queries)
        idx.save(after)
        assert before.read_bytes() == after.read_bytes(), f


@pytest.mark.parametrize("quantized", [True, False])
def test_make_retrieval_sharded_equals_make_retrieval(quantized):
    from repro_torch.core import quant as Qz
    from repro_torch.launch.steps import make_retrieval, make_retrieval_sharded

    rng = np.random.default_rng(1)
    n, d, k = 4000, 64, 50
    table = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    # integer-valued rows make many equal scores: the tie order is tested
    table[::7] = torch.round(table[::7])
    q = torch.from_numpy(rng.standard_normal((33, d)).astype(np.float32))
    if quantized:
        p = Qz.learn_params(table, bits=8, scheme="absmax")
        args = (Qz.quantize(table, p), p.lo, p.hi, p.zero)
    else:
        args = (table,)
    want = make_retrieval(quantized, k=k)(q, *args)
    for s in (1, 2, 4):
        got = make_retrieval_sharded(_mesh(s), n // s, k=k,
                                     quantized=quantized)(q, *args)
        np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
        np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    with pytest.raises(ValueError, match="not 4 shards"):
        make_retrieval_sharded(_mesh(4), n // 8, k=k,
                               quantized=quantized)(q, *args)
