"""The port's recsys retrieval slice (``repro_torch.models.recsys``,
``repro_torch.launch.steps.make_retrieval``, ``repro_torch.configs``)
against the reference on identical numpy tables and queries, on the CPU.

Tolerances: integer paths are exact (int8 codes, Eq. 1 constants of the
abs-max and min-max schemes, the quantized retrieval's ids and f32-cast
int32 scores, ties included).  Float gathers and bag sums: rtol 1e-6
(torch and XLA sum a bag in different orders).  The fp32 retrieval arm:
scores within rtol 1e-6 (the two libraries sum a dot in different orders),
ids equal outside near-tie groups.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import base as RB  # noqa: E402
from repro.configs import dlrm_mlperf as RDL  # noqa: E402
from repro.core import quant as RQ  # noqa: E402
from repro.core.preserve import recall_at_k as ref_recall  # noqa: E402
from repro.launch import steps as RS  # noqa: E402
from repro.models.recsys import embedding as RE  # noqa: E402
from repro.models.recsys import retrieval as RRT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.configs import dlrm_mlperf as TDL  # noqa: E402
from repro_torch.core.preserve import recall_at_k  # noqa: E402
from repro_torch.launch import make_retrieval  # noqa: E402
from repro_torch.models.recsys import RecsysConfig  # noqa: E402
from repro_torch.models.recsys import embedding as TE  # noqa: E402
from repro_torch.models.recsys import retrieval as TRT  # noqa: E402


def _table(n, d, seed):
    """The reference's table_init distribution, N(0, 1) * d^-1/2, drawn
    with numpy so both packages see the same numbers."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d), dtype=np.float32) * np.float32(d ** -0.5)


def _tie_table(n, d, seed):
    """Values in {-0.5, 0, 0.5}: abs-max codes in {-128, 0, 127}, so the
    int scores take few values and tie in long runs at the k-th place."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-1, 2, (n, d)) * 0.5).astype(np.float32)


def _ref_qt(table, **kw):
    return RE.QuantizedTable.from_dense(jnp.asarray(table), **kw)


def _assert_fp32_topk_close(got, want, q, table):
    """Scores within rtol 1e-6; where ids differ, both ids' exact (float64)
    scores are within that tolerance of each other (a near-tie)."""
    (gs, gi), (ws, wi) = got, want
    tol = 1e-6 * (np.abs(ws).max(axis=1, keepdims=True) + 1e-6)
    assert np.all(np.abs(gs - ws) <= tol)
    exact = q.astype(np.float64) @ table.astype(np.float64).T
    rows, cols = np.nonzero(gi != wi)
    for r, c in zip(rows, cols):
        assert abs(exact[r, gi[r, c]] - exact[r, wi[r, c]]) <= 2 * tol[r, 0]


# -- QuantizedTable and the embedding substrate --------------------------------

@pytest.mark.parametrize("bits,scheme", [(8, "absmax"), (4, "absmax"),
                                         (8, "minmax")])
def test_quantized_table_from_dense_matches_reference(bits, scheme):
    table = _table(3000, 24, seed=bits)
    ref = _ref_qt(table, bits=bits, scheme=RQ.Scheme(scheme))
    port = TE.QuantizedTable.from_dense(torch.from_numpy(table), bits=bits,
                                        scheme=scheme)
    np.testing.assert_array_equal(port.codes.numpy(), np.asarray(ref.codes))
    for f in ("lo", "hi", "zero"):
        np.testing.assert_array_equal(getattr(port.params, f).numpy(),
                                      np.asarray(getattr(ref.params, f)))
    assert (port.params.bits, port.params.scheme) == (ref.params.bits,
                                                      ref.params.scheme)
    assert port.memory_bytes() == ref.memory_bytes() == 3000 * 24 + 3 * 24 * 4
    ids = np.array([[0, 5, 2999], [7, 7, 1]])
    np.testing.assert_array_equal(port.lookup_codes(torch.from_numpy(ids)).numpy(),
                                  np.asarray(ref.lookup_codes(jnp.asarray(ids))))
    np.testing.assert_allclose(port.lookup(torch.from_numpy(ids)).numpy(),
                               np.asarray(ref.lookup(jnp.asarray(ids))),
                               rtol=1e-6, atol=0)


def test_lookup_and_quantize_tables_match_reference():
    tables = {f"t{i}": {"table": _table(v, 16, seed=10 + i)}
              for i, v in enumerate((500, 100, 50))}
    ref_tables = {k: {"table": jnp.asarray(v["table"])} for k, v in tables.items()}
    port_tables = {k: {"table": torch.from_numpy(v["table"])}
                   for k, v in tables.items()}
    rng = np.random.default_rng(0)
    ids = np.stack([rng.integers(0, v, 64) for v in (500, 100, 50)], axis=1)
    np.testing.assert_allclose(
        TE.multi_lookup(port_tables, torch.from_numpy(ids)).numpy(),
        np.asarray(RE.multi_lookup(ref_tables, jnp.asarray(ids))), rtol=1e-6)
    ref_q = RE.quantize_tables(ref_tables)
    port_q = TE.quantize_tables(port_tables)
    for name in tables:
        np.testing.assert_array_equal(port_q[name]["codes"].numpy(),
                                      np.asarray(ref_q[name]["codes"]))
        for f in ("scale", "zero"):
            np.testing.assert_allclose(port_q[name][f].numpy(),
                                       np.asarray(ref_q[name][f]), rtol=1e-6)
    got = TE.multi_lookup(port_q, torch.from_numpy(ids))
    want = RE.multi_lookup(ref_q, jnp.asarray(ids))
    assert got.shape == (64, 3, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_reference(combiner, weighted):
    table = _table(200, 12, seed=3)
    rng = np.random.default_rng(4)
    flat_ids = rng.integers(0, 200, 90)
    seg = np.sort(rng.integers(0, 10, 90))       # bag 10 and some others empty
    w = rng.random(90).astype(np.float32) if weighted else None
    got = TE.embedding_bag({"table": torch.from_numpy(table)},
                           torch.from_numpy(flat_ids), torch.from_numpy(seg),
                           12, None if w is None else torch.from_numpy(w),
                           combiner=combiner)
    want = RE.embedding_bag({"table": jnp.asarray(table)}, jnp.asarray(flat_ids),
                            jnp.asarray(seg), 12,
                            None if w is None else jnp.asarray(w),
                            combiner=combiner)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError):
        TE.embedding_bag({"table": torch.from_numpy(table)},
                         torch.from_numpy(flat_ids), torch.from_numpy(seg), 12,
                         combiner="max")


def test_table_init_draws_from_the_generator():
    g = torch.Generator().manual_seed(0)
    tables = TE.multi_table_init(g, (1000, 3), 64, device="cpu")
    assert set(tables) == {"t0", "t1"}
    t = tables["t0"]["table"]
    assert t.shape == (1000, 64) and t.dtype == torch.float32
    assert abs(float(t.std()) - 64 ** -0.5) < 0.01
    again = TE.table_init(torch.Generator().manual_seed(0), 1000, 64,
                          device="cpu")["table"]
    assert torch.equal(again, t)


# -- retrieval -------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "ties"])
def test_retrieve_quantized_matches_reference(case):
    n, nq, k = 3000, 16, 100
    d = 32 if case == "random" else 8
    table = _table(n, d, 5) if case == "random" else _tie_table(n, d, 5)
    queries = _table(nq, d, 6) if case == "random" else _tie_table(nq, d, 6)
    ref_qt = _ref_qt(table)
    port_qt = convert.quantized_table_from_numpy(
        np.asarray(ref_qt.codes), np.asarray(ref_qt.params.lo),
        np.asarray(ref_qt.params.hi), np.asarray(ref_qt.params.zero),
        ref_qt.params.bits, ref_qt.params.scheme, device="cpu")
    ws, wi = RRT.retrieve_quantized(jnp.asarray(queries), ref_qt.codes,
                                    ref_qt.params, k=k)
    gs, gi = TRT.retrieve_quantized(torch.from_numpy(queries), port_qt.codes,
                                    port_qt.params, k=k)
    assert gs.dtype == torch.float32 and gi.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    if case == "ties":
        # the k-th score is shared beyond the k-th place: ids pin the order
        s = np.asarray(ws)
        codes = np.asarray(ref_qt.codes).astype(np.int64)
        full = (np.asarray(RQ.quantize(jnp.asarray(queries), ref_qt.params))
                .astype(np.int64) @ codes.T)
        assert all((full[r] == s[r, -1]).sum() > (s[r] == s[r, -1]).sum()
                   for r in range(nq))


def test_top_k_keeps_lax_top_k_order():
    s = np.array([[0.0, -0.0, 1.0, 1.0, -1.0, 1.0, np.float32(-3e38), 0.0],
                  [2.0] * 8], dtype=np.float32)
    want_s, want_i = jax.lax.top_k(jnp.asarray(s), 5)
    got_s, got_i = TRT.top_k(torch.from_numpy(s), 5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy().view(np.int32),
                                  np.asarray(want_s).view(np.int32))


#: C4: rows holding NaN (the reference's ``lax.top_k`` ranks NaN above
#: +inf), a row of NaN only, and NaN beside +-inf and -0.0
NAN_ROWS = {
    "c4_example": ([[1.0, np.nan, 3.0, 2.0], [4.0, 5.0, 6.0, 7.0]], 2),
    "all_nan": ([[np.nan] * 5, [1.0, 2.0, np.nan, 0.5, 3.0]], 3),
    "nan_inf_zero": ([[-0.0, np.inf, np.nan, -np.inf, 0.0, np.nan, -0.0],
                      [0.0, -0.0, -np.inf, np.inf, np.nan, 1.0, -1.0]], 6),
}


@pytest.mark.parametrize("case", sorted(NAN_ROWS))
def test_top_k_with_nan_matches_lax_top_k(case):
    rows, k = NAN_ROWS[case]
    s = np.array(rows, dtype=np.float32)
    want_s, want_i = jax.lax.top_k(jnp.asarray(s), k)
    got_s, got_i = TRT.top_k(torch.from_numpy(s), k)
    assert got_s.shape == (s.shape[0], k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy().view(np.int32),
                                  np.asarray(want_s).view(np.int32))


def test_retrieval_with_a_nan_table_row_matches_reference():
    """A NaN candidate row: the fp32 arm ranks it first for every query,
    as the reference does, and the quantized arm (on the reference's
    codes of the same table) raises nothing and returns its ids."""
    table, queries = _table(3000, 32, 11), _table(8, 32, 12)
    table[17] = np.nan
    want = RRT.retrieve_fp32(jnp.asarray(queries), jnp.asarray(table), k=40)
    got = TRT.retrieve_fp32(torch.from_numpy(queries),
                            convert.dense_table_from_numpy(table, device="cpu"),
                            k=40)
    gs, gi = got[0].numpy(), got[1].numpy()
    ws, wi = np.asarray(want[0]), np.asarray(want[1])
    assert np.all(wi[:, 0] == 17) and np.all(gi[:, 0] == 17)
    assert np.all(np.isnan(gs[:, 0])) and np.all(np.isnan(ws[:, 0]))
    _assert_fp32_topk_close((gs[:, 1:], gi[:, 1:]), (ws[:, 1:], wi[:, 1:]),
                            queries, table)
    ref_qt = _ref_qt(table)
    port_qt = convert.quantized_table_from_numpy(
        np.asarray(ref_qt.codes), np.asarray(ref_qt.params.lo),
        np.asarray(ref_qt.params.hi), np.asarray(ref_qt.params.zero),
        ref_qt.params.bits, ref_qt.params.scheme, device="cpu")
    ws, wi = RRT.retrieve_quantized(jnp.asarray(queries), ref_qt.codes,
                                    ref_qt.params, k=40)
    gs, gi = TRT.retrieve_quantized(torch.from_numpy(queries), port_qt.codes,
                                    port_qt.params, k=40)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def test_retrieve_fp32_matches_reference():
    table, queries = _table(5000, 64, 7), _table(32, 64, 8)
    want = RRT.retrieve_fp32(jnp.asarray(queries), jnp.asarray(table), k=50)
    got = TRT.retrieve_fp32(torch.from_numpy(queries),
                            convert.dense_table_from_numpy(table, device="cpu"),
                            k=50)
    _assert_fp32_topk_close((got[0].numpy(), got[1].numpy()),
                            (np.asarray(want[0]), np.asarray(want[1])),
                            queries, table)


def test_make_retrieval_both_arms_match_reference():
    table, queries = _table(4000, 128, 9), _table(8, 128, 10)
    ref_qt = _ref_qt(table)
    port_qt = TE.QuantizedTable.from_dense(torch.from_numpy(table))
    p = port_qt.params
    ws, wi = RS.make_retrieval(True, k=100)(
        jnp.asarray(queries), ref_qt.codes, ref_qt.params.lo,
        ref_qt.params.hi, ref_qt.params.zero)
    gs, gi = make_retrieval(True, k=100)(torch.from_numpy(queries),
                                         port_qt.codes, p.lo, p.hi, p.zero)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    want = RS.make_retrieval(False, k=100)(jnp.asarray(queries), jnp.asarray(table))
    got = make_retrieval(False, k=100)(torch.from_numpy(queries),
                                       torch.from_numpy(table))
    _assert_fp32_topk_close((got[0].numpy(), got[1].numpy()),
                            (np.asarray(want[0]), np.asarray(want[1])),
                            queries, table)


def test_recall_at_20000x128_equals_reference():
    """The int8 arm against the fp32 arm, recall@100 at the size
    ``chip_smoke.py`` holds the card to (n=20000, d=128, 128 queries)."""
    table, queries = _table(20000, 128, 11), _table(128, 128, 12)
    ref_qt = _ref_qt(table)
    _, r8 = RRT.retrieve_quantized(jnp.asarray(queries), ref_qt.codes,
                                   ref_qt.params, k=100)
    _, r32 = RRT.retrieve_fp32(jnp.asarray(queries), jnp.asarray(table), k=100)
    want = float(ref_recall(r32, r8))
    step8, step32 = make_retrieval(True), make_retrieval(False)
    qt = TE.QuantizedTable.from_dense(torch.from_numpy(table))
    p = qt.params
    _, p8 = step8(torch.from_numpy(queries), qt.codes, p.lo, p.hi, p.zero)
    _, p32 = step32(torch.from_numpy(queries), torch.from_numpy(table))
    got = recall_at_k(p32, p8)
    assert 0.7 < want < 0.99
    assert abs(got - want) < 1e-6


# -- configs, conversion, devices ------------------------------------------------

def test_configs_are_copies_of_the_reference():
    assert TB.RECSYS_SHAPES == RB.RECSYS_SHAPES
    assert TB.CRITEO_VOCABS == RB.CRITEO_VOCABS
    assert TB.CRITEO_DENSE_BUCKETS == RB.CRITEO_DENSE_BUCKETS
    for fn in ("config", "reduced_config"):
        ref, port = getattr(RDL, fn)(), getattr(TDL, fn)()
        assert isinstance(port, RecsysConfig)
        fields = [f for f in vars(ref) if f != "dtype"]
        assert {f: getattr(port, f) for f in fields} == {
            f: getattr(ref, f) for f in fields}
        assert port.n_sparse == ref.n_sparse
        assert port.param_count() == ref.param_count()
        assert port.tdtype == torch.float32 and str(ref.jdtype) == "float32"
    assert (TDL.ARCH_ID, TDL.FAMILY, TDL.SKIP) == (RDL.ARCH_ID, RDL.FAMILY, RDL.SKIP)
    assert TDL.config().embed_dim == 128


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.table_init(torch.Generator(), 10, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.dense_table_from_numpy(np.zeros((3, 4), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.quantized_table_from_numpy(np.zeros((3, 4), np.int8),
                                           *np.ones((3, 4), np.float32), 8,
                                           "absmax")
    qt = convert.quantized_table_from_numpy(np.zeros((3, 4), np.int8),
                                            *np.ones((3, 4), np.float32), 8,
                                            "absmax", device="cpu")
    assert qt.codes.device.type == "cpu" and qt.memory_bytes() == 12 + 48
