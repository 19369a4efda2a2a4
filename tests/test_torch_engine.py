"""The port's scoring engine (``repro_torch.engine``) against the
reference's (``repro.engine``) on the same codes and Eq. 1 constants.

On the CPU both packages take the streaming scan, so integer arms are
bit-equal in ids and scores and the stats blocks
(candidates, chunks, bytes_read, bits, packed) are equal.  fp32 arms:
scores within rtol 1e-6 of the row's scale (summation order differs),
ids equal outside near-ties.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import engine as RE  # noqa: E402
from repro.knn.spec import QuantSpec as RQuantSpec  # noqa: E402
from repro.tune import table as tunetable  # noqa: E402
from repro_torch import engine as TE  # noqa: E402

NEG = float(np.finfo(np.float32).min)
N, D, Q = 1000, 24, 13

STORES = ["fp32", "lpq8", "lpq4", "lpq4x5"]   # lpq4x5: packed int4, odd d


@pytest.fixture(autouse=True)
def _no_tune_table():
    # the reference consults a process-wide TuneTable; compare untuned
    with tunetable.pinned(None):
        yield


def _stores(kind, base=0):
    rng = np.random.default_rng(0)
    d = 25 if kind == "lpq4x5" else D
    x = (rng.standard_normal((N, d)) * 0.05).astype(np.float32)
    q = (rng.standard_normal((Q, d)) * 0.05).astype(np.float32)
    if kind == "fp32":
        r = RE.CodeStore.dense(jnp.asarray(x), base=base)
    else:
        r = RQuantSpec(bits=4 if kind.startswith("lpq4") else 8,
                       scheme="gaussian", sigmas=2.0).build_store(
                           jnp.asarray(x), base=base)
    arrays, meta = r.state()
    t = TE.CodeStore.from_state({k: np.asarray(v) for k, v in arrays.items()},
                                meta, device="cpu")
    return r, t, q


def _same(got, want, fp32):
    gs, gi = (np.asarray(a) for a in got)
    ws, wi = (np.asarray(a) for a in want)
    if not fp32:
        assert np.array_equal(gi, wi) and np.array_equal(gs, ws)
        return
    scale = np.abs(ws).max(axis=1, keepdims=True) + 1.0
    assert np.all(np.abs(gs - ws) <= 1e-6 * scale)
    assert (gi != wi).mean() < 0.05


@pytest.mark.parametrize("kind", STORES)
@pytest.mark.parametrize("metric", ["ip", "l2", "angular"])
def test_topk_matches_reference_scan(kind, metric):
    r, t, q = _stores(kind)
    assert (t.n, t.d, t.bits, t.packed, t.d_eff, t.row_bytes, t.memory_bytes()) == \
        (r.n, r.d, r.bits, r.packed, r.d_eff, r.row_bytes, r.memory_bytes())
    assert np.array_equal(t.encode_queries(q).numpy(),
                          np.asarray(r.encode_queries(jnp.asarray(q))))
    # chunk 256 over 1000 rows: four scan chunks, the last one ragged
    rs, ri, rst = RE.topk(jnp.asarray(q), r, 10, metric, chunk=256)
    ts, ti, tst = TE.topk(torch.from_numpy(q), t, 10, metric, chunk=256)
    _same((ts, ti), (rs, ri), kind == "fp32")
    assert tst == rst


@pytest.mark.parametrize("kind", STORES)
def test_topk_mask_base_and_k_beyond_n(kind):
    r, t, q = _stores(kind, base=500)
    mask = np.random.default_rng(1).random(N) < 0.3
    rs, ri, rst = RE.topk(jnp.asarray(q), r, 8, "l2", chunk=300,
                          mask=jnp.asarray(mask))
    ts, ti, tst = TE.topk(torch.from_numpy(q), t, 8, "l2", chunk=300,
                          mask=torch.from_numpy(mask))
    _same((ts, ti), (rs, ri), kind == "fp32")
    assert tst == rst and ti.min() >= 500
    # k > n pads the tail with (float32 min, -1)
    small_r = RE.CodeStore.dense(jnp.asarray(q[:3]))
    small_t = TE.CodeStore.dense(q[:3], device="cpu")
    rs, ri, rst = RE.topk(jnp.asarray(q), small_r, 5, "ip")
    ts, ti, tst = TE.topk(torch.from_numpy(q), small_t, 5, "ip")
    assert np.array_equal(ti.numpy(), np.asarray(ri)) and tst == rst
    assert np.all(ts.numpy()[:, 3:] == NEG)


@pytest.mark.parametrize("kind", STORES)
@pytest.mark.parametrize("metric", ["ip", "l2", "angular"])
def test_topk_among_and_rerank_match_reference(kind, metric):
    r, t, q = _stores(kind)
    rng = np.random.default_rng(2)
    cand = rng.integers(0, N, (Q, 40)).astype(np.int32)
    cand[:, ::7] = -1                               # empty slots
    qr = r.encode_queries(jnp.asarray(q))
    qt = t.encode_queries(q)
    rs, ri = RE.topk_among(qr, r, jnp.asarray(cand), 12, metric)
    ts, ti = TE.topk_among(qt, t, torch.from_numpy(cand), 12, metric)
    _same((ts, ti), (rs, ri), kind == "fp32")
    rs, ri, rst = RE.rerank_among(jnp.asarray(q), r, jnp.asarray(cand), 50, metric)
    ts, ti, tst = TE.rerank_among(torch.from_numpy(q), t, torch.from_numpy(cand),
                                  50, metric)
    _same((ts, ti), (rs, ri), kind == "fp32")
    assert tst == rst


def test_chunked_topk_and_merge_match_reference():
    rng = np.random.default_rng(3)
    x = rng.integers(-3, 4, (700, 8)).astype(np.int8)   # ties everywhere
    q = rng.integers(-3, 4, (5, 8)).astype(np.int8)
    from repro.core import distances as RD
    from repro_torch.core import distances as TD

    rs, ri = RE.chunked_topk(jnp.asarray(q), jnp.asarray(x), 30,
                             lambda a, b: RD.qip_scores(a, b), chunk=128)
    ts, ti = TE.chunked_topk(torch.from_numpy(q), torch.from_numpy(x), 30,
                             TD.qip_scores, chunk=128)
    assert np.array_equal(ti.numpy(), np.asarray(ri))
    assert np.array_equal(ts.numpy(), np.asarray(rs))
    ids = np.arange(12, dtype=np.int32)[None].repeat(2, 0)
    s = np.repeat(np.float32([3, 1, 2]), 4)[None].repeat(2, 0)
    a = RE.merge_topk(jnp.asarray(s[:, :6]), jnp.asarray(ids[:, :6]),
                      jnp.asarray(s[:, 6:]), jnp.asarray(ids[:, 6:]), 7)
    b = TE.merge_topk(*(torch.from_numpy(v) for v in
                        (s[:, :6], ids[:, :6], s[:, 6:], ids[:, 6:])), 7)
    assert np.array_equal(b[1].numpy(), np.asarray(a[1]))


def test_remap_ids_and_score_set_match_reference():
    ids = np.array([[0, 3, -1, 2]], np.int32)
    id_map = np.array([10, 11, 12, 13], np.int32)
    assert np.array_equal(
        TE.remap_ids(torch.from_numpy(ids), torch.from_numpy(id_map)).numpy(),
        np.asarray(RE.remap_ids(jnp.asarray(ids), jnp.asarray(id_map))))
    r, t, q = _stores("lpq4x5")
    rows = np.array([1, 5, 999], np.int32)
    qc = np.asarray(r.encode_queries(jnp.asarray(q)))[0]
    want = RE.make_score_set(r, "l2")(jnp.asarray(qc), jnp.asarray(rows))
    got = TE.make_score_set(t, "l2")(torch.from_numpy(qc), torch.from_numpy(rows))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert TE.pad_rows(torch.zeros(5, 2), 4)[0].shape == (8, 2)
