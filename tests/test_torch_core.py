"""The port's core (``repro_torch.core``) against the reference's
(``repro.core``) on identical numpy inputs, plus the port's package rules.

Tolerances: learned Eq. 1 constants are fp32 reductions whose summation
order differs between XLA and torch, so they agree to rtol 1e-6 with an
absolute slack of 1e-6 x the data's scale (a mean near zero has no
meaningful relative error).  Given the same constants, codes are
bit-equal; integer distances are bit-equal; fp32 distances agree to
1e-6 x the size of the terms summed (|q| |x|).
"""

import re
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import distances as RD  # noqa: E402
from repro.core import pack as RP  # noqa: E402
from repro.core import preserve as RPR  # noqa: E402
from repro.core import quant as RQ  # noqa: E402
from repro.kernels import ops as RK  # noqa: E402
from repro_torch.core import distances as TD  # noqa: E402
from repro_torch.core import pack as TP  # noqa: E402
from repro_torch.core import preserve as TPR  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.core import stats as TS  # noqa: E402
from repro_torch.kernels import ops as TK  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _corpus(seed=0, n=2048, d=48, scale=0.05, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) * scale + shift).astype(np.float32)


# -- packing ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 8), (33, 64), (1, 2)])
def test_pack_int4_bytes_equal_reference(shape):
    rng = np.random.default_rng(shape[1])
    codes = rng.integers(-8, 8, shape).astype(np.int8)
    want = np.array(RP.pack_int4(jnp.asarray(codes)))
    got = TP.pack_int4(torch.from_numpy(codes)).numpy()
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    back = TP.unpack_int4(torch.from_numpy(want)).numpy()
    assert np.array_equal(back, np.asarray(RP.unpack_int4(jnp.asarray(want))))
    assert np.array_equal(back, codes)


@pytest.mark.parametrize("m", [7, 8])
def test_pack_uint4_bytes_equal_reference(m):
    rng = np.random.default_rng(m)
    codes = rng.integers(0, 16, (9, m)).astype(np.uint8)
    want = np.array(RP.pack_uint4(jnp.asarray(codes)))
    got = TP.pack_uint4(torch.from_numpy(codes)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(TP.unpack_uint4(torch.from_numpy(want)).numpy(),
                          np.asarray(RP.unpack_uint4(jnp.asarray(want))))


# -- stats and learned constants ---------------------------------------------

def test_corpus_stats_match_reference():
    x = _corpus(shift=0.01)
    r = __import__("repro.core.stats", fromlist=["corpus_stats"]).corpus_stats(
        jnp.asarray(x))
    t = TS.corpus_stats(torch.from_numpy(x))
    for f in ("count", "mean", "m2", "amax", "vmin", "vmax"):
        np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(r, f)),
                                   rtol=1e-6, atol=1e-6 * 0.05)
    e = TS.corpus_stats(torch.zeros((0, 4)))
    assert float(e.count) == 0 and bool(torch.all(torch.isinf(e.vmin)))


@pytest.mark.parametrize("scheme", [s.value for s in RQ.Scheme])
@pytest.mark.parametrize("bits,sigmas", [(8, 1.0), (4, 3.0)])
def test_learned_params_match_reference(scheme, bits, sigmas):
    x = _corpus(seed=1, shift=0.02)
    r = RQ.learn_params(jnp.asarray(x), bits=bits, scheme=scheme, sigmas=sigmas)
    t = TQ.learn_params(torch.from_numpy(x), bits=bits, scheme=scheme,
                        sigmas=sigmas)
    assert (t.bits, t.scheme) == (r.bits, r.scheme)
    slack = 1e-6 * float(np.abs(x).max())
    for f in ("lo", "hi", "zero"):
        np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(r, f)),
                                   rtol=1e-6, atol=slack)


@pytest.mark.parametrize("bits", [8, 4])
def test_acc_dtype_is_the_references(bits):
    x = np.random.default_rng(3).standard_normal((64, 8)).astype(np.float32)
    r = RQ.learn_params(jnp.asarray(x), bits=bits)
    t = TQ.learn_params(torch.from_numpy(x), bits=bits)
    assert t.acc_dtype == torch.int32
    assert str(t.acc_dtype).split(".")[-1] == jnp.dtype(r.acc_dtype).name
    assert str(t.storage_dtype).split(".")[-1] == \
        jnp.dtype(r.storage_dtype).name


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n", [1, 37, 1030])
def test_codes_bit_equal_given_same_params(bits, n):
    x = _corpus(seed=2, n=n, d=40, scale=0.2)
    r = RQ.learn_params(jnp.asarray(x), bits=bits, scheme="gaussian", sigmas=1.5)
    lo, hi, zero = (np.asarray(a) for a in (r.lo, r.hi, r.zero))
    want_k = np.asarray(RK.quantize(jnp.asarray(x), r.lo, r.hi, r.zero,
                                    bits=bits, interpret=True))
    want_q = np.asarray(RQ.quantize(jnp.asarray(x), r))
    p = TQ.QuantParams(lo=torch.from_numpy(lo), hi=torch.from_numpy(hi),
                       zero=torch.from_numpy(zero), bits=bits, scheme="gaussian")
    got_k = TK.quantize(torch.from_numpy(x), p.lo, p.hi, p.zero, bits=bits).numpy()
    got_q = TQ.quantize(torch.from_numpy(x), p).numpy()
    assert np.array_equal(got_k, want_k) and np.array_equal(got_q, want_q)


def test_codes_bit_equal_at_exact_half_points():
    # 2^B (x - k) / span lands exactly on m + 0.5: round half to even
    x = ((np.arange(-300, 300, dtype=np.float32) + 0.5) / 256)[None, :]
    lo, hi, zero = (np.full(600, v, np.float32) for v in (-0.5, 0.5, 0.0))
    want = np.asarray(RK.quantize(jnp.asarray(x), jnp.asarray(lo), jnp.asarray(hi),
                                  jnp.asarray(zero), bits=8, interpret=True))
    got = TK.quantize(torch.from_numpy(x), torch.from_numpy(lo),
                      torch.from_numpy(hi), torch.from_numpy(zero), bits=8).numpy()
    assert np.array_equal(got, want)


def test_dequantize_matches_reference():
    x = _corpus(seed=3, n=64)
    r = RQ.learn_params(jnp.asarray(x))
    t = TQ.learn_params(torch.from_numpy(x))
    codes = np.asarray(RQ.quantize(jnp.asarray(x), r))
    np.testing.assert_allclose(
        TQ.dequantize(torch.from_numpy(codes), t).numpy(),
        np.asarray(RQ.dequantize(jnp.asarray(codes), r)), rtol=1e-6, atol=1e-8)


# -- distances -----------------------------------------------------------------

@pytest.mark.parametrize("metric", ["ip", "l2", "angular"])
def test_int_scores_bit_equal(metric):
    rng = np.random.default_rng(4)
    q = rng.integers(-128, 128, (13, 33)).astype(np.int8)
    x = rng.integers(-128, 128, (300, 33)).astype(np.int8)
    want = np.asarray(RD.scores(jnp.asarray(q), jnp.asarray(x), metric,
                                quantized=True))
    got = TD.scores(torch.from_numpy(q), torch.from_numpy(x), metric,
                    quantized=True).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    rows = x[rng.integers(0, 300, (13, 7))]
    want_a = np.asarray(RD.scores_among(jnp.asarray(q), jnp.asarray(rows), metric,
                                        quantized=True))
    got_a = TD.scores_among(torch.from_numpy(q), torch.from_numpy(rows), metric,
                            quantized=True).numpy()
    assert np.array_equal(got_a, want_a)


@pytest.mark.parametrize("metric", ["ip", "l2", "angular"])
def test_fp32_scores_within_tolerance(metric):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((13, 33)).astype(np.float32)
    x = rng.standard_normal((300, 33)).astype(np.float32)
    want = np.asarray(RD.scores(jnp.asarray(q), jnp.asarray(x), metric))
    got = TD.scores(torch.from_numpy(q), torch.from_numpy(x), metric).numpy()
    terms = (np.linalg.norm(q, axis=1)[:, None] + 1) * (np.linalg.norm(x, axis=1)[None] + 1)
    assert np.all(np.abs(got - want) <= 1e-6 * terms)


def test_recall_at_k_matches_reference():
    rng = np.random.default_rng(6)
    a = rng.integers(0, 50, (20, 10)).astype(np.int32)
    b = rng.integers(0, 50, (20, 10)).astype(np.int32)
    want = float(RPR.recall_at_k(jnp.asarray(a), jnp.asarray(b)))
    assert abs(TPR.recall_at_k(torch.from_numpy(a), torch.from_numpy(b)) - want) < 1e-6


# -- package rules -------------------------------------------------------------

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\.|from\s+repro\.|"
    r"import\s+repro\s*$|from\s+repro\s+import)", re.M)


def test_port_never_imports_jax_or_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    from repro_torch.data import synthetic
    from repro_torch.knn import load_index, make_index

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _corpus(n=64, d=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_index("flat,lpq8", x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic.load("product", 16, 4)
    idx = make_index("flat,lpq8", x, device="cpu")
    assert idx.device.type == "cpu"
    assert idx.search(x[:3], 5).ids.shape == (3, 5)
    idx.save(tmp_path / "i.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_index(tmp_path / "i.npz")
    assert load_index(tmp_path / "i.npz", device="cpu").n == 64
    corpus, queries, metric = synthetic.load("sift", 16, 4, device="cpu")
    assert corpus.shape == (16, 128) and metric == "l2"
    assert queries.device.type == "cpu"
