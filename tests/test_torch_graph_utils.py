"""The port's graph utilities (``repro_torch.knn.graph_utils``) and
``core.quant.quantize_corpus`` against the reference's on the same points.

* ``radius_graph`` is an exact port: senders, receivers and mask equal the
  reference's, fp32 and over int8 / int4 abs-max codes.
* ``knn_graph`` follows its docstring, "neighbor ids (self excluded)":
  the true k nearest, ties to the lowest id, held against numpy with the
  diagonal masked.  The reference's code does not (ROADMAP queue C, C8):
  ``src/repro/knn/graph_utils.py:33`` subtracts ``inf * eye(n)``, and
  ``inf * 0`` is NaN, so every score but the diagonal's is NaN and its rows
  start with the row itself, then ids 0, 1, ...
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import quant as r_quant  # noqa: E402
from repro.knn import graph_utils as RU  # noqa: E402
from repro_torch.core import quant as Qz  # noqa: E402
from repro_torch.knn import knn_graph, radius_graph  # noqa: E402


def _points(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _numpy_knn(s: np.ndarray, k: int) -> np.ndarray:
    """The docstring's answer: self masked to -inf, stable descending."""
    s = s.astype(np.float64).copy()
    np.fill_diagonal(s, -np.inf)
    return np.argsort(-s, axis=1, kind="stable")[:, :k].astype(np.int32)


@pytest.mark.parametrize("metric", ["l2", "ip", "angular"])
@pytest.mark.parametrize("n,d,k", [(8, 3, 3), (200, 16, 10), (57, 5, 56)])
def test_knn_graph_fp32_is_the_true_neighbours_self_excluded(metric, n, d, k):
    p = _points(n, d, n + d)
    got = knn_graph(torch.from_numpy(p), k, metric=metric).numpy()
    x = p.astype(np.float64)
    if metric == "ip":
        s = x @ x.T
    elif metric == "l2":
        s = -((x[:, None] - x[None]) ** 2).sum(-1)
    else:
        u = x / np.linalg.norm(x, axis=1, keepdims=True)
        s = u @ u.T
    want = _numpy_knn(s, min(k, n - 1))
    assert got.dtype == np.int32 and got.shape == want.shape
    assert not (got == np.arange(n)[:, None]).any()
    # float64 numpy and torch's f32 agree wherever neighbours are not
    # within f32 rounding of each other
    assert (got == want).mean() > 0.99


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("bits", [8, 4])
def test_knn_graph_quantized_is_exact_on_the_codes(metric, bits):
    """Integer scores: ids equal numpy's on the same abs-max codes, tied
    scores to the lowest id."""
    p = _points(300, 12, 5)
    got = knn_graph(torch.from_numpy(p), 7, metric=metric, quantized=True,
                    bits=bits).numpy()
    codes, _ = Qz.quantize_corpus(torch.from_numpy(p), bits=bits,
                                  scheme=Qz.Scheme.ABSMAX)
    c = codes.numpy().astype(np.int64)
    s = c @ c.T if metric == "ip" else -((c[:, None] - c[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(got, _numpy_knn(s, 7))


def test_reference_knn_graph_starts_each_row_with_itself_c8():
    """C8: the reference's ``knn_graph`` (``graph_utils.py:33``) returns row
    i first and then the lowest ids; the port returns the neighbours."""
    p = _points(8, 3, 0)
    ref = np.asarray(RU.knn_graph(jnp.asarray(p), 3))
    np.testing.assert_array_equal(ref[:, 0], np.arange(8))
    np.testing.assert_array_equal(ref[3:, 1:], np.tile([0, 1], (5, 1)))
    ref_q = np.asarray(RU.knn_graph(jnp.asarray(p), 3, quantized=True))
    np.testing.assert_array_equal(ref_q[:, 0], np.arange(8))
    got = knn_graph(torch.from_numpy(p), 3).numpy()
    np.testing.assert_array_equal(got[:3], [[1, 5, 7], [0, 5, 7], [6, 7, 0]])


@pytest.mark.parametrize("quantized,bits", [(False, 8), (True, 8), (True, 4)])
@pytest.mark.parametrize("n,cutoff,cap", [(8, 1.5, 4), (120, 1.0, 6),
                                          (64, 0.3, 64)])
def test_radius_graph_equals_reference(quantized, bits, n, cutoff, cap):
    p = _points(n, 3, n) * 0.7
    want = RU.radius_graph(jnp.asarray(p), cutoff, cap, quantized=quantized,
                           bits=bits)
    got = radius_graph(torch.from_numpy(p), cutoff, cap, quantized=quantized,
                       bits=bits)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[2].any() and not got[2].all()


@pytest.mark.parametrize("scheme", ["gaussian", "absmax", "global_minmax"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_corpus_equals_reference(scheme, bits):
    """learn + apply.  The min / max schemes' constants are exact; the
    Gaussian ones sum in torch's order, so they are held as
    ``tests/test_torch_core.py`` holds ``learn_params``, and the codes
    are bit-equal given the reference's constants."""
    p = _points(500, 24, 3)
    rc, rp = r_quant.quantize_corpus(jnp.asarray(p), bits=bits, scheme=scheme,
                                     sigmas=2.0)
    x = torch.from_numpy(p)
    tc, tp = Qz.quantize_corpus(x, bits=bits, scheme=scheme, sigmas=2.0)
    assert torch.equal(tc, Qz.quantize(x, tp))
    assert tp.bits == rp.bits and tp.scheme == rp.scheme
    exact = scheme != "gaussian"
    slack = 0 if exact else 1e-6 * float(np.abs(p).max())
    for a in ("lo", "hi", "zero"):
        np.testing.assert_allclose(getattr(tp, a).numpy(),
                                   np.asarray(getattr(rp, a)),
                                   rtol=0 if exact else 1e-6, atol=slack)
    same = Qz.QuantParams(*(torch.from_numpy(np.asarray(getattr(rp, a)))
                            for a in ("lo", "hi", "zero")), bits=rp.bits,
                          scheme=rp.scheme)
    np.testing.assert_array_equal(Qz.quantize(x, same).numpy(), np.asarray(rc))
    if exact:
        np.testing.assert_array_equal(tc.numpy(), np.asarray(rc))
