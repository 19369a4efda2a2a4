"""The port's score-matrix ops (``repro_torch.kernels.ops.qmip`` / ``ql2`` /
``qmip4`` / ``ql24``, kernels B6-B8) against the reference's Pallas kernels
on identical numpy inputs.

On the CPU each wrapper runs its kernel's plain version (the tensor lies on
the CPU); the reference runs its Pallas kernels in interpret mode, as its
own tests do (``tests/test_kernels.py:38-53``).  The CUDA kernels are held
to the plain versions on the card by ``chip_smoke.py`` and the
``gpu``-marked ``tests/test_torch_gpu.py``.

Tolerance: none.  The outputs are int32 and must be bit-equal.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import pack as RP  # noqa: E402
from repro.kernels import ops as RK  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import pack as TP  # noqa: E402
from repro_torch.kernels import _qscore  # noqa: E402
from repro_torch.kernels import ops as TK  # noqa: E402
from repro_torch.kernels import packed as TPK  # noqa: E402

#: the reference's shapes (tests/test_kernels.py:24-32)
QN_SHAPES = [
    (1, 1, 8),        # degenerate
    (1, 1000, 64),    # single query (retrieval_cand shape family)
    (7, 333, 100),    # ragged everything (glove100 d)
    (37, 1000, 96),
    (128, 512, 128),  # exactly one tile (SIFT d)
    (130, 700, 128),  # just over one tile
    (256, 2048, 256), # multiple tiles (product-embedding d)
]
#: packed-int4 cases with an odd number of bytes a row (d/2 odd)
ODD_HALF_SHAPES = [(5, 77, 2), (9, 513, 102)]


def _codes(rng, shape, bits):
    lim = 2 ** (bits - 1)
    return rng.integers(-lim, lim, shape).astype(np.int8)


def _both(name, q, x):
    """(reference in interpret mode, port on the CPU) as numpy int32."""
    want = np.asarray(getattr(RK, name)(jnp.asarray(q), jnp.asarray(x),
                                        interpret=True))
    got = getattr(TK, name)(torch.from_numpy(q), torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    return got.numpy(), want


@pytest.mark.parametrize("name", ["qmip", "ql2"])
@pytest.mark.parametrize("q_rows,n_rows,d", QN_SHAPES)
def test_int8_score_matrix_matches_reference(name, q_rows, n_rows, d):
    rng = np.random.default_rng(q_rows * 7 + n_rows + len(name))
    q, x = _codes(rng, (q_rows, d), 8), _codes(rng, (n_rows, d), 8)
    got, want = _both(name, q, x)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["qmip4", "ql24"])
@pytest.mark.parametrize("q_rows,n_rows,d", QN_SHAPES + ODD_HALF_SHAPES)
def test_packed_score_matrix_matches_reference(name, q_rows, n_rows, d):
    rng = np.random.default_rng(q_rows * 13 + n_rows + len(name))
    q, x = _codes(rng, (q_rows, d), 4), _codes(rng, (n_rows, d), 4)
    packed = np.array(RP.pack_int4(jnp.asarray(x)))
    assert np.array_equal(TP.pack_int4(torch.from_numpy(x)).numpy(), packed)
    got, want = _both(name, q, packed)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,bits", [("qmip", 8), ("ql2", 8),
                                       ("qmip4", 4), ("ql24", 4)])
def test_extreme_codes_match_reference(name, bits):
    """All-min / all-max codes: a wrong sign extension, a lost norm or a
    swapped nibble shows here (nibbles -8 / 7 in both halves)."""
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    d = 130
    q = np.array([[lo] * d, [hi] * d, [lo, hi] * (d // 2)], dtype=np.int8)
    x = np.array([[lo] * d, [hi] * d, [hi, lo] * (d // 2), [0] * d],
                 dtype=np.int8)
    if bits == 4:
        x = np.array(RP.pack_int4(jnp.asarray(x)))
    got, want = _both(name, q, x)
    np.testing.assert_array_equal(got, want)


#: widths at which the extreme pairs' sum of squared differences passes
#: 2^31: (-128 - 127)^2 d for int8 rows, (-128 - 7)^2 d for int8 queries
#: against int4 nibbles
WRAP_WIDTHS = {"ql2": 33_040, "ql24": 117_840}


@pytest.mark.parametrize("name", ["ql2", "ql24"])
def test_l2_wraps_as_the_reference(name):
    """-(|q|^2 + |x|^2 - 2 q . x) past int32: both sides wrap alike (the
    reference's int32 arithmetic), so the CUDA kernel's uint32 combine has
    one answer to match."""
    d = WRAP_WIDTHS[name]
    hi = 127 if name == "ql2" else 7
    q = np.array([[-128] * d, [127] * d], dtype=np.int8)
    x = np.array([[hi] * d, [-128 if name == "ql2" else -8] * d, [0] * d],
                 dtype=np.int8)
    if name == "ql24":
        x = np.array(RP.pack_int4(jnp.asarray(x)))
    got, want = _both(name, q, x)
    np.testing.assert_array_equal(got, want)
    # the first pair wrapped: a negated sum of squares came out positive
    assert got[0, 0] > 0 and got[1, 2] < 0


def test_cpu_calls_count_no_launch_and_tiles_follow_q():
    kernels.reset_launch_counts()
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_codes(rng, (4, 16), 4))
    x = torch.from_numpy(_codes(rng, (9, 16), 4))
    px = TP.pack_int4(x)
    TK.qmip(q, x), TK.ql2(q, x), TK.qmip4(q, px), TK.ql24(q, px)
    counts = kernels.launch_counts()
    assert {"qmip", "ql2", "qmip4", "ql24"} <= set(counts)
    assert set(counts.values()) == {0}
    # B7 and B8b share the tensor-core kernel's output tile with B6 / B8a
    assert [_qscore.mma_tiles(n) for n in (1, 2, 3, 9, 16, 17, 64, 65, 512)] == [
        (8, 256), (8, 256), (8, 256), (16, 256), (16, 256), (32, 256),
        (64, 128), (128, 128), (128, 128)]
    # the plain versions split / merge the query halves losslessly
    qe, qo = TPK.split_nibble_queries(q)
    assert torch.equal(TPK.merge_nibble_queries(qe, qo), q)
    assert torch.equal(TPK.qmip4_plain(qe, qo, px), TK.qmip4(q, px))


def test_kernel_wrappers_check_their_operands():
    """What the CUDA launcher refuses, it refuses before any build: the
    device, dtypes and shapes (checked here on the meta device, which is
    neither CPU nor CUDA)."""
    q = torch.zeros((2, 8), dtype=torch.int8, device="meta")
    x = torch.zeros((3, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TK.qmip(q, x)
    with pytest.raises(ValueError, match="unsupported device"):
        TPK.ql24_cuda(q[:, :4], q[:, :4], x[:, :4].to(torch.uint8))
    with pytest.raises(ValueError, match="unsupported device"):
        TPK.qmip4_cuda(q[:, :4], q[:, :4], x[:, :4].to(torch.uint8))


@pytest.mark.parametrize("q,tile", [(1, (8, 256)), (8, (8, 256)),
                                    (9, (16, 256)), (512, (128, 128))])
def test_mma_tiles_follow_q(q, tile):
    """The tensor-core kernel's output tile (B6, B8a): the smallest query
    tile that holds Q, so a single query fills 1 of 8 MMA columns."""
    assert _qscore.mma_tiles(q) == tile
