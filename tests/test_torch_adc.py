"""The port's fused ADC wrappers (``repro_torch.kernels.adc``, B4 / B5) and
``ops.fused_adc_topk`` against the reference on identical numpy inputs.

On the CPU every wrapper runs its kernel's plain version (the tensor lies on
the CPU); the CUDA kernels themselves are held to those plain versions on
the card by ``chip_smoke.py`` and by the ``gpu``-marked
``tests/test_torch_gpu.py``.

Tolerance: none.  ADC scores are exact int32 sums of int8 LUT entries, so
the plain versions are bit-equal in ids and scores to the reference's
``fused_adc_pallas`` / ``fused_adc4_pallas`` in interpret mode, to its
``use_pallas=False`` path and to the ``adc_ref`` / ``adc4_ref`` oracles.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import pack as RP  # noqa: E402
from repro.kernels import ops as RK  # noqa: E402
from repro.kernels import ref as RR  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import pack as TP  # noqa: E402
from repro_torch.kernels import adc as A  # noqa: E402
from repro_torch.kernels import fused_topk as F  # noqa: E402
from repro_torch.kernels import ops as TK  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

NEG = float(np.finfo(np.float32).min)


def _inputs(Q, N, m, bits, seed):
    rng = np.random.default_rng(seed)
    kc = 2 ** bits
    lut = rng.integers(-128, 128, (Q, m, kc)).astype(np.int8)
    codes = rng.integers(0, kc, (N, m)).astype(np.uint8)
    payload = np.array(RP.pack_uint4(jnp.asarray(codes))) if bits == 4 else codes
    return lut, codes, payload


def _port(lut, payload, k, bits, mask=None):
    m = None if mask is None else torch.from_numpy(mask)
    s, i = TK.fused_adc_topk(torch.from_numpy(lut), torch.from_numpy(payload),
                             k, packed=bits == 4, mask=m)
    return s.numpy(), i.numpy()


def _ref(lut, payload, k, bits, mask=None, **kw):
    m = None if mask is None else jnp.asarray(mask)
    s, i = RK.fused_adc_topk(jnp.asarray(lut), jnp.asarray(payload), k,
                             packed=bits == 4, mask=m, **kw)
    return np.asarray(s), np.asarray(i)


def _equal(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


# (Q, N, M, bits, k): odd M under 4-bit codes (a zero-code pad column and a
# zero LUT slice), k > N, Q not a multiple of the reference's 64-query tile
CASES = [
    (1, 300, 8, 8, 10),
    (5, 700, 3, 8, 20),
    (70, 513, 16, 8, 7),
    (17, 40, 4, 8, 100),        # k > N
    (1, 300, 8, 4, 10),
    (5, 700, 7, 4, 20),         # odd M, packed
    (70, 513, 16, 4, 7),
    (17, 40, 3, 4, 100),        # odd M, k > N
]


@pytest.mark.parametrize("Q,N,m,bits,k", CASES)
def test_fused_adc_topk_bit_equal_to_reference(Q, N, m, bits, k):
    lut, codes, payload = _inputs(Q, N, m, bits, seed=Q * 1000 + N + m)
    got = _port(lut, payload, k, bits)
    _equal(got, _ref(lut, payload, k, bits, interpret=True))
    _equal(got, _ref(lut, payload, k, bits, use_pallas=False))
    # the oracle on the unpacked codes, in both packages
    s_t = TR.adc_ref(torch.from_numpy(lut), torch.from_numpy(codes))
    s_r = RR.adc_ref(jnp.asarray(lut), jnp.asarray(codes))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_r))
    want = TR.topk_ref(s_t, min(k, N), N)
    _equal(got, (want[0].numpy(), want[1].numpy()))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("keep", [0.5, 0.01])
def test_masked_adc_matches_the_oracle(bits, keep):
    """A dense mask against the interpret-mode kernel; a sparse one (fewer
    survivors than k) against the reference's ``use_pallas=False`` path:
    there the interpret-mode ``_merge_tile`` repeats ids in the tail
    (ROADMAP C3), and the contract is ``topk_ref``'s (NEG, -1)."""
    Q, N, m, k = 9, 900, 5, 30
    lut, _, payload = _inputs(Q, N, m, bits, seed=7)
    mask = (np.random.default_rng(8).random(N) < keep).astype(np.int8)
    got = _port(lut, payload, k, bits, mask)
    _equal(got, _ref(lut, payload, k, bits, mask, use_pallas=False))
    if keep == 0.5:
        _equal(got, _ref(lut, payload, k, bits, mask, interpret=True))
    else:
        assert (got[1][:, int(mask.sum()):] == -1).all()
        assert (got[0][:, int(mask.sum()):] == NEG).all()
    assert np.all(mask[got[1][got[1] >= 0]] != 0)


@pytest.mark.parametrize("m", [1, 7, 32])
def test_adc4_oracle_bit_equal_to_reference(m):
    rng = np.random.default_rng(m)
    lut = rng.integers(-128, 128, (4, m + m % 2, 16)).astype(np.int8)
    codes = rng.integers(0, 16, (50, m)).astype(np.uint8)
    packed = TP.pack_uint4(torch.from_numpy(codes))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(RP.pack_uint4(jnp.asarray(codes))))
    np.testing.assert_array_equal(
        TR.adc4_ref(torch.from_numpy(lut), packed).numpy(),
        np.asarray(RR.adc4_ref(jnp.asarray(lut), jnp.asarray(packed.numpy()))))


def test_plain_versions_sum_subspace_by_subspace_like_the_oracle():
    """The plain B4 / B5 never gather [Q, M, N]; they equal the oracle."""
    Q, N, k = 6, 1000, 50
    for bits, m in ((8, 5), (4, 6)):
        lut, codes, payload = _inputs(Q, N, m, bits, seed=bits)
        t = torch.from_numpy(lut)
        want = TR.topk_ref(TR.adc_ref(t, torch.from_numpy(codes)), k, N)
        if bits == 8:
            got = A.fused_adc_plain(t.reshape(Q, -1), torch.from_numpy(payload),
                                    k=k, n_codewords=256)
        else:
            le = t[:, 0::2].reshape(Q, -1).contiguous()
            lo = t[:, 1::2].reshape(Q, -1).contiguous()
            got = A.fused_adc4_plain(le, lo, torch.from_numpy(payload), k=k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_many_exact_ties_break_by_id():
    """Small-integer ADC scores tie often; order is (score desc, id asc)."""
    lut = np.zeros((3, 4, 256), np.int8)
    lut[:, :, :2] = 1
    codes = np.random.default_rng(0).integers(0, 4, (500, 4)).astype(np.uint8)
    s, i = _port(lut, codes, 100, 8)
    _equal((s, i), _ref(lut, codes, 100, 8, interpret=True))
    for row_s, row_i in zip(s, i):
        for a in range(99):
            assert row_s[a] > row_s[a + 1] or (row_s[a] == row_s[a + 1]
                                               and row_i[a] < row_i[a + 1])


def test_launch_layout_fits_shared_memory():
    """The Python-side layout (the CUDA source takes it as given): the
    query tile shrinks with M and k so the block's LUTs and candidate
    buffers stay within the H100's 227 KB, down to 1 query; then the
    buffers move to global memory, and a LUT too wide for one query is
    read from global memory, so every M and k launches."""
    for kbits, widths in ((8, (1, 7, 16, 32, 64, 128, 256, 512, 1024)),
                          (4, (1, 4, 32, 64, 512))):
        for mb in widths:
            for k in (1, 100, 400, 1024, 1025, 5000):
                lay = A.adc_layout(k, mb, kbits, 256, 4_000_000)
                assert lay.bq in (16, 8, 4, 2, 1)
                gbuf = lay.gbuf_keys > 0
                assert A.smem_bytes(lay.bq, lay.cap, mb, kbits, gbuf,
                                    lay.lutg) <= A.SMEM_MAX
                assert lay.cap == A.adc_cap(k, lay.bq) >= k + A.tile_rows(
                    lay.bq) // 4
                assert lay.lutg == (kbits == 8 and mb >= 1024)
                if k <= 1024 and mb <= 64:      # unchanged below the old caps
                    assert not gbuf and lay.bq in (16, 8, 4)
                    assert lay.cap == F.split_cap(k)
                assert A.query_tile(k, mb, kbits, 3) in (4, 2, 1)
    assert A.query_tile(100, 32, 8, 256) == 16          # pq32: 8 KB LUTs
    assert A.query_tile(100, 32, 4, 256) == 16          # pq64x4: 1 KB LUTs
    assert A.query_tile(400, 32, 8, 256) == 8           # pq32 at depth 400
    assert A.query_tile(100, 256, 8, 256) == 2          # 64 KB LUTs
    assert A.query_tile(100, 512, 8, 256) == 1          # 128 KB LUTs
    assert A.adc_layout(100, 1024, 8, 256, 10 ** 6).lutg  # 256 KB: global
    assert A.tile_rows(16) == A.tile_rows(4) == A.BN == 256
    assert (A.tile_rows(2), A.tile_rows(1)) == (512, 1024)
    assert A.n_splits(256, 4_000_000, 16) == 33
    assert A.n_splits(1, 1, 4) == 1


def test_cpu_calls_launch_nothing_and_other_devices_raise():
    kernels.reset_launch_counts()
    lut, _, payload = _inputs(2, 64, 4, 8, seed=0)
    _port(lut, payload, 5, 8)
    assert kernels.launch_counts()["fused_adc"] == 0
    assert set(A.LAUNCHES) <= set(kernels.launch_counts())
    meta = torch.empty((64, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        A.fused_adc_cuda(torch.empty((2, 1024), dtype=torch.int8,
                                     device="meta"), meta, k=5)
    with pytest.raises(ValueError, match="unsupported device"):
        A.fused_adc4_cuda(torch.empty((2, 64), dtype=torch.int8, device="meta"),
                          torch.empty((2, 64), dtype=torch.int8, device="meta"),
                          meta, k=5)
