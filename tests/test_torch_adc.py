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


def test_wide_lut_cases_reach_every_b4_gather_instance():
    """The card's wide-LUT cases (``ADC_WIDE`` in tests/test_torch_gpu.py)
    launch every instance of the gather kernel that B4 batches of at most
    4 queries can take: 1, 2 or 4 queries a block, lists in shared or
    global memory, LUTs in shared or (at 4) global memory."""
    from test_torch_gpu import ADC_WIDE

    seen = set()
    for bits, m, q, k in ADC_WIDE:
        lay = A.adc_layout(k, m, 8, q, 20001)
        if bits == 8 and lay.gather:
            seen.add((lay.bq, lay.gbuf_keys > 0, lay.lutg))
    assert seen == set(A._gather_modes(1))
    assert len(seen) == 8


@pytest.mark.parametrize("kbits", [8, 4])
def test_launch_layout_fits_shared_memory(kbits):
    """The Python-side layout (the CUDA source takes it as given).  B4 from
    5 queries on runs the word kernel: groups of 4 queries, 8 or 4 queries
    a block, 1, 2 or 4 warps a group, the ring able to serve each warp
    (its next stage at most W_STAGES steps ahead), the block within the
    H100's 227 KB, the lists moved to global memory where shared memory
    cannot hold them and the LUTs read from global memory where no group's
    LUTs fit (past M = 192), so every M and k launches; at pq32, k=100 two
    blocks of 8 queries an SM.  B5 (the one-hot MMA kernel) takes the
    batch's tile of 8, 16 or 32 queries, 8 where its LUTs or lists leave a
    32-query block alone on its SM, the lists in global memory where shared
    memory cannot hold them.  Batches of at most 4 queries take the gather
    kernel (B4 and B5 alike)."""
    n = 4_000_000
    widths = ((1, 7, 16, 32, 33, 64, 128, 192, 193, 256, 512, 1024)
              if kbits == 8 else (1, 4, 32, 64, 512))
    for mb in widths:
        for k in (1, 100, 400, 1024, 1025, 5000):
            lay = A.adc_layout(k, mb, kbits, 256, n)
            gbuf = lay.gbuf_keys > 0
            assert A.query_tile(k, mb, kbits, 3) in (4, 2, 1)
            assert A.adc_layout(k, mb, kbits, 3, n).gather
            if kbits == 4:
                assert not lay.lutg and not lay.gather and not lay.word
                assert lay.bq in (32, 8) and lay.mode == 0
                assert lay.cap == F.i8_cap(k) >= k + A.A4_BM
                assert A.a4_smem_bytes(lay.bq, lay.cap, gbuf,
                                       mb) <= A.SMEM_MAX
                assert A.query_tile(k, mb, kbits, 3) == 4
                continue
            assert lay.word and not lay.gather and lay.mode & 4
            assert (lay.bq, lay.subsets) in A.W_TILES
            assert (lay.subsets - 1) * A.w_chunks(mb) < A.W_STAGES
            assert A.w_smem_bytes(lay.bq, lay.subsets, lay.cap, mb, gbuf,
                                  lay.lutg) <= A.SMEM_MAX
            # a list takes at most 32 rows (a quarter tile) between checks
            assert lay.cap == F.i8_cap(k) >= k + 32
            assert lay.lutg == (mb > 192) and (lay.mode & 1) == lay.lutg
            per_sm = A.w_blocks_per_sm(lay.bq, lay.subsets, lay.cap, mb, gbuf,
                                       lay.lutg)
            qblocks = -(-256 // lay.bq)
            assert lay.splits == max(1, min(per_sm * 132 // qblocks,
                                            -(-n // max(2048, 2 * k))))
            assert lay.parts == lay.splits * lay.subsets and lay.tile == A.W_BM
            if gbuf:
                assert lay.gbuf_keys == (qblocks * lay.splits * lay.bq
                                         * lay.subsets * lay.cap)
                assert A.w_smem_bytes(lay.bq, lay.subsets, lay.cap, mb, False,
                                      lay.lutg) > A.SMEM_MAX or per_sm * (
                    lay.bq // 4 * lay.subsets) >= A.W_ENOUGH_WARPS
    if kbits == 4:
        assert A.query_tile(100, 32, 4, 256) == 32      # pq64x4: 1 KB LUTs
        assert A.query_tile(400, 32, 4, 256) == 8       # pq64x4 at depth 400
        return
    # pq32 and pq16, k=100: two blocks of two query groups and 2 warps each,
    # lists in shared memory (8 consumer warps an SM)
    for mb in (32, 16):
        lay = A.adc_layout(100, mb, 8, 256, n)
        assert (lay.bq, lay.subsets, lay.gbuf_keys, lay.lutg) == (8, 2, 0, False)
        assert A.w_blocks_per_sm(8, 2, lay.cap, mb) == 2
    assert A.query_tile(100, 32, 8, 256) == A.BQ == 8
    # pq32 at depth 400: lists of 512 keys; one group and 4 warps a block
    assert A.adc_layout(400, 32, 8, 256, n)[:2] == (4, False)
    assert A.adc_layout(400, 32, 8, 256, n).subsets == 4
    assert A.adc_layout(100, 1024, 8, 256, 10 ** 6).lutg    # 256 KB: global
    assert A.tile_rows(16) == A.tile_rows(4) == A.BN == 256
    assert (A.tile_rows(2), A.tile_rows(1)) == (512, 1024)
    assert A.n_splits(256, 4_000_000, 16) == 33
    assert A.n_splits(1, 1, 4) == 1


@pytest.mark.parametrize("q", [1, 2, 3, 4])
def test_b4_small_batches_take_the_gather_kernel(q):
    """A batch of at most 4 queries would fill part of one word kernel
    group of 4: ``adc_layout`` gives B4 the gather kernel at 1, 2 or 4
    queries a block (the tile of B5's small batches), its LUTs in shared
    memory while they fit, its buffers in global memory past that, at every
    M and k; from 5 queries on, the word kernel."""
    for mb in (1, 7, 32, 64, 256, 512, 1024):
        for k in (1, 100, 400, 1025, 3000):
            lay = A.adc_layout(k, mb, 8, q, 4_000_000)
            assert lay.gather and not lay.word and lay.subsets == 1
            assert lay.mode == 2 | int(lay.lutg)
            gbuf = lay.gbuf_keys > 0
            assert A.smem_bytes(lay.bq, lay.cap, mb, 8, gbuf,
                                lay.lutg) <= A.SMEM_MAX
            assert lay.cap == A.adc_cap(k, lay.bq) >= k + A.tile_rows(
                lay.bq) // 4
            assert lay.parts == lay.splits
            if not lay.lutg:
                assert lay.bq == (1 if q == 1 else 2 if q == 2 else 4)
            assert A.adc_layout(k, mb, 8, 5, 4_000_000).word


@pytest.mark.parametrize("q", [9, 17, 256])
def test_adc4_layout_fits_at_every_m_and_k(q):
    """B5's layout at M = 1 ... 1024 subspaces (ceil(M/2) packed bytes) and
    k = 1 ... 3000: the one-hot MMA kernel's block within the 227 KB, each
    list of at least k keys plus one 32-row tile of inserts, the lists in
    global memory exactly where shared memory cannot hold them, resident
    blocks within the SM's shared memory, one wave of blocks; and the one
    corner it does not take, rows so wide that 8 queries' LUTs do not fit
    (mb > 864 bytes), goes to the gather kernel with its LUTs read from
    global memory, chosen here and nowhere else."""
    n = 4_000_000
    for m in list(range(1, 65)) + [127, 128, 255, 256, 511, 512, 1023, 1024]:
        mb = -(-m // 2)
        for k in (1, 2, 31, 32, 33, 100, 160, 161, 400, 416, 417, 1000,
                  1024, 1025, 2000, 2048, 3000):
            lay = A.adc_layout(k, mb, 4, q, n)
            assert not lay.lutg and not lay.gather
            gbuf = lay.gbuf_keys > 0
            assert lay.cap == F.i8_cap(k) >= k + A.A4_BM
            smem = A.a4_smem_bytes(lay.bq, lay.cap, gbuf, mb)
            assert smem <= A.SMEM_MAX
            assert gbuf == (A.a4_smem_bytes(lay.bq, lay.cap, False, mb)
                            > A.SMEM_MAX)
            qblocks = -(-q // lay.bq)
            if gbuf:
                assert lay.gbuf_keys == qblocks * lay.splits * lay.bq * lay.cap
            per_sm = A.a4_blocks_per_sm(lay.bq, lay.cap, gbuf, mb)
            assert per_sm == 1 or per_sm * (smem + 1024) <= A.SM_SMEM
            assert lay.bq in (8, 16, 32) and lay.bq <= max(8, 2 * q)
            assert lay.splits == max(1, min(per_sm * 132 // qblocks,
                                            -(-n // max(2048, 2 * k))))
    assert A.a4_query_layout(256, 100, 864) == (8, True)
    assert A.a4_query_layout(256, 100, 865) is None
    for mb in (865, 2000):
        lay = A.adc_layout(100, mb, 4, 256, n)
        assert lay.lutg and lay.gather and lay.mode == 3
        assert lay.bq == 4 and lay.cap == A.adc_cap(100, 4)


@pytest.mark.parametrize("q", [1, 2, 3, 4])
def test_adc4_small_batches_take_the_gather_kernel(q):
    """A batch of at most 4 queries would fill 1/8 to 1/2 of an MMA tile of
    8: ``adc_layout`` gives it the gather kernel (``mode`` bit 1) at 1, 2
    or 4 queries a block, its LUTs in shared memory while they fit, its
    buffers in global memory past that, at every M and k."""
    for mb in (1, 4, 32, 64, 512, 2000):
        for k in (1, 100, 400, 1025, 3000):
            lay = A.adc_layout(k, mb, 4, q, 4_000_000)
            assert lay.gather and lay.mode in (2, 3)
            gbuf = lay.gbuf_keys > 0
            assert A.smem_bytes(lay.bq, lay.cap, mb, 4, gbuf,
                                lay.lutg) <= A.SMEM_MAX
            assert lay.cap == A.adc_cap(k, lay.bq) >= k + A.tile_rows(
                lay.bq) // 4
            if not lay.lutg:
                assert lay.bq == (1 if q == 1 else 2 if q == 2 else 4)


def _adc4_kernel_model(lut_even, lut_odd, packed, k, mask=None):
    """B5's K order, in plain torch (int64): each query's LUT interleaved
    per code byte (the 16 even codewords' entries, then the 16 odd ones:
    one k32 step), each row's one-hot built from its packed bytes the way
    a lane builds its A registers (byte c & 3 of register t4 set where
    8 c ^ 32 t4 < 32, the even code from the low nibble, the odd from the
    high one), and the two multiplied."""
    Q, mb = lut_even.shape[0], packed.shape[1]
    lut = torch.stack([lut_even.reshape(Q, mb, 16),
                       lut_odd.reshape(Q, mb, 16)], dim=2).reshape(Q, 32 * mb)
    b = packed.to(torch.int64)
    regs = []
    for code in (b & 0x0F, b >> 4):                       # K 0-15, 16-31
        for t4 in range(4):
            sh = (code << 3) ^ (32 * t4)                  # 8 c ^ 32 t4
            reg = torch.where(sh < 32, 1 << sh.clamp(max=31), 0)
            regs.append(torch.stack([(reg >> (8 * e)) & 0xFF
                                     for e in range(4)], dim=-1))
    onehot = torch.cat(regs, dim=-1).reshape(packed.shape[0], 32 * mb)
    assert bool(torch.all(onehot.reshape(-1, 32).sum(1) == 2))
    s = (lut.to(torch.int64) @ onehot.T).to(torch.int32)
    return F._masked_topk(s, k, mask)


@pytest.mark.parametrize("m,kind", [(1, "random"), (7, "random"),
                                    (32, "random"), (64, "random"),
                                    (7, "equal_rows"), (16, "small")])
def test_adc4_kernel_model_bit_equal_to_plain_and_reference(m, kind):
    """The one-hot MMA kernel's K order (``_adc4_kernel_model``) bit-equal
    to ``fused_adc4_plain`` and to the reference's ``fused_adc4_pallas`` in
    interpret mode on seeded numpy inputs: odd M (the zero-code pad
    column), LUT rows all equal (every row ties: order by id alone) and
    LUTs of small values (many exact ties), with a mask."""
    Q, N, k = 9, 700, 40
    lut, _, payload = _inputs(Q, N, m, 4, seed=11 * m + len(kind))
    if kind == "equal_rows":
        lut[:] = lut[:, :, :1]
    elif kind == "small":
        lut = np.random.default_rng(m).integers(-2, 3, lut.shape).astype(np.int8)
    mask = (np.random.default_rng(m).random(N) < 0.8).astype(np.int8)
    full = np.pad(lut, ((0, 0), (0, 2 * payload.shape[1] - m), (0, 0)))
    le = torch.from_numpy(full[:, 0::2].reshape(Q, -1).copy())
    lo = torch.from_numpy(full[:, 1::2].reshape(Q, -1).copy())
    packed, tm = torch.from_numpy(payload), torch.from_numpy(mask)
    got = _adc4_kernel_model(le, lo, packed, k, tm)
    want = A.fused_adc4_plain(le, lo, packed, k=k, mask=tm)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _equal((got[0].numpy(), got[1].numpy()),
           _ref(lut, payload, k, 4, mask, interpret=True))


def _adc_word_kernel_model(lut2d, codes, k, mask=None):
    """B4's word-kernel arithmetic in plain torch (int64 holding 32-bit
    words): each group of 4 queries' LUT as biased bytes (u8 = lut + 128,
    zero for pad queries and for the pad subspaces up to a multiple of 32),
    one word a (subspace, codeword) with query 4 g + i in byte i; at step j
    of a 32-subspace chunk the row in lane r % 32 takes subspace r ^ j,
    gathers its code's word and adds bytes 0, 2 and bytes 1, 3 to two
    words of two 16-bit lanes each; the lanes are flushed into int32 every
    8 chunks and at the end (checked exact against a plain per-query sum),
    and 128 M comes off."""
    Q, N, M = lut2d.shape[0], codes.shape[0], codes.shape[1]
    nch = A.w_chunks(M)
    ng = -(-Q // 4)
    b = torch.zeros((4 * ng, 32 * nch, 256), dtype=torch.int64)
    b[:Q, :M] = lut2d.reshape(Q, M, 256).to(torch.int64) + 128
    words = sum(b[i::4] << (8 * i) for i in range(4))      # [ng, 32 nch, 256]
    c = torch.zeros((N, 32 * nch), dtype=torch.int64)
    c[:, :M] = codes.to(torch.int64)
    rows = torch.arange(N)
    lane = rows % 32
    sc = torch.zeros((4 * ng, N), dtype=torch.int64)
    exact = torch.zeros((4 * ng, N), dtype=torch.int64)
    E = torch.zeros((ng, N), dtype=torch.int64)
    O = torch.zeros((ng, N), dtype=torch.int64)
    for ch in range(nch):
        for j in range(32):
            s = ch * 32 + (lane ^ j)
            w = words[:, s, c[rows, s]]                         # [ng, N]
            E += w & 0x00FF00FF
            O += (w >> 8) & 0x00FF00FF
            for i in range(4):
                exact[i::4] += (w >> (8 * i)) & 0xFF
        if ch % 8 == 7 or ch == nch - 1:
            assert int(E.max()) < 2 ** 32 and int(O.max()) < 2 ** 32
            sc[0::4] += E & 0xFFFF
            sc[1::4] += O & 0xFFFF
            sc[2::4] += E >> 16
            sc[3::4] += O >> 16
            assert torch.equal(sc, exact)     # no lane carried into the next
            E.zero_()
            O.zero_()
    s = (sc[:Q] - 128 * M).to(torch.int32)
    return F._masked_topk(s, k, mask)


@pytest.mark.parametrize("m,kind", [
    (1, "random"), (7, "random"), (32, "random"), (257, "random"),
    (258, "random"), (300, "random"), (300, "all_min"), (300, "all_max"),
    (32, "equal_rows"), (16, "small"), (40, "small")])
def test_adc_word_kernel_model_bit_equal_to_plain_and_reference(m, kind):
    """The word kernel's summation (``_adc_word_kernel_model``) bit-equal to
    ``fused_adc_plain`` and to the reference's ``fused_adc_pallas`` in
    interpret mode on seeded numpy inputs, with a mask: M at 1, 7, 32 and
    across the 257-subspace flush edge (257, 258, 300); LUTs all -128 and
    all 127 (the 16-bit lanes' low and high edges: every row ties, order by
    id); LUT rows all equal (every row ties); small LUT values (many exact
    ties)."""
    Q, N, k = 9, 300, 40
    lut, codes, _ = _inputs(Q, N, m, 8, seed=13 * m + len(kind))
    if kind == "all_min":
        lut[:] = -128
    elif kind == "all_max":
        lut[:] = 127
    elif kind == "equal_rows":
        lut[:] = lut[:, :, :1]
    elif kind == "small":
        lut = np.random.default_rng(m).integers(-2, 3, lut.shape).astype(np.int8)
    mask = (np.random.default_rng(m).random(N) < 0.8).astype(np.int8)
    t, tc, tm = (torch.from_numpy(lut.reshape(Q, -1)), torch.from_numpy(codes),
                 torch.from_numpy(mask))
    got = _adc_word_kernel_model(t, tc, k, tm)
    want = A.fused_adc_plain(t, tc, k=k, n_codewords=256, mask=tm)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _equal((got[0].numpy(), got[1].numpy()),
           _ref(lut, codes, k, 8, mask, interpret=True))


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
