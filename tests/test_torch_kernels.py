"""The port's kernel wrappers (``repro_torch.kernels``) against the
reference's Pallas kernels on identical numpy inputs.

On the CPU every wrapper runs its kernel's plain version (the tensor lies on
the CPU); the CUDA kernels themselves are held to those plain versions on
the card by ``chip_smoke.py`` and by the ``gpu``-marked
``tests/test_torch_gpu.py``.

Tolerances: integer arms (int8, packed int4) are bit-equal in ids and
scores to ``repro.kernels.ops.fused_topk(..., interpret=True)`` and to its
``use_pallas=False`` reference.  fp32 arms: scores within rtol 1e-6 (torch
and XLA sum a dot in different orders), ids equal outside near-ties.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import pack as RP  # noqa: E402
from repro.kernels import ops as RK  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import fused_topk as F  # noqa: E402
from repro_torch.kernels import ops as TK  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

NEG = float(np.finfo(np.float32).min)


def _inputs(kind, Q, N, d, seed, small=False):
    rng = np.random.default_rng(seed)
    if kind == "fp32":
        return (rng.standard_normal((Q, d)).astype(np.float32),
                rng.standard_normal((N, d)).astype(np.float32))
    lim = 3 if small else (8 if kind == "int4" else 128)
    q = rng.integers(-lim, lim, (Q, d)).astype(np.int8)
    x = rng.integers(-lim, lim, (N, d)).astype(np.int8)
    if kind == "int4":
        x = np.array(RP.pack_int4(jnp.asarray(x)))
    return q, x


def _port(q, x, k, metric, kind, mask):
    m = None if mask is None else torch.from_numpy(mask)
    s, i = TK.fused_topk(torch.from_numpy(q), torch.from_numpy(x), k, metric,
                         packed=kind == "int4", mask=m)
    return s.numpy(), i.numpy()


def _ref(q, x, k, metric, kind, mask, **kw):
    m = None if mask is None else jnp.asarray(mask)
    s, i = RK.fused_topk(jnp.asarray(q), jnp.asarray(x), k, metric,
                         packed=kind == "int4", mask=m, **kw)
    return np.asarray(s), np.asarray(i)


def _assert_fp32_close(got, want):
    (gs, gi), (ws, wi) = got, want
    scale = np.abs(ws).max(axis=1, keepdims=True) + 1.0
    assert np.all(np.abs(gs - ws) <= 1e-6 * scale)
    # ids may only differ where the two scores at that rank are a near-tie
    diff = gi != wi
    assert np.all(np.abs(gs - ws)[diff] <= 1e-6 * np.broadcast_to(scale, gs.shape)[diff])
    assert diff.mean() < 0.05


@pytest.mark.parametrize("kind", ["int8", "int4", "fp32"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_fused_topk_matches_reference_kernel(kind, metric, masked):
    # ragged Q and N, two corpus tiles of the reference kernel (bn = 512)
    Q, N, d, k = 37, 600, 16, 10
    seed = ["int8", "int4", "fp32"].index(kind) * 4 + 2 * (metric == "l2") + masked
    q, x = _inputs(kind, Q, N, d, seed=seed,
                   small=(kind == "int8" and metric == "ip"))
    mask = None
    if masked:
        mask = (np.random.default_rng(1).random(N) < 0.5).astype(np.int8)
    got = _port(q, x, k, metric, kind, mask)
    for kw in ({"interpret": True}, {"use_pallas": False}):
        want = _ref(q, x, k, metric, kind, mask, **kw)
        if kind == "fp32":
            _assert_fp32_close(got, want)
        else:
            assert np.array_equal(got[1], want[1]), kw
            assert np.array_equal(got[0], want[0]), kw


@pytest.mark.parametrize("kind", ["int8", "int4", "fp32"])
def test_k_larger_than_n_is_clamped(kind):
    q, x = _inputs(kind, 5, 7, 8, seed=3)
    got = _port(q, x, 50, "l2", kind, None)
    want = _ref(q, x, 50, "l2", kind, None, use_pallas=False)
    assert got[1].shape == (5, 7)
    assert np.array_equal(got[1], want[1])


def test_sparse_mask_tail_is_neg_minus_one():
    # fewer allowed rows than k across several reference tiles: the port
    # returns (float32 min, -1) in the tail, as the reference's topk_ref
    # does.  The reference Pallas kernel repeats a real id beside float32
    # min there (fused_topk.py:_merge_tile re-selects an already-taken
    # position); scores still agree, and ids agree wherever a row survived.
    q, x = _inputs("int8", 3, 600, 16, seed=4)
    mask = np.zeros(600, np.int8)
    mask[[3, 7, 520, 599]] = 1
    got = _port(q, x, 10, "ip", "int8", mask)
    want = _ref(q, x, 10, "ip", "int8", mask, use_pallas=False)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert np.all(got[1][:, 4:] == -1) and np.all(got[0][:, 4:] == NEG)
    kern = _ref(q, x, 10, "ip", "int8", mask, interpret=True)
    assert np.array_equal(got[0], kern[0])
    assert np.array_equal(got[1][:, :4], kern[1][:, :4])


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_ties_go_to_the_lowest_id(metric):
    # low-entropy codes tie constantly: both packages break ties by row id
    rng = np.random.default_rng(5)
    q = rng.integers(-1, 2, (4, 8)).astype(np.int8)
    x = np.repeat(rng.integers(-1, 2, (20, 8)).astype(np.int8), 30, axis=0)
    got = _port(q, x, 40, metric, "int8", None)
    want = _ref(q, x, 40, metric, "int8", None, use_pallas=False)
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[0], want[0])
    for s, i in zip(*got):
        for a in range(len(s) - 1):
            assert s[a] > s[a + 1] or (s[a] == s[a + 1] and i[a] < i[a + 1])


def test_order_key_is_the_ieee_total_order():
    s = torch.tensor([[-0.0, 0.0, 1.0, 1.0, -1.0, NEG]])
    pos = TR.stable_desc(s, 6)
    assert pos.tolist() == [[2, 3, 1, 0, 4, 5]]      # -0.0 below +0.0, like lax.top_k
    want = jax.lax.top_k(jnp.asarray(s.numpy()), 6)[1]
    assert np.array_equal(pos.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [1, 513])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_matches_reference_kernel(n, bits):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((n, 24)) * 0.1).astype(np.float32)
    lo, hi = np.full(24, -0.1, np.float32), np.full(24, 0.15, np.float32)
    zero = (lo + hi) / 2
    want = np.asarray(RK.quantize(*(jnp.asarray(a) for a in (x, lo, hi, zero)),
                                  bits=bits, interpret=True))
    got = TK.quantize(*(torch.from_numpy(a) for a in (x, lo, hi, zero)),
                      bits=bits).numpy()
    assert np.array_equal(got, want)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    kernels.reset_launch_counts()
    q, x = _inputs("int8", 4, 50, 8, seed=6)
    TK.fused_topk(torch.from_numpy(q), torch.from_numpy(x), 5, "ip")
    TK.quantize(torch.zeros(3, 8), torch.zeros(8), torch.ones(8), torch.zeros(8))
    assert set(kernels.launch_counts().values()) == {0}


def test_launch_geometry():
    # B3, the int8 scan's int4 form: a stage holds 128 packed bytes a row
    # (256 dims), the queries stay resident as two planes of whole 128-byte
    # chunks; at k=100, 128-byte rows four blocks an SM of 8 or 16
    # queries, two of 32; one request over a big corpus spreads over many
    # blocks; a big batch needs fewer splits; a tiny corpus is never split
    # below 2048 rows a split
    assert [F.i8_qrow(w, i4=True) for w in (1, 128, 129, 256)] == [
        144, 144, 272, 272]
    for bq, per_sm in ((8, 4), (16, 4), (32, 2)):
        smem = F.i8_smem_bytes(bq, 256, False, 128, i4=True)
        assert F.i8_blocks_per_sm(bq, 256, False, 128, i4=True) == per_sm
        assert per_sm * (smem + 1024) <= F.SM_SMEM
    assert F.layout(F.KIND_I4, 1, 4_000_000, 100, 128)[:3] == (8, 256, 528)
    assert F.layout(F.KIND_I4, 256, 4_000_000, 100, 128)[:3] == (32, 256, 33)
    # lists of 512 keys leave a 32-query block alone on its SM: 8 queries
    # a block, four an SM
    assert F.layout(F.KIND_I4, 256, 4_000_000, 400, 128)[:3] == (8, 512, 16)
    assert F.layout(F.KIND_I4, 1000, 300, 100, 128).splits == 1
    # B2 int8: lists of next_pow2(k + 96) keys (k kept, a 32-row tile and
    # at least 64 more); the query tile follows the batch, never k; the
    # queries stay in shared memory, whole KC-byte chunks of d
    assert F.i8_cap(1) == 128 and F.i8_cap(100) == F.i8_cap(160) == 256
    assert F.i8_cap(161) == F.i8_cap(416) == 512 and F.i8_cap(417) == 1024
    assert all(F.i8_cap(k) >= k + 96 for k in range(1, 5001))
    assert [F.i8_query_tile(q) for q in (1, 8, 9, 16, 17, 32, 256)] == [
        8, 8, 16, 16, 32, 32, 32]
    assert [F.i8_qrow(d) for d in (1, 128, 256, 257, 512)] == [
        272, 272, 272, 528, 528]
    # at k=100, d=256: four blocks an SM of 8 queries, three of 16, two of
    # 32, each within an SM's share
    for bq, per_sm in ((8, 4), (16, 3), (32, 2)):
        smem = F.i8_smem_bytes(bq, 256, False, 256)
        assert F.i8_blocks_per_sm(bq, 256, False, 256) == per_sm
        assert per_sm * (smem + 1024) <= F.SM_SMEM
    # one wave of resident blocks over the splits and query blocks
    assert F.layout(F.KIND_I8, 1, 4_000_000, 100, 256).splits == 528
    assert F.layout(F.KIND_I8, 256, 4_000_000, 100, 256).splits == 33
    # lists of 512 keys leave a 32-query block alone on its SM: 8 queries
    # a block, three an SM
    assert F.layout(F.KIND_I8, 256, 4_000_000, 400, 256)[:3] == (8, 512, 12)
    assert F.layout(F.KIND_I8, 1000, 300, 100, 256).splits == 1
    # a d too wide for 32 resident queries takes 8; wider still raises
    assert F.i8_query_layout(256, 100, 20000) == (8, False)
    with pytest.raises(ValueError, match="too wide"):
        F.i8_query_layout(256, 100, 30000)


@pytest.mark.parametrize("width", [1, 64, 128, 129, 300, 1000])
def test_int4_layout_fits_at_every_k(width):
    """B3's layout from k = 1 to 3000 at each batch tile: the block's
    shared memory within the 227 KB, each list of at least k keys plus
    one 32-row tile of inserts, the lists in a global scratch exactly
    where shared memory cannot hold them, and the resident blocks an SM
    within the SM's shared memory."""
    n = 4_000_000
    for q in (1, 9, 17, 256):
        for k in range(1, 3001):
            lay = F.layout(F.KIND_I4, q, n, k, width)
            assert lay.cap >= k + F.I8_BM and lay.cap == F.i8_cap(k)
            gbuf = lay.gbuf_keys > 0
            smem = F.i8_smem_bytes(lay.bq, lay.cap, gbuf, width, i4=True)
            assert smem <= F.SMEM_MAX
            assert gbuf == (F.i8_smem_bytes(lay.bq, lay.cap, False, width,
                                            i4=True) > F.SMEM_MAX)
            if gbuf:
                assert lay.gbuf_keys == (-(-q // lay.bq) * lay.splits
                                         * lay.bq * lay.cap)
            per_sm = F.i8_blocks_per_sm(lay.bq, lay.cap, gbuf, width, i4=True)
            assert per_sm == 1 or per_sm * (smem + 1024) <= F.SM_SMEM
            assert lay.bq in (8, 16, 32) and lay.bq <= max(8, q * 2)


def _i4_kernel_model(qe, qo, packed, k, metric, mask):
    """B3's arithmetic, in plain torch (int64): each packed byte split into
    its low nibble (the even dim) and its high nibble left in place (16
    times the odd dim's), the two sums against the even and odd query
    halves, the odd one shifted down by 4, and the nibbles' offset of 8
    taken off once per query; l2's |x|^2 as sum n (n - 16) plus 64 per
    nibble.  int32 wraps as the kernel's arithmetic does."""
    x = torch.from_numpy(packed).to(torch.int64)
    qe = torch.from_numpy(qe).to(torch.int64)
    qo = torch.from_numpy(qo).to(torch.int64)
    lo, hi16 = x & 0x0F, x & 0xF0
    acc_lo, acc_hi = qe @ lo.T, qo @ hi16.T
    assert bool(torch.all(acc_hi % 16 == 0))
    dot = acc_lo + (acc_hi >> 4) - 8 * (qe.sum(1) + qo.sum(1))[:, None]
    if metric == "ip":
        s = dot
    else:
        hi = hi16 >> 4
        xsq = (lo * (lo - 16)).sum(1) + (hi * (hi - 16)).sum(1) + 128 * x.shape[1]
        qn = (qe * qe).sum(1) + (qo * qo).sum(1)
        s = 2 * dot - xsq[None, :] - qn[:, None]
    s = ((s + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)
    m = None if mask is None else torch.from_numpy(mask)
    s, i = F._masked_topk(s, k, m)
    return s.numpy(), i.numpy()


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("d", [26, 64, 80])
def test_int4_kernel_model_matches_reference_kernel(metric, d):
    """The packed-word order of B3's kernel (``_i4_kernel_model``) against
    the reference's ``fused_topk4_pallas`` in interpret mode: bit-equal ids
    and scores, with a mask, at packed widths not a multiple of the
    kernel's 32-byte K-step, and on extreme nibbles (-8 against 7)."""
    Q, N, k = 37, 600, 10
    q, x = _inputs("int4", Q, N, d, seed=d + (metric == "l2"))
    q[0] = -8
    x[0] = 0xFF                                   # nibbles 15: the value 7
    mask = (np.random.default_rng(d).random(N) < 0.7).astype(np.int8)
    got = _i4_kernel_model(q[:, 0::2].copy(), q[:, 1::2].copy(), x, k,
                           metric, mask)
    want = _ref(q, x, k, metric, "int4", mask, interpret=True)
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[0], want[0])


@pytest.mark.parametrize("k", [1, 100, 1024, 1025, 5000])
@pytest.mark.parametrize("q", [1, 37, 256])
def test_fused_layout_at_any_k(k, q):
    """The whole launch layout (``layout``), as plain Python: the int8 and
    int4 scans' query tile follows the batch, their lists stay in shared
    memory up to k = 416 at least and move to a global scratch where
    shared memory cannot hold them (int4 rows are packed: half the bytes
    of the same d); the fp32 scan's query tile follows the batch, never
    k, and its lists move to global memory past k = 1952; every buffer
    holds k keys plus one round of inserts; the merge stays in shared
    memory."""
    n = 4_000_000
    for kind, d in ((F.KIND_I8, 100), (F.KIND_I8, 256), (F.KIND_I8, 257),
                    (F.KIND_I4, 50), (F.KIND_I4, 128), (F.KIND_I4, 129)):
        i4 = kind == F.KIND_I4
        lay = F.layout(kind, q, n, k, d)
        bq, gbuf = F.i8_query_layout(q, k, d, i4)
        assert (lay.bq, lay.cap) == (bq, F.i8_cap(k)) and lay.cap >= k + 96
        # 32 queries a block, or 8 where a 32-query block would be alone
        # on its SM with its lists in shared memory
        alone = (F.i8_smem_bytes(32, lay.cap, False, d, i4) <= F.SMEM_MAX
                 and F.i8_blocks_per_sm(32, lay.cap, False, d, i4) == 1)
        assert lay.bq == (8 if q == 1 or alone else 32)
        assert gbuf == (F.i8_smem_bytes(bq, lay.cap, False, d, i4)
                        > F.SMEM_MAX)
        assert gbuf == (lay.gbuf_keys > 0) and gbuf == (k > 1000 and (
            q > 1 or k > 2000))
        assert F.i8_smem_bytes(bq, lay.cap, gbuf, d, i4) <= F.SMEM_MAX
        qblocks = -(-q // bq)
        if gbuf:
            assert lay.gbuf_keys == qblocks * lay.splits * bq * lay.cap
        per_sm = F.i8_blocks_per_sm(bq, lay.cap, gbuf, d, i4)
        assert 1 <= per_sm <= (2 if bq == 32 else 4)
        assert per_sm * (F.i8_smem_bytes(bq, lay.cap, gbuf, d, i4)
                         + 1024) <= F.SM_SMEM or per_sm == 1
        assert lay.splits == max(1, min(per_sm * F._SMS // qblocks,
                                        -(-n // max(2048, 2 * k))))
        assert lay.mbuf_keys == 0
    lay = F.layout(F.KIND_F32, q, n, k)
    bq, gbuf = F.f32_query_tile(k, q)
    assert lay.bq == bq == {1: 1, 37: 32, 256: 32}[q] if k <= 100 else True
    assert lay.bq == bq == (1 if q == 1 else 8) if k >= 1024 else True
    assert lay.cap == F.f32_cap(k) >= k + 96
    assert F.f32_smem_bytes(bq, lay.cap, gbuf) <= F.SMEM_MAX
    assert gbuf == (k > 1952) == (lay.gbuf_keys > 0)
    if gbuf:
        assert lay.gbuf_keys == (-(-q // bq) * lay.splits * F.f32_lists(bq)
                                 * lay.cap)
    per_sm = F.f32_blocks_per_sm(bq, lay.cap, gbuf)
    assert per_sm == (2 if 2 * (F.f32_smem_bytes(bq, lay.cap, gbuf) + 1024)
                      <= F.SM_SMEM else 1)
    qblocks = -(-q // bq)
    assert lay.splits == max(1, min(per_sm * F._SMS // qblocks,
                                    -(-n // max(2048, 2 * k))))
    assert qblocks * lay.splits <= per_sm * F._SMS or lay.splits == 1
    assert F.merge_in_shared(k) and F.merge_in_shared(16128)
    assert not F.merge_in_shared(16129)
    assert F.layout(F.KIND_I8, 4, 40_000, 20_000, 64).mbuf_keys == 4 * 32768
    assert [F.f32_batch_tile(v) for v in (1, 4, 5, 16, 17, 32, 33, 512)] == [
        1, 1, 8, 8, 32, 32, 32, 32]
    # k narrows the fp32 tile only where its lists leave shared memory;
    # two blocks an SM while the lists are small (k <= 160)
    assert [F.f32_query_tile(k, 256)[0] for k in (160, 161, 416, 417)] == [
        32, 32, 32, 8]
    assert [F.f32_blocks_per_sm(32, F.f32_cap(k), False)
            for k in (100, 160, 161)] == [2, 2, 1]
