"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA GPU and the CUDA toolkit (the kernels build with nvcc at
first use) and skips elsewhere.  It imports no JAX, so it runs on a GPU
machine without it:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: B1 codes, the int8 / packed-int4 arms of B2 and B3, the
ADC kernels B4 / B5 and the score matrices B6-B8 are bit-equal to the
plain versions in ids and scores, at every k up to N and every M.  B2
fp32 (``hold_fp32``) is within rtol 1e-5 of the row scale of the plain
version's scores at every rank and of a float64 product at every
returned id, so ids differ only inside near-tie groups: the kernel sums
each dot as one FFMA chain in dimension order, the plain version is a
cuBLAS product (TF32 off), and the chain's error against float64 at
d = 256 reaches about 1.1e-6 of the row scale, past max(1e-6, the plain
version's), so the gate stays at 1e-5 (ROADMAP C6).
"""

import pytest
import torch

from repro_torch.core import pack as PK
from repro_torch.kernels import adc as A
from repro_torch.kernels import fused_topk as F
from repro_torch.kernels import ops as K
from repro_torch.kernels import quantize as QZ
from repro_torch.kernels import ref as R

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_bit_equal_to_plain(dev, bits):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(5003, 100, generator=g, device=dev) * 0.05
    lo = -torch.rand(100, generator=g, device=dev) * 0.1 - 0.01
    hi = torch.rand(100, generator=g, device=dev) * 0.1 + 0.01
    zero = (lo + hi) / 2
    got = QZ.quantize_cuda(x, lo, hi, zero, bits=bits)
    assert torch.equal(got, R.quantize_ref(x, lo, hi, zero, bits=bits))


@pytest.mark.parametrize("kind", ["int8", "int4", "fp32"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_fused_topk_matches_plain(dev, kind, metric):
    g = torch.Generator(device=dev).manual_seed(1)
    Q, N, d, k = 37, 70001, 64, 100
    mask = (torch.rand(N, generator=g, device=dev) < 0.5).to(torch.int8)
    if kind == "fp32":
        q = torch.randn(Q, d, generator=g, device=dev)
        x = torch.randn(N, d, generator=g, device=dev)
    else:
        lim = 8 if kind == "int4" else 128
        q = torch.randint(-lim, lim, (Q, d), generator=g, device=dev).to(torch.int8)
        x = torch.randint(-lim, lim, (N, d), generator=g, device=dev).to(torch.int8)
    if kind == "int4":
        x = PK.pack_int4(x)
        got = K.fused_topk(q, x, k, metric, packed=True, mask=mask)
        want = F.fused_topk4_plain(*K.split_nibble_queries(q), x, k=k,
                                   metric=metric, mask=mask)
    else:
        got = K.fused_topk(q, x, k, metric, mask=mask)
        want = F.fused_topk_plain(q, x, k=k, metric=metric, mask=mask)
    (gs, gi), (ws, wi) = got, want
    if kind != "fp32":
        assert torch.equal(gs, ws) and torch.equal(gi, wi)
        return
    hold_fp32(q, x, metric, mask, got, want)
    assert (gi != wi).float().mean().item() < 0.05


def _rel_err(q, x, metric, s, ids, scale):
    """Largest |score - exact| / row scale over the valid slots, the exact
    score of each returned id computed in float64."""
    valid = ids >= 0
    rows = x[ids.clamp_min(0).long()].double()           # [Q, k, d]
    q64 = q.double()
    dot = torch.einsum("qd,qkd->qk", q64, rows)
    exact = dot if metric == "ip" else -((q64 * q64).sum(1, keepdim=True)
                                         + (rows * rows).sum(2) - 2 * dot)
    err = ((s.double() - exact).abs() / scale)[valid]
    return float(err.max()) if err.numel() else 0.0


def hold_fp32(q, x, metric, mask, got, want):
    """B2 fp32: the ranks within rtol 1e-5 (of the row scale, max |plain
    score| + 1) of the plain version's, every returned id's own float64
    score within the same tolerance, the sentinels and the mask as the
    plain version's.  Returns (kernel error, plain error) against
    float64."""
    (gs, gi), (ws, wi) = got, want
    valid = wi >= 0
    assert torch.equal(gi >= 0, valid)
    assert torch.equal(gs[~valid], ws[~valid])
    scale = torch.where(valid, ws.abs(), 0).amax(dim=1, keepdim=True).double() + 1.0
    rank = ((gs.double() - ws.double()).abs() / scale)[valid]
    assert rank.numel() == 0 or float(rank.max()) <= 1e-5
    kern_err = _rel_err(q, x, metric, gs, gi, scale)
    assert kern_err <= 1e-5
    if mask is not None:
        assert bool(torch.all(mask[gi.clamp_min(0).long()][valid] != 0))
    return kern_err, _rel_err(q, x, metric, ws, wi, scale)


@pytest.mark.parametrize("kind", ["int8", "fp32", "int4"])
@pytest.mark.parametrize("k", [1024, 1025, 3000])
def test_fused_topk_at_any_k(dev, kind, k):
    """C5: B2 and B3 past the old k cap of 1024 (buffers in global memory
    beyond k = 2016), with and without a mask, both metrics."""
    g = torch.Generator(device=dev).manual_seed(4)
    Q, N, d = 37, 70001, 64
    mask = (torch.rand(N, generator=g, device=dev) < 0.5).to(torch.int8)
    for metric, mk in (("ip", None), ("l2", mask)):
        if kind == "fp32":
            q = torch.randn(Q, d, generator=g, device=dev)
            x = torch.randn(N, d, generator=g, device=dev)
        else:
            lim = 8 if kind == "int4" else 128
            q = torch.randint(-lim, lim, (Q, d), generator=g,
                              device=dev).to(torch.int8)
            x = torch.randint(-lim, lim, (N, d), generator=g,
                              device=dev).to(torch.int8)
        if kind == "int4":
            x = PK.pack_int4(x)
            got = K.fused_topk(q, x, k, metric, packed=True, mask=mk)
            want = F.fused_topk4_plain(*K.split_nibble_queries(q), x, k=k,
                                       metric=metric, mask=mk)
        else:
            got = K.fused_topk(q, x, k, metric, mask=mk)
            want = F.fused_topk_plain(q, x, k=k, metric=metric, mask=mk)
        if kind == "fp32":
            hold_fp32(q, x, metric, mk, got, want)
        else:
            assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


#: B2 fp32 edge cases: Q at 1 and at each query tile and one past it, N
#: just past a tile (256 rows) and a split (2048 rows), d not a multiple
#: of 4 or of the 16-float stage, an unaligned corpus view x[1:]
FP32_EDGES = (
    [(q, 5000, 64, 0) for q in (1, 4, 5, 8, 9, 16, 17, 32, 33, 64, 65, 129)]
    + [(9, n, 32, 0) for n in (1, 255, 256, 257, 2048, 2049, 4097)]
    + [(7, 3001, d, 0) for d in (1, 3, 100, 255)]
    + [(7, 3001, d, 1) for d in (64, 100)])


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("Q,N,d,offset", FP32_EDGES)
def test_fused_topk_fp32_edges(dev, metric, Q, N, d, offset):
    g = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn(Q, d, generator=g, device=dev)
    # offset 1: the rows of an [N, d] view one float into a flat buffer
    x = torch.randn(N * d + offset, generator=g,
                    device=dev)[offset:].view(N, d)
    if offset:
        assert x.data_ptr() % 16 != 0
    k = min(100, N)
    got = K.fused_topk(q, x, k, metric)
    want = F.fused_topk_plain(q, x, k=k, metric=metric)
    torch.cuda.synchronize()
    hold_fp32(q, x, metric, None, got, want)


@pytest.mark.parametrize("q,k,d", [(1, 100, 256), (8, 10, 128),
                                   (16, 100, 256), (256, 100, 256),
                                   (256, 400, 256), (256, 100, 257),
                                   (37, 3000, 64)])
def test_int8_layout_blocks_per_sm_match_the_card(dev, q, k, d):
    """The int8 layout's resident blocks an SM (plain Python, which sizes
    the split count) are what the occupancy API reports for the kernel
    where shared memory limits them, and never more where the launch
    bounds' eight warps do (registers may allow more)."""
    from repro_torch.kernels import _build

    lay = F.layout(F.KIND_I8, q, 4_000_000, k, d)
    gbuf = lay.gbuf_keys > 0
    per_sm = F.i8_blocks_per_sm(lay.bq, lay.cap, gbuf, d)
    for l2 in (0, 1):
        got = _build.lib("fused_topk").rt_i8_blocks_per_sm(
            l2, lay.bq, lay.cap, int(gbuf), d, 0)
        cap = 2 if lay.bq == 32 else 4
        assert got == per_sm if per_sm < cap else got >= per_sm


@pytest.mark.parametrize("q,k,w", [(1, 100, 128), (8, 10, 64),
                                   (16, 100, 128), (256, 100, 128),
                                   (256, 400, 128), (256, 100, 129),
                                   (37, 3000, 32)])
def test_int4_layout_blocks_per_sm_match_the_card(dev, q, k, w):
    """B3's layout (the int8 scan's int4 form, rows of w packed bytes):
    its resident blocks an SM are what the occupancy API reports where
    shared memory limits them, and never more where the launch bounds
    do."""
    from repro_torch.kernels import _build

    lay = F.layout(F.KIND_I4, q, 4_000_000, k, w)
    gbuf = lay.gbuf_keys > 0
    per_sm = F.i8_blocks_per_sm(lay.bq, lay.cap, gbuf, w, i4=True)
    for l2 in (0, 1):
        got = _build.lib("fused_topk").rt_i8_blocks_per_sm(
            l2, lay.bq, lay.cap, int(gbuf), w, 1)
        cap = 2 if lay.bq == 32 else 4
        assert got == per_sm if per_sm < cap else got >= per_sm


#: B2 int8 edge cases (Q, N, d, byte offset of the corpus view, codes): Q
#: at 1 and at each query tile (8, 16, 32) and one past it; N at 1, at a
#: 32-row tile and the int4 scan's 256-row tile and one either side, and
#: just past a split (2048 rows); d not a multiple of 32, and past one
#: 256-byte chunk; unaligned views x[1:] (byte loads) and 4 bytes in
#: (4-byte copies); extreme codes (-128 against 127, and against -128),
#: duplicated rows (tie order by id) and an all-zero mask
INT8_EDGES = (
    [(q, 5000, 64, 0, "random") for q in (1, 8, 9, 16, 17, 32, 33, 64, 65)]
    + [(9, n, 32, 0, "random")
       for n in (1, 31, 32, 33, 255, 256, 257, 2048, 2049, 4097)]
    + [(7, 3001, d, 0, "random") for d in (1, 3, 31, 33, 100, 255, 257, 600)]
    + [(7, 3001, d, off, "random") for d, off in ((64, 1), (100, 1), (64, 4))]
    + [(33, 3001, 255, 0, c)
       for c in ("min_max", "min_min", "duplicated", "zero_mask")])


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("Q,N,d,offset,codes", INT8_EDGES)
def test_fused_topk_int8_edges(dev, metric, Q, N, d, offset, codes):
    g = torch.Generator(device=dev).manual_seed(7)

    def rand(*shape):
        return torch.randint(-128, 128, shape, generator=g,
                             device=dev).to(torch.int8)

    q, flat, mask = rand(Q, d), rand(N * d + offset), None
    if codes == "min_max":
        q.fill_(-128)
        flat.fill_(127)
    elif codes == "min_min":
        q.fill_(-128)
        flat.fill_(-128)
    elif codes == "duplicated":
        flat[offset:] = rand(50, d).repeat(-(-N // 50), 1)[:N].reshape(-1)
    elif codes == "zero_mask":
        mask = torch.zeros(N, dtype=torch.int8, device=dev)
    # offset > 0: the rows of an [N, d] view that many bytes into a buffer
    x = flat[offset:].view(N, d)
    if offset:
        assert x.data_ptr() % 16 != 0
    k = min(100, N)
    got = K.fused_topk(q, x, k, metric, mask=mask)
    want = F.fused_topk_plain(q, x, k=k, metric=metric, mask=mask)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    if codes == "zero_mask":
        assert bool(torch.all(got[1] == -1))


#: B3 edge cases (Q, N, packed row bytes w, byte offset of the corpus
#: view, codes), as broad as B2 int8's: Q at 1 and at each query tile (8,
#: 16, 32) and one past it, and 256; N at 1, at a 32-row tile and one either
#: side, and just past a split (2048 rows); packed widths that are odd and
#: not a multiple of the 32-byte K-step, and past one 128-byte chunk;
#: unaligned views x[1:] (byte loads) and 4 bytes in (4-byte copies);
#: extreme nibbles (-8 against 7, and against -8), duplicated rows (tie
#: order by id), an all-zero mask, and a sparse mask with fewer allowed
#: rows than k (ROADMAP C3's tail: (float32 min, -1))
INT4_EDGES = (
    [(q, 5000, 32, 0, "random") for q in (1, 8, 9, 16, 17, 32, 33, 256)]
    + [(9, n, 16, 0, "random") for n in (1, 31, 32, 33, 2049, 4097)]
    + [(7, 3001, w, 0, "random") for w in (1, 3, 13, 17, 33, 100, 129, 300)]
    + [(7, 3001, w, off, "random") for w, off in ((32, 1), (50, 1), (32, 4))]
    + [(33, 3001, 127, 0, c) for c in ("min_max", "min_min", "duplicated",
                                       "zero_mask", "sparse_mask")])


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("Q,N,w,offset,codes", INT4_EDGES)
def test_fused_topk_int4_edges(dev, metric, Q, N, w, offset, codes):
    g = torch.Generator(device=dev).manual_seed(9)

    def rand(*shape):
        return torch.randint(-8, 8, shape, generator=g,
                             device=dev).to(torch.int8)

    q, mask = rand(Q, 2 * w), None
    flat = PK.pack_int4(rand(N + 1, 2 * w)).reshape(-1)
    if codes == "min_max":
        q.fill_(-8)
        flat.fill_(0xFF)                       # nibbles 15: the value 7
    elif codes == "min_min":
        q.fill_(-8)
        flat.fill_(0x00)                       # nibbles 0: the value -8
    elif codes == "duplicated":
        flat[:N * w] = flat[:50 * w].repeat(-(-N // 50))[:N * w]
    elif codes == "zero_mask":
        mask = torch.zeros(N, dtype=torch.int8, device=dev)
    elif codes == "sparse_mask":
        mask = torch.zeros(N, dtype=torch.int8, device=dev)
        mask[[3, 40, 1500, N - 1]] = 1
    # offset > 0: the rows of an [N, w] view that many bytes into a buffer
    x = flat[offset:offset + N * w].view(N, w)
    if offset:
        assert x.data_ptr() % 16 != 0
    k = min(100, N)
    got = K.fused_topk(q, x, k, metric, packed=True, mask=mask)
    want = F.fused_topk4_plain(*K.split_nibble_queries(q), x, k=k,
                               metric=metric, mask=mask)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    if codes == "zero_mask":
        assert bool(torch.all(got[1] == -1))
    if codes == "sparse_mask":
        assert bool(torch.all(got[1][:, 4:] == -1))
        assert bool(torch.all(got[0][:, 4:] == R.NEG))


@pytest.mark.parametrize("bits,m", [(8, 32), (8, 7), (4, 64), (4, 7)])
@pytest.mark.parametrize("k", [1, 100, 400])
def test_fused_adc_matches_plain(dev, bits, m, k):
    g = torch.Generator(device=dev).manual_seed(2)
    Q, N, kc = 37, 70001, 2 ** bits
    lut = torch.randint(-128, 128, (Q, m, kc), generator=g,
                        device=dev).to(torch.int8)
    codes = torch.randint(0, kc, (N, m), generator=g, device=dev).to(torch.uint8)
    mask = (torch.rand(N, generator=g, device=dev) < 0.5).to(torch.int8)
    for mk in (None, mask):
        if bits == 8:
            got = K.fused_adc_topk(lut, codes, k, mask=mk)
            want = A.fused_adc_plain(lut.reshape(Q, -1), codes, k=k,
                                     n_codewords=kc, mask=mk)
        else:
            packed = PK.pack_uint4(codes)
            got = K.fused_adc_topk(lut, packed, k, packed=True, mask=mk)
            full = torch.nn.functional.pad(lut, (0, 0, 0, m % 2))
            want = A.fused_adc4_plain(full[:, 0::2].reshape(Q, -1).contiguous(),
                                      full[:, 1::2].reshape(Q, -1).contiguous(),
                                      packed, k=k, mask=mk)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


#: C5's wide LUTs and deep k (bits, M, Q, k): B4 / B5 at M = 256, 512 and
#: 1024 at Q = 1 and 3 (the gather kernel, whose LUTs leave room for one
#: query a block or none: B4 reads them from global memory at 4 queries a
#: block) and Q = 9 (B4's word kernel, its LUTs read from global memory
#: past M = 192; B5's one-hot MMA kernel), k = 100 and 1025; then the B4
#: gather kernel's other instances: lists in global memory at 1 and 2
#: queries a block and at 4 with the LUTs in global memory (k = 3000), 4
#: queries a block with the LUTs in shared memory and the lists in shared
#: (M = 128, k = 100) or global memory (k = 1025), and 2 queries a block
#: with both in shared memory (tests/test_torch_adc.py checks that these
#: cases reach every instance)
ADC_WIDE = ([(bits, m, q, k)
             for bits, m in ((8, 256), (8, 512), (8, 1024), (4, 256),
                             (4, 1024))
             for q in (1, 3, 9) for k in (100, 1025)]
            + [(8, 512, 1, 3000), (8, 256, 2, 3000), (8, 256, 3, 3000),
               (8, 128, 3, 100), (8, 128, 3, 1025), (8, 128, 2, 100)])


@pytest.mark.parametrize("bits,m,Q,k", ADC_WIDE)
def test_fused_adc_wide_lut_and_any_k(dev, bits, m, Q, k):
    """C5: B4 / B5 at the wide LUTs and deep k of ``ADC_WIDE``, through
    every kernel and instance that such batches take; bit-equal with and
    without a mask."""
    g = torch.Generator(device=dev).manual_seed(5)
    N, kc = 20001, 2 ** bits
    lut = torch.randint(-128, 128, (Q, m, kc), generator=g,
                        device=dev).to(torch.int8)
    codes = torch.randint(0, kc, (N, m), generator=g, device=dev).to(torch.uint8)
    mask = (torch.rand(N, generator=g, device=dev) < 0.5).to(torch.int8)
    for mk in (None, mask):
        if bits == 8:
            got = K.fused_adc_topk(lut, codes, k, mask=mk)
            want = A.fused_adc_plain(lut.reshape(Q, -1), codes, k=k,
                                     n_codewords=kc, mask=mk)
        else:
            packed = PK.pack_uint4(codes)
            got = K.fused_adc_topk(lut, packed, k, packed=True, mask=mk)
            want = A.fused_adc4_plain(lut[:, 0::2].reshape(Q, -1).contiguous(),
                                      lut[:, 1::2].reshape(Q, -1).contiguous(),
                                      packed, k=k, mask=mk)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


#: B5 edge cases (Q, N, M, k, LUT / codes, code view offset): Q at 1 and at
#: each query tile (8, 16, 32) and one past it, and 256; N at 1, at a
#: 32-row tile and one either side, and past a split; M odd (a zero-code
#: pad column), M at one and two code bytes, past one 64-byte stage chunk,
#: and M = 512 / 1024 (LUTs of 8 and 16 KB a query); k = 1, 100, 400, past
#: 1024 and 3000 (lists in global memory); LUT rows all equal (every row
#: ties: order by id alone), small LUT values (many exact ties), the
#: extremes (-128 and 127), an unaligned code view (byte copies), an
#: all-zero and a sparse mask; and M = 1800, past the one-hot kernel's
#: widest row (its LUTs read from global memory by the gather kernel)
ADC4_EDGES = (
    [(q, 3001, 64, 100, "random", 0) for q in (1, 8, 9, 16, 17, 32, 33, 256)]
    + [(9, n, 16, 100, "random", 0) for n in (1, 31, 32, 33, 4097)]
    + [(9, 3001, m, 100, "random", 0)
       for m in (1, 2, 3, 4, 63, 129, 130, 512, 1024, 1800)]
    + [(37, 20001, 64, k, "random", 0) for k in (1, 400, 1025, 3000)]
    + [(37, 3001, 7, 100, c, 0) for c in ("equal_rows", "small", "extreme",
                                          "zero_mask", "sparse_mask")]
    + [(9, 3001, m, 100, "random", 1) for m in (32, 33)])


@pytest.mark.parametrize("Q,N,m,k,kind,offset", ADC4_EDGES)
def test_fused_adc4_edges(dev, Q, N, m, k, kind, offset):
    g = torch.Generator(device=dev).manual_seed(10)
    lut = torch.randint(-128, 128, (Q, m, 16), generator=g,
                        device=dev).to(torch.int8)
    codes = torch.randint(0, 16, (N, m), generator=g, device=dev).to(torch.uint8)
    mask = None
    if kind == "equal_rows":
        lut[:] = lut[:, :, :1]
    elif kind == "small":
        lut = torch.randint(-2, 3, lut.shape, generator=g,
                            device=dev).to(torch.int8)
    elif kind == "extreme":
        lut[0].fill_(-128)
        lut[1:].fill_(127)
    elif kind == "zero_mask":
        mask = torch.zeros(N, dtype=torch.int8, device=dev)
    elif kind == "sparse_mask":
        mask = torch.zeros(N, dtype=torch.int8, device=dev)
        mask[[3, 40, 1500, N - 1]] = 1
    packed = PK.pack_uint4(codes)
    if offset:
        # the rows of an [N, w] view `offset` bytes into a buffer
        flat = torch.empty(packed.numel() + offset, dtype=torch.uint8,
                           device=dev)
        flat[offset:] = packed.reshape(-1)
        packed = flat[offset:].view(packed.shape)
        assert packed.data_ptr() % 16 != 0
    k = min(k, N)
    got = K.fused_adc_topk(lut, packed, k, packed=True, mask=mask)
    full = torch.nn.functional.pad(lut, (0, 0, 0, m % 2))
    want = A.fused_adc4_plain(full[:, 0::2].reshape(Q, -1).contiguous(),
                              full[:, 1::2].reshape(Q, -1).contiguous(),
                              packed, k=k, mask=mask)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    if kind == "zero_mask":
        assert bool(torch.all(got[1] == -1))
    if kind == "sparse_mask":
        assert bool(torch.all(got[1][:, 4:] == -1))


@pytest.mark.parametrize("q,k,mb", [(8, 100, 32), (9, 10, 16), (17, 100, 32),
                                    (256, 100, 32), (256, 400, 32),
                                    (256, 100, 33), (37, 3000, 64),
                                    (9, 100, 512)])
def test_adc4_layout_blocks_per_sm_match_the_card(dev, q, k, mb):
    """B5's layout: its resident blocks an SM (plain Python, which sizes
    the split count) are what the occupancy API reports where shared
    memory limits them, and never more where the launch bounds do."""
    from repro_torch.kernels import _build

    lay = A.adc_layout(k, mb, 4, q, 4_000_000)
    gbuf = lay.gbuf_keys > 0
    per_sm = A.a4_blocks_per_sm(lay.bq, lay.cap, gbuf, mb)
    got = _build.lib("adc").rt_adc4_blocks_per_sm(lay.bq, lay.cap, int(gbuf),
                                                 mb)
    cap = 2 if lay.bq == 32 else 4
    assert got == per_sm if per_sm < cap else got >= per_sm


#: B4 edge cases around the word kernel (Q, N, M, k, LUT kind, mask): M
#: across the 257-subspace flush of its 16-bit lanes (257, 258, 300: LUTs
#: read from global memory), at 192 / 193 (the widest LUTs kept in shared
#: memory, the first read from global memory) and at 33 (two chunks, the
#: second all but one pad subspace); LUTs all -128 and all 127 (every row
#: ties: order by id alone) and small values (many ties) at M = 32 and
#: 300; k = 1024, 1025 and 3000 (lists in global memory); Q = 4 and 5 (the
#: gather kernel's last batch, the word kernel's first), with and without
#: a mask
ADC_WORD_EDGES = (
    [(9, 3001, m, 100, "random", False) for m in (257, 258, 300, 192, 193, 33)]
    + [(37, 3001, m, 100, c, True) for m in (32, 300)
       for c in ("all_min", "all_max", "small")]
    + [(37, 20001, 32, k, "random", True) for k in (1024, 1025, 3000)]
    + [(q, 20001, 32, 100, "random", mk) for q in (4, 5)
       for mk in (False, True)])


@pytest.mark.parametrize("Q,N,m,k,kind,masked", ADC_WORD_EDGES)
def test_fused_adc_word_edges(dev, Q, N, m, k, kind, masked):
    g = torch.Generator(device=dev).manual_seed(11)
    lut = torch.randint(-128, 128, (Q, m, 256), generator=g,
                        device=dev).to(torch.int8)
    codes = torch.randint(0, 256, (N, m), generator=g,
                          device=dev).to(torch.uint8)
    if kind == "all_min":
        lut.fill_(-128)
    elif kind == "all_max":
        lut.fill_(127)
    elif kind == "small":
        lut = torch.randint(-2, 3, lut.shape, generator=g,
                            device=dev).to(torch.int8)
    mask = ((torch.rand(N, generator=g, device=dev) < 0.5).to(torch.int8)
            if masked else None)
    assert A.adc_layout(k, m, 8, Q, N).word == (Q > 4)
    got = K.fused_adc_topk(lut, codes, k, mask=mask)
    want = A.fused_adc_plain(lut.reshape(Q, -1), codes, k=k, n_codewords=256,
                             mask=mask)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("q,k,mb", [(256, 100, 32), (256, 100, 16),
                                    (256, 400, 32), (9, 100, 64),
                                    (37, 3000, 32), (9, 100, 300),
                                    (9, 100, 192)])
def test_adc_word_layout_blocks_per_sm_match_the_card(dev, q, k, mb):
    """B4's word-kernel layout: its resident blocks an SM (plain Python,
    which sizes the split count) are what the occupancy API reports where
    shared memory limits them, and never more where registers do."""
    from repro_torch.kernels import _build

    lay = A.adc_layout(k, mb, 8, q, 4_000_000)
    assert lay.word
    gbuf = lay.gbuf_keys > 0
    per_sm = A.w_blocks_per_sm(lay.bq, lay.subsets, lay.cap, mb, gbuf,
                               lay.lutg)
    got = _build.lib("adc").rt_adc_word_blocks_per_sm(
        lay.bq, lay.subsets, lay.cap, int(gbuf), int(lay.lutg), mb)
    regs = 18 // (lay.bq // 4 * lay.subsets + 1)
    assert got == per_sm if per_sm < regs else got >= per_sm


def test_rerank_search_at_wide_depth_matches_cpu(dev):
    """C5: a ``flat,lpq4+r32`` search at k=300 scans at depth 1200 (B3
    past the old cap) on a CUDA store and answers as the same index built
    on the CPU does."""
    from repro_torch.knn import make_index

    g = torch.Generator().manual_seed(8)
    corpus = torch.randn(30000, 64, generator=g)
    queries = torch.randn(16, 64, generator=g)
    gpu = make_index("flat,lpq4+r32", corpus, metric="ip", device=dev)
    cpu = make_index("flat,lpq4+r32", corpus, metric="ip", device="cpu")
    assert torch.equal(gpu.store.data.cpu(), cpu.store.data)
    qc = gpu.store.encode_queries(queries.to(dev))
    got = K.fused_topk(qc, gpu.store.data, 1200, "ip", packed=True)
    want = K.fused_topk(qc.cpu(), cpu.store.data, 1200, "ip", packed=True)
    assert torch.equal(got[1].cpu(), want[1]) and torch.equal(got[0].cpu(), want[0])
    s = gpu.searcher(300)
    assert s.rerank is not None and s.rerank.depth == 1200
    got = s(queries.to(dev))
    want = cpu.searcher(300)(queries)
    # the fp32 rerank sums on the card and on the CPU in their own orders
    scale = want.scores.abs().amax(dim=1, keepdim=True) + 1.0
    assert bool(torch.all((got.scores.cpu() - want.scores).abs() <= 1e-6 * scale))
    assert (got.ids.cpu() != want.ids).float().mean().item() < 0.01


#: edge cases of the tensor-core kernel's tiling (B6-B8): Q at each
#: query-tile boundary; N at and just past the corpus tile ("t") and k
#: times the SM count of tiles ("s<k>", the persistent stride at k blocks
#: an SM), odd N leaving output rows unaligned; d = 31 ... 34; rows of 17,
#: 50, 51 and 129 bytes when packed (B8b's pad bytes past the row are not a
#: multiple of a 64-byte chunk), each also as a corpus view at an unaligned
#: base (``offset`` 1: ``x[1:]`` of an [N + 1, d] buffer); and "wrap": the
#: extreme pairs at a width where -(|q|^2 + |x|^2 - 2 q . x) wraps in int32.
EDGE_CASES = (
    [(q, 1000, 128, 0) for q in (1, 7, 8, 9, 16, 17, 64, 65, 128, 129)]
    + [(q, n, 64, 0) for q in (1, 100)
       for n in ("t", "t+1", "s1", "s1+1", "s2", "s2+1")]
    + [(5, 333, d, 0) for d in (31, 32, 33, 34)]
    + [(9, 1000, 2 * w, off) for w in (17, 50, 51, 129) for off in (0, 1)]
    + [(2, 3, "wrap", 0)])
#: the "wrap" width: (-128 - 127)^2 d passes 2^31 for int8 rows, (-128 -
#: 7)^2 d for int8 queries against int4 nibbles
WRAP_WIDTHS = {"qmip": 33_040, "ql2": 33_040, "qmip4": 117_840,
               "ql24": 117_840}


def _resolve_n(n, q, dev):
    """An edge case's N: an int, or a multiple of the corpus tile."""
    from repro_torch.kernels import _qscore

    if isinstance(n, int):
        return n
    bm = _qscore.mma_tiles(q)[1]
    base, _, plus = n.partition("+")
    k = 1 if base == "t" else (
        int(base[1:]) * torch.cuda.get_device_properties(dev).multi_processor_count)
    return k * bm + int(plus or 0)


@pytest.mark.parametrize("name", ["qmip", "ql2", "qmip4", "ql24"])
@pytest.mark.parametrize("Q,N,d,offset", [
    (1, 1, 8, 0), (37, 70001, 100, 0), (300, 511, 128, 0), (33, 2049, 258, 0),
    (2, 1000, 7, 0)] + EDGE_CASES)
def test_score_matrix_bit_equal_to_plain(dev, name, Q, N, d, offset):
    """B6-B8 against their plain versions on ragged Q, N and d (d % 4 != 0,
    d % 16 != 0, an odd packed width), the tensor-core kernel's tile
    boundaries, unaligned corpus views, random codes and extreme ones."""
    from repro_torch.kernels import packed as PKD
    from repro_torch.kernels import ql2 as L2K
    from repro_torch.kernels import qmip as IPK

    packed = name in ("qmip4", "ql24")
    wrap = d == "wrap"
    if wrap:
        d = WRAP_WIDTHS[name]
    elif packed and d % 2:
        d += 1
    N = _resolve_n(N, Q, dev)
    g = torch.Generator(device=dev).manual_seed(3)
    lim = 8 if packed else 128
    q = torch.randint(-lim, lim, (Q, d), generator=g, device=dev).to(torch.int8)
    x = torch.randint(-lim, lim, (N + offset, d), generator=g,
                      device=dev).to(torch.int8)
    q[0] = -lim
    x[offset] = -lim
    x[-1] = lim - 1
    if wrap:                          # int8 queries at both ends of the range
        q[0], q[1] = -128, 127
    plain = {"qmip": IPK.qmip_plain, "ql2": L2K.ql2_plain,
             "qmip4": PKD.qmip4_plain, "ql24": PKD.ql24_plain}[name]
    if packed:
        px = PK.pack_int4(x)[offset:]
        got = getattr(K, name)(q, px)
        want = plain(*K.split_nibble_queries(q), px)
    else:
        x = x[offset:]
        got = getattr(K, name)(q, x)
        want = plain(q, x)
    if offset:
        assert (x if not packed else px).data_ptr() % 16 != 0
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    if wrap and name in ("ql2", "ql24"):
        assert want[0, -1] > 0          # the sum of squares wrapped


@pytest.mark.parametrize("f,metric", [("hnsw8,lpq8@gaussian:3", "ip"),
                                      ("hnsw8,lpq8", "l2"),
                                      ("hnsw8,lpq8@global_absmax", "angular"),
                                      ("hnsw8,lpq4", "ip")])
def test_hnsw_on_the_card_equals_the_cpu(dev, f, metric):
    """The graph walk on the card: an integer arm built on the card and on
    the CPU from the same inputs (levels, and Eq. 1 constants learned once
    on the CPU) has the same codes, adjacency and entry, and a bucketed
    Searcher returns the same ids and scores (``chip_smoke.py`` phase 7(a)
    at a smaller size)."""
    import dataclasses

    from repro_torch.knn import SearchParams, as_spec
    from repro_torch.knn.hnsw import HNSWIndex, draw_levels

    g = torch.Generator().manual_seed(9)
    corpus = torch.randn(1500, 32, generator=g)
    queries = torch.randn(45, 32, generator=g)
    levels = draw_levels(1500, 8, 0)
    spec = as_spec(f, metric=metric)
    spec = dataclasses.replace(
        spec, quant=spec.quant.with_params(spec.quant.learn(corpus)))
    built = [HNSWIndex.build(corpus, spec, device=d, ef_construction=40,
                             batch_size=128, _levels=levels)
             for d in (dev, "cpu")]
    card, cpu = built
    assert torch.equal(card.store.data.cpu(), cpu.store.data)
    assert len(card.layers) == len(cpu.layers) > 1
    for a, b in zip(card.layers, cpu.layers):
        assert torch.equal(a.cpu(), b)
    assert card.entry == cpu.entry
    for ef in (16, 40):
        # 45 queries: a 32-query bucket and a padded 32 for the rest
        got, want = (i.searcher(10, SearchParams(ef_search=ef),
                                batch_sizes=(1, 8, 32))(queries)
                     for i in built)
        assert torch.equal(got.ids.cpu(), want.ids)
        assert torch.equal(got.scores.cpu(), want.scores)
        assert got.stats == want.stats


@pytest.mark.parametrize("f,metric", [("graph8,lpq8@gaussian:3", "ip"),
                                      ("graph8,lpq8", "l2"),
                                      ("graph8,lpq8@global_absmax", "angular"),
                                      ("graph8,lpq4", "ip"),
                                      ("ivf16,lpq8@gaussian:3", "ip"),
                                      ("ivf16,lpq8", "l2"),
                                      ("ivf16,lpq4", "ip")])
def test_graph_and_ivf_on_the_card_equal_the_cpu(dev, f, metric):
    """The graph and ivf kinds on the card: an integer arm built on the card
    and on the CPU from the same inputs (k-means centroids, the ip
    augmentation column and Eq. 1 constants made once on the CPU) has the
    same codes and graph / lists, and a bucketed Searcher returns the same
    ids, scores and stats (``chip_smoke.py`` phase 8(a) at a smaller
    size).  The self-join runs B2 / B3 at Q = N."""
    import dataclasses

    from repro_torch.knn import SearchParams, as_spec
    from repro_torch.knn.graph_index import mip_column
    from repro_torch.knn.ivf import kmeans
    from repro_torch.knn.registry import get_impl

    g = torch.Generator().manual_seed(10)
    corpus = torch.randn(1500, 32, generator=g)
    queries = torch.randn(45, 32, generator=g)
    spec = as_spec(f, metric=metric)
    x = corpus
    if spec.kind == "ivf":
        spec = dataclasses.replace(
            spec, quant=spec.quant.with_params(spec.quant.learn(x)))
        given = {"centroids": kmeans(x, 16, 0)}
        sp = SearchParams(nprobe=4)
    else:
        given = {}
        if metric == "ip":
            given["extra"] = mip_column(x)
            x = torch.cat([x, given["extra"][:, None]], dim=-1)
        given.update(centroids=kmeans(x, 32, 0), params=spec.quant.learn(x))
        sp = SearchParams(ef_search=40)
    card, cpu = (get_impl(spec.kind).build(corpus, spec, device=d,
                                           _given=given)
                 for d in (dev, "cpu"))
    assert torch.equal(card.store.data.cpu(), cpu.store.data)
    for name in (("adj", "seed_ids") if spec.kind == "graph" else ("lists",)):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name))
    got, want = (i.searcher(10, sp, batch_sizes=(1, 8, 32))(queries)
                 for i in (card, cpu))
    assert torch.equal(got.ids.cpu(), want.ids)
    assert torch.equal(got.scores.cpu(), want.scores)
    assert got.stats == want.stats


FILTER_SELS = (0.02, 0.25, 0.9)


@pytest.mark.parametrize("f,metric", [("flat,lpq8@global_minmax", "ip"),
                                      ("flat,lpq4@global_minmax", "l2"),
                                      ("pq16+lpq", "ip"),
                                      ("pq16x4,lpq8", "l2"),
                                      ("ivf16,lpq8@global_minmax", "ip"),
                                      ("hnsw8,lpq8@global_minmax", "ip"),
                                      ("graph8,lpq8@global_minmax", "l2")])
def test_filtered_search_on_the_card_equals_the_cpu(dev, f, metric):
    """A filtered Searcher on the card (B2 / B3 / B4 / B5 with the filter
    bitmap as their mask, ivf's masked coarse probe, the walks' masked
    cut) returns the CPU's ids, scores and stats, bit for bit, at every
    bucket and selectivity, on one index (built on the CPU, loaded on the
    card)."""
    import io

    import numpy as np

    from repro_torch.filter import Filter
    from repro_torch.knn import SearchParams, load_index, make_index

    g = torch.Generator().manual_seed(11)
    corpus = torch.randn(1500, 32, generator=g)
    queries = torch.randn(45, 32, generator=g)
    cpu = make_index(f, corpus, metric=metric, device="cpu", kmeans_iters=4,
                     ef_construction=40)
    buf = io.BytesIO()
    cpu.save(buf)
    card = load_index(io.BytesIO(buf.getvalue()), device=dev)
    for sel in FILTER_SELS:
        allow = np.random.default_rng(int(sel * 100)).random(1500) < sel
        sp = SearchParams(nprobe=4, ef_search=40,
                          filter=Filter.from_mask(allow))
        got, want = (i.searcher(10, sp, batch_sizes=(1, 8, 32))(queries)
                     for i in (card, cpu))
        assert torch.equal(got.ids.cpu(), want.ids)
        assert torch.equal(got.scores.cpu(), want.scores)
        # the engine's chunk and byte counts follow the scan each device
        # runs (a kernel's tiles, the plain scan's chunks); the filter's own
        # stats do not
        for key in ("filter_selectivity", "filter_lists_skipped", "kind"):
            assert got.stats.get(key) == want.stats.get(key), key
        ids = want.ids.numpy()
        assert allow[ids[ids >= 0]].all()


@pytest.mark.parametrize("f", ["stream(flat,lpq8@global_minmax)",
                               "stream(flat,lpq4@global_absmax)+r32"])
def test_stream_lifecycle_on_the_card_equals_the_cpu(dev, f):
    """One write sequence (upserts that replace rows and add ids, deletes,
    seals, auto compaction, full compaction) on the card and on the CPU:
    equal segments, external ids, live bitmaps, counters and epoch, and a
    filtered Searcher's results equal at every bucket: bit for bit where
    the plan passes one integer source through, else (the merge re-scores
    in fp32 on each device) scores within rtol 1e-5 of the row scale and
    ids equal outside near-ties (``repro_torch.testing.lifecycles_equal``,
    which ``chip_smoke.py`` phase 9(a) runs at a larger size)."""
    import numpy as np

    from repro_torch.knn import make_index
    from repro_torch.testing import lifecycles_equal, stream_lifecycle

    rng = np.random.default_rng(12)
    corpus = rng.standard_normal((3000, 32)).astype(np.float32)
    queries = rng.standard_normal((45, 32)).astype(np.float32)
    allow = rng.random(4500) < 0.3
    runs = [stream_lifecycle(make_index, f, corpus, queries, allow,
                             (1, 8, 32, 4), bulk=1500,
                             searcher_kw={"batch_sizes": (1, 8, 32)},
                             device=d, seal_threshold=256, max_segments=4)
            for d in (dev, "cpu")]
    diff, _exact, _same = lifecycles_equal(*runs, allow, 1e-5)
    assert diff is None, diff


#: the cascade and regions arms (the reference's conformance factories,
#: tests/test_conformance.py:44-53): factory -> build overrides
CASCADE_REGION_ARMS = {
    "cascade(flat,lpq4|r32)": {},
    "cascade(pq16x4|lpq8|r32)": {"kmeans_iters": 4},
    "cascade(ivf8,lpq8|lpq8|r8)": {"kmeans_iters": 4},
    "ivf8,lpq8,regions": {"kmeans_iters": 4},
    "hnsw8,lpq8,regions": {"ef_construction": 40, "batch_size": 128},
    "graph16,lpq4,regions": {"n_seeds": 16},
}


@pytest.mark.parametrize("f", sorted(CASCADE_REGION_ARMS))
def test_cascade_and_regions_on_the_card_equal_the_cpu(dev, f):
    """A cascade or regions arm built on the card and on the CPU from the
    same draws (``testing.build_draws`` reads them off the CPU build;
    region constants are fitted on the host either way): every store's
    codes and the region constants equal; a bucketed Searcher, unfiltered
    and filtered, returns the same ids and scores, bit for bit where the
    final stage is integer, within rtol 1e-5 of the row scale where it is
    fp32 (``r32`` stages and regional re-scores, ids equal outside
    near-ties)."""
    import numpy as np

    from repro_torch.filter import Filter
    from repro_torch.knn import SearchParams
    from repro_torch.knn import as_spec
    from repro_torch.knn.registry import get_impl
    from repro_torch.testing import build_draws, fp32_near_equal

    rng = np.random.default_rng(11)
    corpus = rng.standard_normal((1500, 32)).astype(np.float32)
    queries = rng.standard_normal((45, 32)).astype(np.float32)
    over = CASCADE_REGION_ARMS[f]
    spec = as_spec(f, metric="ip")
    cpu = get_impl(spec.kind).build(corpus, spec, device="cpu", **over)
    spec, kw = build_draws(f, "ip", cpu, corpus)
    card = get_impl(spec.kind).build(corpus, spec, device=dev, **kw, **over)

    def stores(i):
        if spec.kind == "cascade":
            return [i.head.store, *i.stage_stores]
        return [i.store] + ([i.region_store] if spec.kind != "ivf" else [])

    for a, b in zip(stores(card), stores(cpu)):
        data = a.codes if hasattr(a, "codes") else a.data
        want = b.codes if hasattr(b, "codes") else b.data
        assert torch.equal(data.cpu(), want)
    if spec.kind != "cascade":
        for name in ("assign", "lo", "hi", "zero"):
            assert torch.equal(getattr(card.regions, name).cpu(),
                               getattr(cpu.regions, name))
    integer = spec.kind == "cascade" and cpu.rerank_bits < 32
    allow = np.random.default_rng(12).random(1500) < 0.25
    for filt in (None, Filter.from_mask(allow)):
        sp = SearchParams(nprobe=4, ef_search=40, filter=filt)
        got, want = (i.searcher(10, sp, batch_sizes=(1, 8, 32))(queries)
                     for i in (card, cpu))
        gs, gi = got.scores.cpu().numpy(), got.ids.cpu().numpy()
        ws, wi = want.scores.numpy(), want.ids.numpy()
        if integer:
            assert np.array_equal(gi, wi) and np.array_equal(gs, ws)
        else:
            assert fp32_near_equal(gs, gi, ws, wi, 1e-5)[0]
        if spec.kind == "cascade":
            # the head's bytes follow each device's scan (passes a query
            # tile); labels, budgets, bits and the stages' gathers do not
            a, b = got.stats["stages"], want.stats["stages"]
            assert [(r[0], r[1], r[3]) for r in a] == \
                [(r[0], r[1], r[3]) for r in b]
            assert a[1:] == b[1:]


# --------------------------------------------------------------------------
# tuning: the layouts a TuneTable may choose, and tuned dispatch
# --------------------------------------------------------------------------

def _layout_bns(n: int, tile: int):
    """Split lengths that reach one split, a few and many (a split of one
    tile) and a ragged last split."""
    return (n, -(-n // 7), tile, 3 * tile + 5)


@pytest.mark.parametrize("kind", ["int8", "int4", "fp32"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_fused_topk_layout_overrides_equal_the_plain_version(dev, kind,
                                                             metric):
    """Every block B2 / B3 holds (``F.block_rows``) at every split length
    of ``_layout_bns`` gives the plain version's top-k (fp32: within
    ``hold_fp32``'s gate), masked too, at k=100 and past 1024."""
    g = torch.Generator(device=dev).manual_seed(11)
    Q, N, d = 37, 70001, 64
    mask = (torch.rand(N, generator=g, device=dev) < 0.5).to(torch.int8)
    if kind == "fp32":
        q = torch.randn(Q, d, generator=g, device=dev)
        x = torch.randn(N, d, generator=g, device=dev)
    else:
        lim = 8 if kind == "int4" else 128
        q = torch.randint(-lim, lim, (Q, d), generator=g, device=dev).to(torch.int8)
        x = torch.randint(-lim, lim, (N, d), generator=g, device=dev).to(torch.int8)
    packed = kind == "int4"
    if packed:
        x = PK.pack_int4(x)
    fk = F.KIND_F32 if kind == "fp32" else F.KIND_I8
    tile = F.f32_tile(32)[0] if kind == "fp32" else F.I8_BM
    for k, mk in ((100, None), (100, mask), (1500, None)):
        if packed:
            want = F.fused_topk4_plain(*K.split_nibble_queries(q), x, k=k,
                                       metric=metric, mask=mk)
        else:
            want = F.fused_topk_plain(q, x, k=k, metric=metric, mask=mk)
        for bq in F.block_rows(fk):
            for bn in _layout_bns(N, tile):
                got = K.fused_topk(q, x, k, metric, packed=packed, mask=mk,
                                   bq=bq, bn=bn)
                if kind == "fp32":
                    hold_fp32(q, x, metric, mk, got, want)
                else:
                    assert torch.equal(got[0], want[0]), (bq, bn, k)
                    assert torch.equal(got[1], want[1]), (bq, bn, k)
    with pytest.raises(ValueError, match="layout"):
        K.fused_topk(q, x, 10, metric, packed=packed, bq=64)


@pytest.mark.parametrize("bits,m,Q", [(8, 32, 37), (8, 32, 3), (4, 64, 37),
                                      (4, 64, 2), (4, 1000, 9)])
def test_fused_adc_layout_overrides_equal_the_plain_version(dev, bits, m, Q):
    """Every block B4 / B5 holds for the batch (``A.block_rows``: the word
    kernel's, the MMA kernel's, the gather kernel's, B5's too-wide rows
    the gather kernel's 4) at every split length of ``_layout_bns`` gives
    the plain version's top-k, bit for bit."""
    g = torch.Generator(device=dev).manual_seed(12)
    N, kc, k = 70001, 2 ** bits, 100
    lut = torch.randint(-128, 128, (Q, m, kc), generator=g,
                        device=dev).to(torch.int8)
    codes = torch.randint(0, kc, (N, m), generator=g, device=dev).to(torch.uint8)
    if bits == 8:
        want = A.fused_adc_plain(lut.reshape(Q, -1), codes, k=k,
                                 n_codewords=kc)
        x = codes
    else:
        x = PK.pack_uint4(codes)
        want = A.fused_adc4_plain(lut[:, 0::2].reshape(Q, -1).contiguous(),
                                  lut[:, 1::2].reshape(Q, -1).contiguous(),
                                  x, k=k)
    tried = 0
    for bq in A.block_rows(bits, Q):
        for bn in _layout_bns(N, 1024):
            try:
                lay = A.adc_layout(k, x.shape[1], bits, Q, N, bq, bn)
            except ValueError:
                continue                 # e.g. B5's MMA block on wide rows
            got = K.fused_adc_topk(lut, x, k, packed=bits == 4, bq=bq, bn=bn)
            assert lay.bq == bq
            assert torch.equal(got[0], want[0]), (bq, bn)
            assert torch.equal(got[1], want[1]), (bq, bn)
            tried += 1
    assert tried >= 4


def test_tuned_searcher_on_the_card(dev):
    """A table stamped on this card: a tuned flat,lpq8 plan still launches
    B2, with the entry's layout, and returns the untuned plan's results;
    a scan entry for an ip / l2 kernel family is refused."""
    from repro_torch import kernels
    from repro_torch.knn import make_index
    from repro_torch.tune import table as T

    g = torch.Generator(device=dev).manual_seed(13)
    corpus = torch.randn(50_000, 64, generator=g, device=dev)
    q = torch.randn(32, 64, generator=g, device=dev)
    idx = make_index("flat,lpq8", corpus, metric="ip")
    table = T.TuneTable(stamp=T.live_stamp())
    assert table.stamp["backend"] == "cuda"
    table.put("fused_topk", "ip", 8, 32, 50_000, 64,
              T.TuneConfig("fused", bq=8, bn=4096))
    T.clear()
    try:
        untuned = idx.searcher(10, batch_sizes=(32,))
        T.install(table)
        tuned = idx.searcher(10, batch_sizes=(32,))
        T.clear()
        before = kernels.launch_counts()["fused_topk_int8"]
        a, b = untuned(q), tuned(q)
        assert kernels.launch_counts()["fused_topk_int8"] == before + 2
        assert torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)
        assert b.stats["tuned"] and not a.stats["tuned"]
        assert b.stats["bytes_read"] == 50_000 * 64 * 4    # 32 / bq passes
        bad = T.TuneTable(stamp=T.live_stamp())
        bad.put("fused_topk", "ip", 8, 32, 50_000, 64,
                T.TuneConfig("scan", chunk=4096))
        with pytest.raises(ValueError, match="scan"):
            T.install(bad)
    finally:
        T.clear()


@pytest.mark.parametrize("f", ["flat,lpq8", "pq16+lpq"])
def test_tuned_plan_past_the_k_cap_equals_untuned(dev, f):
    """A table entry's ``bn`` (measured at a small k: keys carry no k)
    served at a depth past n / (2 * 33): the tuned plan runs no more
    splits than the untuned layout's cap of 2k rows a split, and returns
    the untuned plan's results."""
    from repro_torch.knn import make_index
    from repro_torch.tune import table as T

    N, d, Q, k = 200_000, 64, 64, 4000           # N / 66 is about 3030
    g = torch.Generator(device=dev).manual_seed(14)
    corpus = torch.randn(N, d, generator=g, device=dev)
    q = torch.randn(Q, d, generator=g, device=dev)
    idx = make_index(f, corpus, metric="ip")
    bn = -(-N // 33)
    table = T.TuneTable(stamp=T.live_stamp())
    if f.startswith("pq"):
        m = idx.store.m
        table.put("fused_adc", "ip", 8, Q, N, m,
                  T.TuneConfig("fused", bq=8, bn=bn))
        lay = A.adc_layout(k, m, 8, Q, N, bq=8, bn=bn)
    else:
        table.put("fused_topk", "ip", 8, Q, N, d,
                  T.TuneConfig("fused", bq=32, bn=bn))
        lay = F.layout(F.KIND_I8, Q, N, k, d, bq=32, bn=bn)
    assert lay.splits == -(-N // (2 * k)) < 33
    T.clear()
    try:
        untuned = idx.searcher(k, batch_sizes=(Q,))
        T.install(table)
        tuned = idx.searcher(k, batch_sizes=(Q,))
        T.clear()
        a, b = untuned(q), tuned(q)
        assert b.stats["tuned"] and not a.stats["tuned"]
        assert torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)
    finally:
        T.clear()


#: sharded arms on the card and the kernel each shard launches
SHARDED_GPU_ARMS = {"flat": "fused_topk_fp32",
                    "flat,lpq8@gaussian:3": "fused_topk_int8",
                    "flat,lpq4": "fused_topk4",
                    "pq16+lpq": "fused_adc",
                    "pq16x4,lpq8": "fused_adc4",
                    "ivf8,lpq8": "fused_topk_fp32"}


@pytest.mark.parametrize("f", sorted(SHARDED_GPU_ARMS))
def test_sharded_plans_on_one_card_equal_unsharded(dev, f):
    """A ["cuda:0"] * s mesh: each shard launches its arm's kernel (B2-B5;
    the ivf arm's probe is B2 fp32), and the merged result equals the
    unsharded plan's bit for bit, filtered too (B2 fp32 sums each dot in
    one order whatever a shard's rows, so the fp32 arm is bit-equal as
    well)."""
    from repro_torch import kernels
    from repro_torch.dist import make_mesh
    from repro_torch.filter import Filter
    from repro_torch.knn import SearchParams, make_index

    N, d, Q, k = 30_001, 64, 37, 100
    g = torch.Generator(device=dev).manual_seed(15)
    corpus = torch.randn(N, d, generator=g, device=dev)
    q = torch.randn(Q, d, generator=g, device=dev)
    allow = (torch.rand(N, generator=g, device=dev) < 0.25).cpu().numpy()
    idx = make_index(f, corpus, metric="ip", kmeans_iters=4)
    name = SHARDED_GPU_ARMS[f]
    for sp in (SearchParams(nprobe=4),
               SearchParams(nprobe=4, filter=Filter.from_mask(allow))):
        un = idx.searcher(k, sp)(q)
        for s in (1, 2, 4):
            mesh = make_mesh((s,), ("data",), [dev] * s)
            plan = idx.searcher(k, sp, shards=mesh)
            before = kernels.launch_counts()[name]
            sh = plan(q)
            torch.cuda.synchronize()
            assert kernels.launch_counts()[name] >= before + (
                1 if f.startswith("ivf") else s)
            assert torch.equal(un.ids, sh.ids), (f, s)
            assert torch.equal(un.scores, sh.scores), (f, s)
            assert sh.stats["shards"] == s


def test_sharded_retrieval_on_the_card_equals_make_retrieval(dev):
    from repro_torch import kernels
    from repro_torch.core import quant as Qz
    from repro_torch.dist import make_mesh
    from repro_torch.launch.steps import make_retrieval, make_retrieval_sharded

    n, d, k = 40_000, 128, 100
    g = torch.Generator(device=dev).manual_seed(16)
    table = torch.randn(n, d, generator=g, device=dev)
    q = torch.randn(64, d, generator=g, device=dev)
    p = Qz.learn_params(table, bits=8, scheme="absmax")
    codes = Qz.quantize(table, p)
    want = make_retrieval(True, k=k)(q, codes, p.lo, p.hi, p.zero)
    before = kernels.launch_counts()
    got = make_retrieval_sharded(make_mesh((4,), ("data",), [dev] * 4),
                                 n // 4, k=k)(q, codes, p.lo, p.hi, p.zero)
    after = kernels.launch_counts()
    assert after["quantize"] - before["quantize"] == 4
    assert after["qmip"] - before["qmip"] == 4
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("f", ["hnsw8,lpq8,regions", "graph16,lpq4,regions",
                               "hnsw8", "graph16"])
def test_sharded_walks_on_one_card(dev, f):
    """Replicated walks over a ["cuda:0"] * 4 mesh: each shard walks a
    quarter of the batch, the cut / regional re-score runs on the whole
    batch.  Integer walks are bit-equal to the unsharded plan; an fp32
    walk scores each step with a batched product whose rounding may follow
    the batch's size (ROADMAP queue C), so it is held within rtol 1e-6
    of the row scale, ids equal outside near-ties."""
    from repro_torch.dist import make_mesh
    from repro_torch.knn import SearchParams, make_index
    from repro_torch.testing import fp32_near_equal

    g = torch.Generator(device=dev).manual_seed(17)
    corpus = torch.randn(4000, 64, generator=g, device=dev) * 0.05
    q = torch.randn(64, 64, generator=g, device=dev) * 0.05
    over = ({"ef_construction": 40, "batch_size": 128} if f.startswith("hnsw")
            else {"n_seeds": 16})
    idx = make_index(f, corpus, metric="ip", **over)
    sp = SearchParams(ef_search=40)
    un = idx.searcher(10, sp)(q)
    sh = idx.searcher(10, sp, shards=make_mesh((4,), ("data",),
                                               [dev] * 4))(q)
    if "lpq" in f:
        assert torch.equal(un.ids, sh.ids) and torch.equal(un.scores, sh.scores)
    else:
        assert fp32_near_equal(sh.scores.cpu().numpy(), sh.ids.cpu().numpy(),
                               un.scores.cpu().numpy(), un.ids.cpu().numpy(),
                               1e-6)[0]
