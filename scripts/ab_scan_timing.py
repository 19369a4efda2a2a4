"""Time the fused scans B2-B5 on one GPU from the ``repro_torch`` package
under a given ``src`` directory.

    python scripts/ab_scan_timing.py <src dir>

Corpus 4,000,000 x 256 (N(0, 1) fp32 for B2 fp32; random int8 / int4
codes for B2 int8 and B3), 256 queries, ip: B2 fp32 at k=100, k=400 and
one query; B2 int8 at k=100 and k=400, at 1 and 32 queries (k=100), and
l2 at k=100, also at the SIFT-like shape (1,000,000 x 128); B3 at k=100
and k=400, at one query (k=100), and l2 at k=400.  B4 on pq32 codes (32
bytes a row) and B5 on pq64x4 codes (32 packed bytes a row), 4,000,000
rows, random int8 LUTs, 256 queries, each at k=100, k=400, and one and 32
queries (k=100); B4 also at the SIFT-like pq16 shape (1,000,000 rows of
16 codes, 256 queries, k=100) with LUTs in [-128, 0] as the negated-L2
tables are.  Each time is the median of 10 warm calls by CUDA events around
the public wrapper.  To compare two checkouts, unpack both and run them
in turns on one card: parent, change, change, parent.
"""

import statistics
import subprocess
import sys

sys.path.insert(0, sys.argv[1])

import torch  # noqa: E402

import repro_torch  # noqa: E402,F401  (TF32 off)
from repro_torch.core import pack as PK  # noqa: E402
from repro_torch.kernels import fused_topk as F  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402


def median_ms(fn, n=10):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def main():
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    N, d, Q = 4_000_000, 256, 256
    r = {}
    xf = torch.randn(N, d, generator=g, device="cuda")
    qf = torch.randn(Q, d, generator=g, device="cuda")
    for k in (100, 400):
        r[f"B2 fp32 k={k}"] = median_ms(
            lambda: F.fused_topk_cuda(qf, xf, k=k, metric="ip"))
    q1 = qf[:1].contiguous()
    r["B2 fp32 Q=1 k=100"] = median_ms(
        lambda: F.fused_topk_cuda(q1, xf, k=100, metric="ip"))
    del xf
    x = torch.randint(-8, 8, (N, d), generator=g, device="cuda").to(torch.int8)
    q = torch.randint(-8, 8, (Q, d), generator=g, device="cuda").to(torch.int8)
    c4 = PK.pack_int4(x)
    qe, qo = K.split_nibble_queries(q)
    for k in (100, 400):
        r[f"B2 int8 k={k}"] = median_ms(
            lambda: F.fused_topk_cuda(q, x, k=k, metric="ip"))
    for qn in (1, 32):
        qq = q[:qn].contiguous()
        r[f"B2 int8 Q={qn} k=100"] = median_ms(
            lambda: F.fused_topk_cuda(qq, x, k=100, metric="ip"))
    r["B2 int8 l2 k=100"] = median_ms(
        lambda: F.fused_topk_cuda(q, x, k=100, metric="l2"))
    xs = x[:1_000_000, :128].contiguous()
    qs = q[:, :128].contiguous()
    r["B2 int8 l2 1M x 128 k=100"] = median_ms(
        lambda: F.fused_topk_cuda(qs, xs, k=100, metric="l2"))
    del xs
    for k in (100, 400):
        r[f"B3 k={k}"] = median_ms(
            lambda: F.fused_topk4_cuda(qe, qo, c4, k=k, metric="ip"))
    qe1, qo1 = qe[:1].contiguous(), qo[:1].contiguous()
    r["B3 Q=1 k=100"] = median_ms(
        lambda: F.fused_topk4_cuda(qe1, qo1, c4, k=100, metric="ip"))
    r["B3 l2 k=400"] = median_ms(
        lambda: F.fused_topk4_cuda(qe, qo, c4, k=400, metric="l2"))
    del x, c4
    for name, m, bits in (("B4 pq32", 32, 8), ("B5 pq64x4", 64, 4)):
        kc = 2 ** bits
        lut = torch.randint(-128, 128, (Q, m, kc), generator=g,
                            device="cuda").to(torch.int8)
        codes = torch.randint(0, kc, (N, m), generator=g,
                              device="cuda").to(torch.uint8)
        payload = PK.pack_uint4(codes) if bits == 4 else codes
        for k in (100, 400):
            r[f"{name} k={k}"] = median_ms(
                lambda: K.fused_adc_topk(lut, payload, k, packed=bits == 4))
        for qn in (1, 32):
            lq = lut[:qn].contiguous()
            r[f"{name} Q={qn} k=100"] = median_ms(
                lambda: K.fused_adc_topk(lq, payload, 100, packed=bits == 4))
        if bits == 8:
            lut16 = torch.randint(-128, 1, (Q, 16, kc), generator=g,
                                  device="cuda").to(torch.int8)
            c16 = codes[:1_000_000, :16].contiguous()
            r["B4 pq16 l2-like 1M k=100"] = median_ms(
                lambda: K.fused_adc_topk(lut16, c16, 100))
            del lut16, c16
        del lut, codes, payload
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(sys.argv[1], " ".join(f"{k}: {v:.3f} ms;" for k, v in r.items()),
          "|", card, flush=True)


if __name__ == "__main__":
    main()
