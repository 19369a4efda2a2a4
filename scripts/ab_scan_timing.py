"""Time the packed-int4 scan (B3) at k=100 and k=400 and the int8 scan
(B2) at k=400 on one GPU, from the ``repro_torch`` package under a given
``src`` directory.

    python scripts/ab_scan_timing.py <src dir>

Corpus 4,000,000 x 256 random int4/int8 codes, 256 queries, ip (B3 also
l2 at k=400); each time is the median of 10 warm calls by CUDA events.
To compare two checkouts, unpack both and run them in turns on one
card: parent, change, change, parent.
"""

import statistics
import sys

sys.path.insert(0, sys.argv[1])

import torch  # noqa: E402

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
    x = torch.randint(-8, 8, (N, d), generator=g, device="cuda").to(torch.int8)
    q = torch.randint(-8, 8, (Q, d), generator=g, device="cuda").to(torch.int8)
    c4 = PK.pack_int4(x)
    qe, qo = K.split_nibble_queries(q)
    r = {f"B3 k={k}": median_ms(lambda: F.fused_topk4_cuda(qe, qo, c4, k=k,
                                                           metric="ip"))
         for k in (100, 400)}
    r["B2 int8 k=400"] = median_ms(lambda: F.fused_topk_cuda(q, x, k=400,
                                                             metric="ip"))
    r["B3 l2 k=400"] = median_ms(lambda: F.fused_topk4_cuda(qe, qo, c4, k=400,
                                                            metric="l2"))
    print(sys.argv[1], " ".join(f"{k}: {v:.3f} ms" for k, v in r.items()),
          flush=True)


if __name__ == "__main__":
    main()
