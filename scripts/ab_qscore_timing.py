"""Time the score-matrix kernels on one GPU from the ``repro_torch``
package under a given ``src`` directory: B6 (``ops.qmip``) at Q=1 and
Q=512, B8a (``ops.qmip4``), B7 (``ops.ql2``) and B8b (``ops.ql24``) at
Q=512; then the int8 retrieval request that B6 serves
(``make_retrieval(True)``: B1 + B6 + top-k) at Q=1 and Q=512.

    python scripts/ab_qscore_timing.py <src dir>

Table 1,000,000 x 128 random int8 codes (B8: int4 codes, packed), seed 0;
each kernel time is the median of 20 warm calls by CUDA events, with the
smallest and largest beside it.  Retrieval: a 1,000,000 x 128 N(0, 1/d)
table through ``QuantizedTable.from_dense``, k=100; p50 by the host clock
of 200 single-query and 20 512-query requests, each ending in a
synchronize.  To compare two checkouts, unpack both and run them in turns
on one card: parent, change, change, parent.
"""

import statistics
import subprocess
import sys
import time

sys.path.insert(0, sys.argv[1])

import torch  # noqa: E402

from repro_torch.core import pack as PK  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.launch import make_retrieval  # noqa: E402
from repro_torch.models.recsys.embedding import QuantizedTable  # noqa: E402


def times_ms(fn, n=20):
    for _ in range(3):
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
    return statistics.median(out), min(out), max(out)


def main():
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    N, d = 1_000_000, 128
    def codes(lim, rows):
        return torch.randint(-lim, lim, (rows, d), generator=g,
                             device="cuda").to(torch.int8)

    x = codes(128, N)
    x4 = PK.pack_int4(codes(8, N))
    q = codes(128, 512)
    q4 = codes(8, 512)
    runs = {"B6 Q=1": lambda: K.qmip(q[:1], x),
            "B6 Q=512": lambda: K.qmip(q, x),
            "B8a Q=512": lambda: K.qmip4(q4, x4),
            "B7 Q=512": lambda: K.ql2(q, x),
            "B8b Q=512": lambda: K.ql24(q4, x4)}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    res = []
    for name, fn in runs.items():
        m, lo, hi = times_ms(fn)
        res.append(f"{name}: {m:.4f} ms [{lo:.4f}, {hi:.4f}]")
    table = torch.randn(N, d, generator=g, device="cuda") * d ** -0.5
    queries = torch.randn(512 * 20, d, generator=g, device="cuda") * d ** -0.5
    qt = QuantizedTable.from_dense(table)
    p = qt.params
    step = make_retrieval(True, k=100)
    for batch, n in ((1, 200), (512, 20)):
        for i in range(3):
            step(queries[:batch], qt.codes, p.lo, p.hi, p.zero)
        torch.cuda.synchronize()
        lat = []
        for i in range(n):
            t = time.perf_counter()
            step(queries[i * batch:(i + 1) * batch], qt.codes, p.lo, p.hi,
                 p.zero)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t) * 1e3)
        res.append(f"retrieval Q={batch} p50 {statistics.median(lat):.4f} ms")
    print(sys.argv[1], "|", "; ".join(res), "|", card, flush=True)


if __name__ == "__main__":
    main()
