"""Time the score-matrix kernels on one GPU from the ``repro_torch``
package under a given ``src`` directory: B6 (``ops.qmip``) and B7
(``ops.ql2``) at Q=1 and Q=512, B8a (``ops.qmip4``) and B8b
(``ops.ql24``) at Q=512; the host time of each public op at Q=512 and its
parts; then the int8 retrieval request that B6 serves
(``make_retrieval(True)``: B1 + B6 + top-k) at Q=1 and Q=512.

    python scripts/ab_qscore_timing.py <src dir>

Table 1,000,000 x 128 random int8 codes (B8: int4 codes, packed), seed 0;
each kernel time is the median of 20 warm calls by CUDA events, with the
smallest and largest beside it, through the public op ("op") and as the
library's C launcher called alone on a preallocated output ("raw").
Host parts, medians of 200 calls by the host clock, each after a
synchronize, in microseconds: the public op up to its return (the launch
is queued, not run), ``_qscore.launch`` on zero queries (the checks and
an empty output), ``torch.empty`` of the [Q, N] output, the current
stream's handle, the library lookup, the C launcher on zero queries (the
ctypes call alone), the even / odd query split (B8), and ``_int_mm``'s
enqueue beside them.  Retrieval: a 1,000,000 x 128 N(0, 1/d) table
through ``QuantizedTable.from_dense``, k=100; p50 by the host clock of
200 single-query and 20 512-query requests, each ending in a synchronize.
To compare two checkouts, unpack both and run them in turns on one card:
parent, change, change, parent.
"""

import statistics
import subprocess
import sys
import time

sys.path.insert(0, sys.argv[1])

import torch  # noqa: E402

from repro_torch.core import pack as PK  # noqa: E402
from repro_torch.kernels import _build, _qscore  # noqa: E402
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


def host_us(fn, n=200):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t)
        torch.cuda.synchronize()
    return statistics.median(out) * 1e6


def tile(Q, l2):
    """The query tile this tree's wrapper passes the C launcher."""
    if l2 and hasattr(_qscore, "query_tile"):        # the dp4a kernel
        return _qscore.query_tile(Q)
    return _qscore.mma_tiles(Q)[0]


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
    qe, qo = K.split_nibble_queries(q4)
    ops = {"B6": ("qmip", False, False), "B7": ("ql2", False, True),
           "B8a": ("qmip4", True, False), "B8b": ("ql24", True, True)}
    out = torch.empty((512, N), dtype=torch.int32, device="cuda")
    lib = _build.lib("qscore")
    st = torch.cuda.current_stream().cuda_stream

    def raw(Q, packed, l2, q0, q1, xs, rows=None):
        rows = Q if rows is None else rows
        return lambda: lib.rt_qscore(
            int(packed), int(l2), tile(Q, l2), q0.data_ptr(),
            None if q1 is None else q1.data_ptr(), xs.data_ptr(),
            out.data_ptr(), rows, N, xs.shape[1], st)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    res = []
    for tag, (name, packed, l2) in ops.items():
        xs, qf = (x4, q4) if packed else (x, q)
        q0, q1 = (qe, qo) if packed else (q, None)
        for Q in ((512,) if packed else (1, 512)):
            m, lo, hi = times_ms(lambda: getattr(K, name)(qf[:Q], xs))
            rm, rlo, rhi = times_ms(raw(Q, packed, l2, q0[:Q],
                                        None if q1 is None else q1[:Q], xs))
            res.append(f"{tag} Q={Q}: op {m:.4f} ms [{lo:.4f}, {hi:.4f}], "
                       f"raw {rm:.4f} ms [{rlo:.4f}, {rhi:.4f}]")
        parts = {
            "op": lambda: getattr(K, name)(qf, xs),
            "launch_q0": lambda: _qscore.launch(
                name, {name: 0}, packed=packed, l2=l2, q0=q0[:0],
                q1=None if q1 is None else q1[:0], x=xs),
            "empty": lambda: torch.empty((512, N), dtype=torch.int32,
                                         device="cuda"),
            "stream": lambda: torch.cuda.current_stream(xs.device).cuda_stream,
            "lib": lambda: _build.lib("qscore"),
            "ctypes_q0": raw(512, packed, l2, q0, q1, xs, rows=0)}
        if packed:
            parts["split"] = lambda: K.split_nibble_queries(q4)
        res.append(f"{tag} host us: " + ", ".join(
            f"{k} {host_us(fn):.1f}" for k, fn in parts.items()))
    mm, mm32 = lambda: torch._int_mm(q, x.T), lambda: torch._int_mm(q[:32], x.T)
    res.append(f"_int_mm: host us {host_us(mm):.1f}, Q=512 "
               f"{times_ms(mm)[0]:.4f} ms, Q=1 (as 32 rows) "
               f"{times_ms(mm32)[0]:.4f} ms")
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
