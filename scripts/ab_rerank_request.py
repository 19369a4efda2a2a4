"""Serve ``flat,lpq4+r32`` on the product-like 4,000,000 x 256 corpus on
one GPU, from the ``repro_torch`` package under a given ``src``
directory, and print the p50 of twelve 256-query requests beside the
request's two parts: the B3 scan at depth 400 and the rerank tail.

    python scripts/ab_rerank_request.py <src dir>

Parts are medians of 5 calls by CUDA events.  To compare two checkouts,
run them in turns on one card: parent, change, change, parent.
"""

import statistics
import sys
import time

sys.path.insert(0, sys.argv[1])

import torch  # noqa: E402

import repro_torch  # noqa: E402,F401  (TF32 off)
from repro_torch import engine  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.knn import make_index  # noqa: E402


def median_ms(fn, n=5):
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
    corpus, queries, metric = synthetic.load("product", 4_000_000, 1000)
    idx = make_index("flat,lpq4+r32", corpus, metric=metric)
    s = idx.searcher(100, batch_sizes=(1, 8, 32, 256))
    for b in (1, 8, 32, 256):
        s(queries[:b])
    torch.cuda.synchronize()
    lat = []
    for _ in range(3):
        for st in range(0, 1000, 256):
            t = time.perf_counter()
            s(queries[st:st + 256])
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t) * 1e3)
    q = queries[:256]
    qc = idx.store.encode_queries(q)
    scan = median_ms(lambda: engine.topk(qc, idx.store, 400, metric,
                                         prepared=True))
    ids = engine.topk(qc, idx.store, 400, metric, prepared=True)[1]
    rr = median_ms(lambda: engine.rerank_among(q, idx.rerank_store, ids, 100,
                                               metric))
    print(f"{sys.argv[1]}: p50 {statistics.median(lat):.2f} ms over "
          f"{len(lat)} 256-query requests; scan k=400 {scan:.3f} ms, "
          f"rerank {rr:.3f} ms", flush=True)


if __name__ == "__main__":
    main()
