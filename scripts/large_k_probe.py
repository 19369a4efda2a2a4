"""B2 int8's time at the over-fetch depths a churned or filtered stream
index asks of its segments, on one card.

    python scripts/large_k_probe.py

A stream index's plan fetches ``depth + masked rows`` from each sealed
segment (``repro_torch/stream/mutable.py``, as the reference's
``mutable.py`` does): tombstones and filtered-out rows both raise a
segment's k.  This times ``kernels.ops.fused_topk`` (B2 int8) over
4,000,000 x 256 random int8 codes, ip, at growing k and 256 or 1 queries,
and ``engine.topk_among`` over the candidates a query then re-scores; it
stops before a call whose predicted time passes 30 s.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    import torch

    import repro_torch  # noqa: F401  (TF32 off)
    from repro_torch import engine
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as K

    _build.build_all()
    n, d = 4_000_000, 256
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(-128, 128, (n, d), generator=g, device="cuda").to(torch.int8)
    q = torch.randint(-128, 128, (256, d), generator=g, device="cuda").to(torch.int8)
    last = 0.0
    for nq, k in ((256, 100), (256, 2148), (256, 8292), (256, 32868),
                  (1, 32868), (1, 300_000), (1, 1_000_000), (1, 3_000_100)):
        if last > 30.0 / 4:
            print(f"stop: the last call took {last:.2f} s", flush=True)
            break
        for rep in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            s, i = K.fused_topk(q[:nq], x, k, "ip")
            torch.cuda.synchronize()
            last = time.perf_counter() - t
        print(f"B2 int8 N={n} d={d} Q={nq} k={k}: {last * 1e3:.1f} ms",
              flush=True)
    store = engine.CodeStore.dense(torch.randn(n, d, generator=g,
                                               device="cuda"))
    qf = torch.randn(256, d, generator=g, device="cuda")
    for nq, width in ((256, 2148), (256, 32868), (1, 300_000),
                      (1, 3_000_100)):
        cand = torch.randint(0, n, (nq, width), generator=g, device="cuda",
                             dtype=torch.int32)
        for rep in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            engine.topk_among(qf[:nq], store, cand, 100, "ip")
            torch.cuda.synchronize()
            last = time.perf_counter() - t
        print(f"topk_among fp32 Q={nq} candidates={width}: "
              f"{last * 1e3:.1f} ms", flush=True)
    out = torch.cuda.get_device_name(0)
    print(out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
