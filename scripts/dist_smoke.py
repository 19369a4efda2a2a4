"""``chip_smoke.py``'s phase 12 alone, on one card: sharded plans on
``["cuda:0"] * s`` meshes and a replica set.

    python scripts/dist_smoke.py [a] [b] [c] [w]

Builds the kernels, loads phase 9's product-like 4,000,000 x 256 rows and
builds the product arms phase 11 would have built (``TUNED_ARMS``), then
runs 12(a) ``sharded_exact``, 12(b) ``sharded_wide`` and 12(c)
``replica_path`` (all three unless parts are named), printing each part's
seconds and the launch counts of the sharded and replica runs.  ``w``
(named only) probes the fp32 walks (``hnsw8``, ``graph16``) at 4,000 x 64
on 2 and 4 shards: whether they are bit-equal to the unsharded plan, and
their largest relative score error.
Exits non-zero if a check fails.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def fp32_walks() -> None:
    import numpy as np
    import torch

    import chip_smoke as C
    from repro_torch.knn import SearchParams, make_index

    rng = np.random.default_rng(12)
    corpus = (rng.standard_normal((4000, 64)) * 0.05).astype(np.float32)
    q = torch.from_numpy((rng.standard_normal((64, 64)) * 0.05)
                         .astype(np.float32)).cuda()
    for f, over in (("hnsw8", {"ef_construction": 40, "batch_size": 128}),
                    ("graph16", {"n_seeds": 16})):
        idx = make_index(f, corpus, metric="ip", **over)
        sp = SearchParams(ef_search=40)
        un = idx.searcher(10, sp)(q)
        for s in (2, 4):
            sh = idx.searcher(10, sp, shards=C._mesh(s))(q)
            scale = un.scores.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
            err = float(((sh.scores - un.scores).abs() / scale).max())
            C.log(f"[walks] {f} fp32 @ {s} shards: bit-equal "
                  f"{C._same(un, sh)}, ids equal {torch.equal(un.ids, sh.ids)},"
                  f" largest |score diff| / row scale {err:.3e} | {C.smi()}")


def main() -> int:
    import repro_torch  # noqa: F401  (TF32 off)
    import chip_smoke as C
    from repro_torch import kernels
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build
    from repro_torch.knn import make_index

    parts = set(sys.argv[1:]) or {"a", "b", "c"}
    t = time.time()
    info = _build.build_all()
    C.log(f"[build] {info['seconds']:.1f} s | {C.smi()}")
    built, pc, pq = {}, None, None
    if parts & {"b", "c"}:
        pc, pq, _ = synthetic.load("product", 4_000_000, 1000)
        for f in C.TUNED_ARMS:
            built[f] = make_index(f, pc, metric="ip")
    run = dict.fromkeys(kernels.launch_counts(), 0)
    try:
        for part, fn in (("a", lambda: C.sharded_exact(run)),
                         ("b", lambda: C.sharded_wide(built, pc, pq, run)),
                         ("c", lambda: C.replica_path(built, pq, run)),
                         ("w", fp32_walks)):
            if part in parts:
                t0 = time.time()
                fn()
                C.log(f"--- 12({part}): {time.time() - t0:.1f} s")
    except C.SmokeFailure as e:
        print(f"dist_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    C.log(f"total {time.time() - t:.1f} s; launches on the sharded and "
          f"replica runs {run}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
