"""``chip_smoke.py``'s phase 10 alone, on one card: the scoring cascade and
per-region Eq. 1 constants.

    python scripts/cascade_smoke.py [a] [b] [c]

Builds the kernels, then runs 10(a) ``cascade_exact`` (the conformance
arms built on the card and on the CPU from one set of draws), 10(b)
``cascade_recall`` (recall at 20,000 rows against the reference's) and
10(c) ``cascade_path`` (the cascades at product-like 4,000,000 x 256 and
the regions arms at SIFT-like 1,000,000 x 128), or only the parts named,
printing each part's seconds and the kernel launches of 10(c).  Exits
non-zero if a check fails.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import repro_torch  # noqa: F401  (TF32 off)
    import chip_smoke as C
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build

    parts = set(sys.argv[1:]) or {"a", "b", "c"}
    t = time.time()
    info = _build.build_all()
    C.log(f"[build] {info['seconds']:.1f} s | {C.smi()}")
    err = dict.fromkeys((*C.MAIN_KERNELS, *C.QSCORE), 0.0)
    counts = {}
    try:
        for part, fn in (("a", C.cascade_exact), ("b", C.cascade_recall)):
            if part in parts:
                t0 = time.time()
                fn()
                C.log(f"--- 10({part}): {time.time() - t0:.1f} s")
        if "c" in parts:
            pc, pq, _ = synthetic.load("product", 4_000_000, 1000)
            t0 = time.time()
            counts = C.cascade_path(err, pc, pq)
            C.log(f"--- 10(c): {time.time() - t0:.1f} s")
    except C.SmokeFailure as e:
        print(f"cascade_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    C.log(f"total {time.time() - t:.1f} s; launches {counts}; max_abs_err "
          f"{err}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
