"""``chip_smoke.py``'s phase 11 alone, on one card: the autotuner, tuned
serving and the runtime subsystem.

    python scripts/runtime_smoke.py [a] [bc]

Builds the kernels, loads phase 9's product-like 4,000,000 x 256 rows,
then runs 11(a) ``tune_path`` (the autotuner's full workloads, every
candidate held to its plain version) and, unless only ``a`` is named,
11(b)-(c) ``tuned_serving`` + ``runtime_path`` as one run of the path
(counters set to 0 before, read after), printing each part's seconds.
With ``bc`` alone, 11(b)-(c) read the table an earlier run of 11(a) wrote
to ``build/phase11_TUNE.json``.  Exits non-zero if a check fails.
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
    from repro_torch import kernels
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build
    from repro_torch.tune.table import TuneTable

    parts = set(sys.argv[1:]) or {"a", "bc"}
    t = time.time()
    info = _build.build_all()
    C.log(f"[build] {info['seconds']:.1f} s | {C.smi()}")
    pc, pq, _ = synthetic.load("product", 4_000_000, 1000)
    run = {}
    try:
        t0 = time.time()
        if "a" in parts:
            table = C.tune_path()
        else:
            table = TuneTable.from_json(ROOT / "build" / "phase11_TUNE.json")
        C.log(f"--- 11(a): {time.time() - t0:.1f} s")
        if "bc" in parts:
            t0 = time.time()
            kernels.reset_launch_counts()
            built = C.tuned_serving(table, pc, pq)
            C.log(f"--- 11(b): {time.time() - t0:.1f} s")
            t0 = time.time()
            C.runtime_path(built, pc, pq)
            run = kernels.launch_counts()
            C.log(f"--- 11(c): {time.time() - t0:.1f} s")
            for name in C.PHASE11_KERNELS:
                C.need(run[name] > 0, f"kernel {name} was never launched")
    except C.SmokeFailure as e:
        print(f"runtime_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    C.log(f"total {time.time() - t:.1f} s; launches {run}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
