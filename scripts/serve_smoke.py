"""``chip_smoke.py``'s phase 13 alone, on one card: the serving CLI
(``python -m repro_torch.launch.serve``'s ``main``) at the product width and
CTR serving of the four recsys architectures at published widths.

    python scripts/serve_smoke.py [a] [b]

Builds the kernels, then runs 13(a) ``serve_cli`` and 13(b)
``recsys_serving`` (both unless parts are named), printing each part's
seconds and the launch counts of phase 13's runs.  Exits non-zero if a
check fails.
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
    from repro_torch.kernels import _build

    parts = set(sys.argv[1:]) or {"a", "b"}
    info = _build.build_all()
    C.log(f"[build] {info['seconds']:.1f} s | {C.smi()}")
    run = dict.fromkeys(kernels.launch_counts(), 0)
    try:
        for part, fn in (("a", C.serve_cli), ("b", C.recsys_serving)):
            if part in parts:
                t0 = time.perf_counter()
                fn(run)
                C.log(f"[phase13] 13({part}) {time.perf_counter() - t0:.1f} s")
    except C.SmokeFailure as e:
        print(f"serve_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    C.log(f"[phase13] kernel launches on phase 13's runs: {run}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
