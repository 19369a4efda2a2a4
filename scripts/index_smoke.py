"""``chip_smoke.py``'s fused-kernel checks and phase 8 alone, on one card.

    python scripts/index_smoke.py

Builds the kernels, runs phase 3's ``check_kernels`` (B1 and B2 / B3
against their plain versions, B2 fp32 at d = 257 among them), then phase
8: ``index_exact`` (graph / ivf card against CPU), ``index_recall``
(Table 3 and the ivf arms against ``REF_GRAPH``) and ``index_path`` (the
timed SIFT-like and product-like arms), printing each part's seconds.
About 4 minutes, against about 13 for the whole script.  Exits non-zero
if a check fails.
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
    from repro_torch.kernels import _build

    t = time.time()
    info = _build.build_all()
    C.log(f"[build] {info['seconds']:.1f} s")
    err = dict.fromkeys((*C.MAIN_KERNELS, *C.QSCORE), 0.0)
    try:
        for name, fn in (("check_kernels", lambda: C.check_kernels(err)),
                         ("exact", C.index_exact),
                         ("recall", C.index_recall),
                         ("path", lambda: C.index_path(err))):
            t0 = time.time()
            out = fn()
            C.log(f"--- {name}: {time.time() - t0:.1f} s {out or ''}")
    except C.SmokeFailure as e:
        print(f"index_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    C.log(f"total {time.time() - t:.1f} s; max_abs_err {err}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
