"""``chip_smoke.py``'s phase 9 alone, on one card: filtered search through
every ported kind and the stream kind.

    python scripts/stream_smoke.py [a] [b] [c]

Builds the kernels, then runs 9(a) ``filter_exact`` (every kind against
its own exhaustive ranking cut to the allowed rows; card against CPU),
9(b) ``filter_path`` (filtered search at full width) and 9(c)
``stream_path`` (the stream kind at full width), or only the parts named,
printing each part's seconds and the kernel launches of 9(b) and 9(c).
Exits non-zero if a check fails.
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
        if "a" in parts:
            t0 = time.time()
            C.filter_exact()
            C.log(f"--- 9(a): {time.time() - t0:.1f} s")
        if parts & {"b", "c"}:
            pc, pq, _ = synthetic.load("product", 4_000_000, 1000)
            for part, fn in (("b", C.filter_path), ("c", C.stream_path)):
                if part in parts:
                    t0 = time.time()
                    for name, c in fn(err, pc, pq).items():
                        counts[name] = counts.get(name, 0) + c
                    C.log(f"--- 9({part}): {time.time() - t0:.1f} s")
    except C.SmokeFailure as e:
        print(f"stream_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    C.log(f"total {time.time() - t:.1f} s; launches {counts}; max_abs_err "
          f"{err}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
