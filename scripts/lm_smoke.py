"""``chip_smoke.py``'s phase 14 alone, on one card: LM serving through the
port's transformer, blockwise attention, MoE and int8 KV cache.

    python scripts/lm_smoke.py [a] [b] [c] [d]

Runs ``chip_smoke.phase14`` with the parts named (all four unless some
are): (a) the five reduced configs card against CPU in float32, and in
bf16 the dense ones and llama4's MoE layers, (b) gemma2-9b at full width
(2 layers, float32) card against CPU, (c) gemma2-9b at full width and
depth in bf16 and (d) llama4-scout at full width, 4 layers, printing each
part's seconds.  No kernel of the port lies on this path, so nothing is
built.  Exits non-zero if a check fails.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    import repro_torch  # noqa: F401  (TF32 off)
    import chip_smoke as C

    C.log(f"[device] {torch.cuda.get_device_name(0)} | {C.smi()} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    try:
        C.phase14("".join(sys.argv[1:]) or "abcd")
    except C.SmokeFailure as e:
        print(f"lm_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
