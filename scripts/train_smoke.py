"""``chip_smoke.py``'s phase 15 alone, on one card: training through the
port's AdamW, autograd backward (the blockwise-attention backward among
it), checkpoints and SchNet.

    python scripts/train_smoke.py [a] [b] [c] [d] [e]

Runs ``chip_smoke.phase15`` with the parts named (all five unless some
are): (a) each train step (the five reduced LM configs, the four recsys
configs, SchNet's two regimes and its edge loop in ragged blocks) and the
flash backward, card against CPU in float32, then gemma2-9b's reduced
train step and llama4's MoE backward in bf16, (b) gemma2-9b at full
width, 4 layers, bf16, B=1 x S=4,608, a warm-up step and 3 timed steps,
(c) SchNet at published widths on its full_graph_sm and molecule cells,
5 steps each through ``train.train``, (d) SchNet's minibatch_lg cell at
its real size (the 114.6 M-edge graph, the host sampler, 4 steps on fresh
samples), (e) SchNet's ogb_products cell at its real size (61.9 M edges
in 35 edge blocks, 3 steps, the loss at two block sizes), printing each
part's seconds.  No kernel of the port lies on this path,
so nothing is built.  Exits non-zero if a check fails.
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
        C.phase15("".join(sys.argv[1:]) or "abcde")
    except C.SmokeFailure as e:
        print(f"train_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
