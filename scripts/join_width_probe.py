"""Time B2 (int8 and fp32, l2, k=13) at the graph self-join's shape for row
widths around 256 bytes, on one card.

    python scripts/join_width_probe.py [--q 32768] [--n 1000000]

The graph kind's ip arms augment the corpus by one column (d = 257 for the
product-like 256-wide corpus), and the self-join scans the whole corpus
once per block of queries.  This script launches ``kernels.ops.fused_topk``
on Q queries against N random rows at d = 256, 257 (rows neither 4- nor
16-byte aligned), 260 (4-byte aligned) and 272 (16-byte aligned), the same
codes zero-padded or cut to each width, and prints each call's median of
CUDA-event times with the card's name and power limit.  The int8 results
at 257, 260 and 272 are held equal (zero columns change no score).
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> None:
    import torch

    import repro_torch  # noqa: F401  (TF32 off)
    from repro_torch.kernels import ops as K

    ap = argparse.ArgumentParser()
    ap.add_argument("--q", type=int, default=32768)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x8 = torch.randint(-128, 128, (args.n, 257), generator=g, device=dev,
                       dtype=torch.int8)
    xf = torch.randn(args.n, 257, generator=g, device=dev)

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(args.reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts), out

    def width(t, d):
        if d <= t.shape[1]:
            return t[:, :d].contiguous()
        return torch.nn.functional.pad(t, (0, d - t.shape[1])).contiguous()

    ref = None
    for kind, base in (("int8", x8), ("fp32", xf)):
        for d in (256, 257, 260, 272):
            x = width(base, d)
            q = x[: args.q].contiguous()
            ms, out = timed(lambda: K.fused_topk(q, x, 13, "l2"))
            same = ""
            if kind == "int8" and d >= 257:
                if ref is None:
                    ref = out
                same = (f", equal to d=257's: "
                        f"{torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])}")
            macs = args.q * args.n * d
            print(f"{kind} l2 k=13 Q={args.q} N={args.n} d={d}: {ms:.2f} ms "
                  f"({macs / ms / 1e9:.3g} T MAC/s){same} | {card}", flush=True)


if __name__ == "__main__":
    main()
