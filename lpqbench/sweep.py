"""Find the highest rate an open-loop cell sustains: one set-up, then one
window a rate, each printing a JSON line.

    python3 lpqbench/sweep.py --workload <cell> --seed <n> \
        --rates 100,150,200 [--seconds 10]

A backlog that grows shows as the latency of the window's last fifth of
requests far above its first fifth's.  The cell's rate (its file's
``rate``) is set once, from such a sweep, at about four fifths of the
highest rate without a growing backlog; the benchmark's runs never sweep.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lpqbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    from lpqbench.system import Program

    cell = harness.load_cell(harness.load_benchmark(), args.workload)
    if cell.mix["loop"] != "open":
        print("a closed loop has no rate to sweep", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    st = harness.setup(cell, args.seed, dev, Program,
                       lambda m: print(m, file=sys.stderr, flush=True))
    for j, rate in enumerate(float(r) for r in args.rates.split(",")):
        cell.spec["rate"] = rate
        w = harness.run_window(cell, st, args.seconds, args.seed + j, dev)
        lat = [r["latency_s"] * 1e3 for r in w["requests"]]
        fifth = max(1, len(lat) // 5)
        print(json.dumps({
            "rate": rate, "requests": len(lat),
            "offered_s": args.seconds, "window_s": w["window_s"],
            "p50_ms": statistics.median(lat),
            "p95_ms": float(np.percentile(lat, 95)),
            "first_fifth_mean_ms": statistics.fmean(lat[:fifth]),
            "last_fifth_mean_ms": statistics.fmean(lat[-fifth:]),
            "host_call_ms": statistics.median(r["host_call_s"] * 1e3
                                              for r in w["requests"]),
        }), flush=True)
        w["answers"].clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
