"""Run the control in the program's place at a cell's own size and print
what the judge reads of it: the upper readings of the cell's limits.

    python3 lpqbench/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds <window>]

The control (``reference/control.py``) is the plain reference one
precision below the configuration's.  It answers the requests a run of
``--seconds`` would sample (an open loop's schedule, or a closed loop's
first requests), all at once: its timing means nothing, only its answers
and its set-up state are judged.  Each seed prints one JSON line; the
control has to come out not ``correct``.  The benchmark's own runs never
run it.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from lpqbench import harness, loadgen  # noqa: E402
from lpqbench.reference.control import Control  # noqa: E402


def control_run(cell: harness.Cell, seed: int, seconds: float, dev,
                log) -> dict:
    st = harness.setup(cell, seed, dev, Control, log, warm=False)
    pool = st["pool"]
    if cell.mix["loop"] == "open":
        reqs = loadgen.open_schedule(cell.mix, float(cell.spec["rate"]),
                                     seconds, pool.shape[0], seed)
    else:
        stream = loadgen.closed_requests(cell.mix, pool.shape[0], seed)
        reqs = [next(stream) for _ in range(4 * cell.spec["check"]["requests"])]
    by_index = {r.index: r for r in reqs}
    picked = harness.sample(cell, sorted(by_index), seed)
    q = torch.cat([pool[by_index[i].offset:by_index[i].offset
                        + by_index[i].size] for i in picked])
    s, ids = st["system"](q)
    answers, at = {}, 0
    for i in picked:
        size = by_index[i].size
        answers[i] = (s[at:at + size], ids[at:at + size])
        at += size
    window = {"requests": [{"index": i, "size": by_index[i].size,
                            "offset": by_index[i].offset} for i in picked],
              "answers": answers, "failed": 0}
    nums = harness.judge(cell, st, window, seed, dev)
    ok, checks = harness.verdict(cell, nums, window)
    return {"workload": cell.name, "seed": seed, "correct": ok,
            "numbers": nums, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None,
                    help="the window whose requests are sampled "
                         "(default: BENCHMARK.json's run_seconds)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    bench = harness.load_benchmark()
    cell = harness.load_cell(bench, args.workload)
    seconds = args.seconds or float(bench["run_seconds"])
    for seed in (int(s) for s in args.seeds.split(",")):
        out = control_run(cell, seed, seconds, torch.device("cuda:0"),
                          lambda m: print(m, file=sys.stderr, flush=True))
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
