"""Run one cell of the benchmark once, on the card this process is started on.

    python3 lpqbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number the
judge compared, beside its limit); the last lines of standard error are
the same checks.  With ``--trace 0`` the metrics are the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics (``BENCHMARK.json``).

Exits non-zero, printing no result, where there is no CUDA card, fewer
cards than the cell asks for, no ``repro_torch`` beside this folder, or
where ``jax``, ``jaxlib``, ``flax`` or ``repro`` is loaded once the
window has closed.  The port builds its kernels into ``build/`` of the
checkout at first use, which the first run of a checkout pays in set-up.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":          # run as a script: the checkout's root
    sys.path[0] = str(ROOT)         # and its src/ come first, not lpqbench/
    sys.path.insert(1, str(ROOT / "src"))

#: top-level modules the process may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from lpqbench import harness

    t_torch = time.perf_counter() - T_START

    cell = harness.load_cell(harness.load_benchmark(), args.workload)
    chips = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no result: the cell needs {chips} CUDA card(s), this machine "
            f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        log(f"no result: the program under test does not import: {exc}")
        return 4
    from lpqbench.system import Program

    log(f"[start] torch imported {t_torch:.3f} s, the program "
        f"{time.perf_counter() - T_START:.3f} s after the process started")

    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda:0"), Program, T_START, log)
    bad = forbidden_loaded()
    if bad:
        log(f"no result: the process holds {bad} once the window has closed")
        return 5
    for name, c in out["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILS"
        log(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
