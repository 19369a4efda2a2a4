"""End-to-end metrics: what a user of the served search sees, by the host's
clock (``BENCHMARK.json`` names which cells report which).

    qps           queries answered in the window / the window's seconds
                  (from its opening to the last answer)
    p95_ms        95th percentile of every request's latency; in an open
                  loop from the time it was due, not the time it was sent
    peak_mem_gib  the allocator's peak over the window (reset as it opens)
    setup_s       process start to the first timed request
"""

from __future__ import annotations

import numpy as np


def qps(w: dict) -> float:
    return sum(r["size"] for r in w["requests"]) / w["window_s"]


def p95_ms(w: dict) -> float:
    return float(np.percentile([r["latency_s"] for r in w["requests"]], 95)
                 * 1e3)


def peak_mem_gib(w: dict) -> float:
    return w["peak_bytes"] / 2 ** 30


def setup_s(w: dict) -> float:
    return w["setup_s"]


UNITS = {"qps": "queries/s", "p95_ms": "ms", "peak_mem_gib": "GiB",
         "setup_s": "s"}


def read(name: str, window: dict) -> float:
    if name not in UNITS:
        raise KeyError(f"no end-to-end metric named {name!r}")
    return float(globals()[name](window))
