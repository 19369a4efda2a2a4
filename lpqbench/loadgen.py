"""The one traffic generator: reads a mix's data file
(``traffic/<mix>.json``) and a cell's parameters, seeded from ``--seed``.

A mix file holds:

    loop      "open" (requests due on a schedule, whatever the system
              does) or "closed" (the next request is sent when the last
              one has been answered)
    sizes     queries a request may carry; ``weights`` (optional, equal
              by default) their shares
    arrivals  (open loops) "poisson"
    schedule_seed  (open loops) the seed of the arrivals' and sizes' order

An open loop offers ``rate`` requests a second (the cell's parameter) for
the window's length: the exponential distribution's quantiles at
(i + 0.5) / n as gaps (mean 1 / rate) and the shares of ``weights`` as
sizes, each shuffled once by the mix's own ``schedule_seed``.  So every
run's seed is offered the same arrivals and sizes in the same order: at
4/5 of the card's rate the order sets the queue, and a seed that reordered
them would change the work the tail measures.  The run's seed draws which
queries each request reads (``size`` consecutive queries of the pool from
a seeded offset), as it draws the corpus and the pool.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from lpqbench.data import derive_seed

TRAFFIC = Path(__file__).resolve().parent / "traffic"


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    size: int
    offset: int                     # first query of the pool it reads
    due: Optional[float] = None     # seconds after the window opens (open)


def load_mix(name: str) -> dict:
    mix = json.loads((TRAFFIC / f"{name}.json").read_text())
    if mix.get("loop") not in ("open", "closed"):
        raise ValueError(f"traffic {name!r}: loop must be open or closed")
    sizes = [int(s) for s in mix["sizes"]]
    weights = [float(w) for w in mix.get("weights", [1.0] * len(sizes))]
    if not sizes or len(weights) != len(sizes) or min(sizes) < 1 \
            or min(weights) <= 0:
        raise ValueError(f"traffic {name!r}: bad sizes / weights")
    if mix["loop"] == "open" and (mix.get("arrivals") != "poisson"
                                  or "schedule_seed" not in mix):
        raise ValueError(f"traffic {name!r}: open loops take poisson "
                         "arrivals and a schedule_seed")
    return {**mix, "sizes": sizes, "weights": weights}


def _rng(mix: dict, pool: int, seed: int) -> np.random.Generator:
    if pool < max(mix["sizes"]):
        raise ValueError(f"a pool of {pool} queries is smaller than a "
                         f"request of {max(mix['sizes'])}")
    return np.random.default_rng(derive_seed(seed, "traffic"))


def _size_multiset(sizes, weights, n: int) -> np.ndarray:
    share = np.asarray(weights) / np.sum(weights) * n
    counts = np.floor(share).astype(np.int64)
    # the remainder goes to the largest fractional parts, ties to the first
    for j in np.argsort(-(share - counts), kind="stable")[: n - counts.sum()]:
        counts[j] += 1
    return np.repeat(np.asarray(sizes, dtype=np.int64), counts)


def open_schedule(mix: dict, rate: float, seconds: float, pool: int,
                  seed: int) -> list[Request]:
    """Every request of an open loop due within ``seconds``."""
    if rate <= 0:
        raise ValueError("an open loop needs a positive rate")
    n = max(1, int(round(rate * seconds)))
    rng = _rng(mix, pool, seed)
    order = np.random.default_rng(
        derive_seed(int(mix["schedule_seed"]), "schedule"))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = gaps[order.permutation(n)]
    sizes = _size_multiset(mix["sizes"], mix["weights"], n)[
        order.permutation(n)]
    offsets = rng.integers(0, pool - sizes + 1)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return [Request(i, int(sizes[i]), int(offsets[i]), float(due[i]))
            for i in range(n)]


def closed_requests(mix: dict, pool: int, seed: int) -> Iterator[Request]:
    """An endless closed-loop stream: sizes drawn by ``weights``."""
    rng = _rng(mix, pool, seed)
    sizes = np.asarray(mix["sizes"], dtype=np.int64)
    p = np.asarray(mix["weights"]) / np.sum(mix["weights"])
    i = 0
    while True:
        size = int(rng.choice(sizes, p=p))
        yield Request(i, size, int(rng.integers(0, pool - size + 1)))
        i += 1
