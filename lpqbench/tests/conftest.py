"""Shared helpers of the benchmark's own tests (run from the repository's
root: ``python -m pytest lpqbench/tests``; the repository's tier-1 run
collects ``tests/`` only)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from lpqbench import harness  # noqa: E402

#: a tiny seed past 2**31, as the driver's are
SEED = 2**31 + 12345


def tiny(cell: harness.Cell, rows: int = 6000, queries: int = 300,
         requests: int = 6) -> harness.Cell:
    """The cell at a size a CPU test holds: its widths, metric, k, codes,
    rerank and limits kept; rows, pool and sample cut."""
    cell.config["rows"], cell.config["queries"] = rows, queries
    cell.spec["check"]["requests"] = requests
    if "rate" in cell.spec:
        cell.spec["rate"] = 100.0
    return cell


@pytest.fixture
def bench():
    return harness.load_benchmark()


@pytest.fixture(params=["bigann31m.online", "t2i10m.batch256"])
def tiny_cell(request, bench):
    return tiny(harness.load_cell(bench, request.param))
