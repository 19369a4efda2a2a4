"""The one traffic generator: reproducible from a seed, and every seed
offered the same work in another order."""

import numpy as np

from conftest import SEED
from lpqbench import loadgen


def test_open_schedule_reproducible_and_same_work_across_seeds():
    mix = loadgen.load_mix("online_mixed")
    a = loadgen.open_schedule(mix, 180.0, 10.0, 10000, SEED)
    b = loadgen.open_schedule(mix, 180.0, 10.0, 10000, SEED)
    c = loadgen.open_schedule(mix, 180.0, 10.0, 10000, SEED + 1)
    assert a == b and a != c
    assert len(a) == len(c) == 1800
    # every seed: the same arrivals and sizes in the same order; the
    # queries each request reads differ
    assert [(r.due, r.size) for r in a] == [(r.due, r.size) for r in c]
    assert [r.offset for r in a] != [r.offset for r in c]
    assert {r.size for r in a} == {1, 8, 32}
    assert [r.size for r in a].count(8) == 600
    quantiles = -np.log1p(-(np.arange(1800) + 0.5) / 1800) / 180.0
    gaps = np.diff([r.due for r in a])     # the quantiles, shuffled
    assert np.abs(gaps[:, None] - quantiles[None, :]).min(1).max() < 1e-9
    assert a[0].due == 0.0 and a[-1].due < 10.0
    assert abs(np.mean(np.diff([r.due for r in a])) - 1 / 180.0) < 2e-4
    assert all(0 <= r.offset <= 10000 - r.size for r in a)
    other = dict(mix, schedule_seed=2)      # the order is the mix's
    assert [(r.due, r.size) for r in loadgen.open_schedule(
        other, 180.0, 10.0, 10000, SEED)] != [(r.due, r.size) for r in a]


def test_closed_requests_reproducible():
    mix = loadgen.load_mix("batch256")
    take = lambda seed: [next(it) for it in [loadgen.closed_requests(
        mix, 10000, seed)] for _ in range(50)]
    a, b, c = take(SEED), take(SEED), take(SEED + 1)
    assert a == b and a != c
    assert all(r.size == 256 and r.due is None for r in a)
    assert all(0 <= r.offset <= 10000 - 256 for r in a)
    assert [r.index for r in a] == list(range(50))
