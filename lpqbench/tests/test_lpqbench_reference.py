"""The plain reference against a NumPy brute force on tiny data."""

import numpy as np
import pytest
import torch

from conftest import SEED, tiny
from lpqbench import harness
from lpqbench.reference import eq1, judge, scan


def np_encode(x, lo, hi, zero, bits):
    x, lo, hi, zero = (np.asarray(a, np.float32) for a in (x, lo, hi, zero))
    span = np.maximum(hi - lo, np.float32(1e-12))
    q = np.round(np.float32(2.0 ** bits) * (x - zero) / span)
    return np.clip(q, -2 ** (bits - 1), 2 ** (bits - 1) - 1).astype(np.int8)


def np_topd(qc, xc, metric, depth):
    q, x = qc.astype(np.int64), xc.astype(np.int64)
    s = q @ x.T
    if metric == "l2":
        s = 2 * s - (q ** 2).sum(1)[:, None] - (x ** 2).sum(1)[None, :]
    order = np.lexsort((np.broadcast_to(np.arange(x.shape[0]), s.shape), -s),
                       axis=1)[:, :depth]
    return np.take_along_axis(s, order, 1), order


@pytest.mark.parametrize("bits", [4, 8])
def test_encode_equals_numpy(bits):
    rng = np.random.default_rng(SEED)
    x = rng.normal(size=(500, 24)).astype(np.float32)
    lo, hi = x.min(0) * 0.7, x.max(0) * 0.7
    zero = (lo + hi) / 2
    got = eq1.encode(torch.from_numpy(x), *(torch.from_numpy(c) for c in
                                            (lo, hi, zero)), bits)
    np.testing.assert_array_equal(got.numpy(), np_encode(x, lo, hi, zero, bits))


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_topd_equals_numpy_with_ties(metric):
    rng = np.random.default_rng(SEED)
    xc = rng.integers(-2, 3, size=(3000, 8)).astype(np.int8)   # many ties
    qc = rng.integers(-2, 3, size=(7, 8)).astype(np.int8)
    top = scan.TopD(7, 25, torch.device("cpu"))
    for start in range(0, 3000, 700):
        top.add(scan.int_scores(torch.from_numpy(qc),
                                torch.from_numpy(xc[start:start + 700]),
                                metric), start)
    s, i = top.result()
    want_s, want_i = np_topd(qc, xc, metric, 25)
    np.testing.assert_array_equal(s.numpy(), want_s)
    np.testing.assert_array_equal(i.numpy(), want_i)


def test_constants_equal_numpy():
    rng = np.random.default_rng(SEED)
    x = rng.normal(2.0, 3.0, size=(4000, 6)).astype(np.float32)
    t = torch.from_numpy(x)
    lo, hi, zero = eq1.constants(t.split(1000), 6, "gaussian", 1.0, t.device)
    mu, sd = x.astype(np.float64).mean(0), x.astype(np.float64).std(0)
    np.testing.assert_allclose(zero.numpy(), mu, rtol=1e-12)
    np.testing.assert_allclose(hi.numpy() - lo.numpy(), 2 * sd, rtol=1e-12)
    lo, hi, zero = eq1.constants(t.split(1000), 6, "global_minmax", 1.0,
                                 t.device)
    assert float(lo[0]) == x.min() and float(hi[3]) == x.max()


class _Exact:
    """A system that answers with the NumPy brute force (and the set-up
    state the reference itself would compute)."""

    def __init__(self, config, x, consts):
        self.config, self.x, self.consts = config, x, consts

    def constants(self):
        return [torch.as_tensor(c, dtype=torch.float32) for c in self.consts]

    def code_rows(self, lo, hi):
        return torch.from_numpy(np_encode(self.x[lo:hi], *self.consts,
                                          self.config["quant"]["bits"]))


def test_judge_reads_zero_on_exact_answers_and_more_on_altered(bench):
    cell = tiny(harness.load_cell(bench, "bigann31m.online"), rows=5000)
    cfg = cell.config
    x = judge.corpus(cfg, SEED, torch.device("cpu")).numpy()
    consts = [np.full(cfg["dim"], v, np.float32)
              for v in (x.min(), x.max(), (x.min() + x.max()) / 2)]
    sys_ = _Exact(cfg, x, consts)
    q = np.ascontiguousarray(x[:12] + 3.0)
    qc = np_encode(q, *consts, 8)
    s, i = np_topd(qc, np_encode(x, *consts, 8), "l2", cfg["k"])
    nums = judge.judge(cfg, SEED, torch.device("cpu"), torch.from_numpy(q),
                       torch.from_numpy(s.astype(np.float32)),
                       torch.from_numpy(i.astype(np.int32)), sys_)
    assert nums["code_err"] == nums["cand_miss"] == 0.0
    assert nums["rank_gap"] == nums["score_err"] == 0.0
    assert nums["recall"] > 0.9
    i[3, 0] = i[3, -1] + 1 if i[3, -1] + 1 < 5000 else 0        # one slot
    bad = judge.judge(cfg, SEED, torch.device("cpu"), torch.from_numpy(q),
                      torch.from_numpy(s.astype(np.float32)),
                      torch.from_numpy(i.astype(np.int32)), sys_)
    assert bad["cand_miss"] > 0 and bad["score_err"] > 0
    i[5, 1] = i[5, 2]                                            # a repeat
    bad = judge.judge(cfg, SEED, torch.device("cpu"), torch.from_numpy(q),
                      torch.from_numpy(s.astype(np.float32)),
                      torch.from_numpy(i.astype(np.int32)), sys_)
    assert bad["rank_gap"] == judge.BIG


def test_judge_accepts_either_code_only_within_the_band(bench):
    """Constants off by less than ``CONST_REL`` of the span flip the odd
    code at a rounding boundary: either neighbour passes, and the queries
    it could touch are excused; constants off by far more fail
    ``code_err``."""
    cell = tiny(harness.load_cell(bench, "t2i10m.batch256"), rows=6000)
    cfg = cell.config
    cfg["rerank"] = None                   # the scan's own answers
    x = judge.corpus(cfg, SEED, torch.device("cpu"))
    ref = [c.numpy() for c in eq1.constants(x.split(1000), cfg["dim"],
                                            "gaussian", 1.0, x.device)]
    x = x.numpy()
    span = ref[1] - ref[0]
    q = np.ascontiguousarray(x[:40] * 1.5)

    def answer(shift):
        consts = [(c + shift * span).astype(np.float32) for c in ref]
        consts[1] = (ref[1] + 2 * shift * span).astype(np.float32)
        sys_ = _Exact(cfg, x, consts)
        s, i = np_topd(np_encode(q, *consts, 4), np_encode(x, *consts, 4),
                       "ip", cfg["k"])
        flips = int(np.sum(np_encode(x, *consts, 4)
                           != np_encode(x, *[c.astype(np.float32)
                                             for c in ref], 4)))
        return flips, judge.judge(cfg, SEED, torch.device("cpu"),
                                  torch.from_numpy(q),
                                  torch.from_numpy(s.astype(np.float32)),
                                  torch.from_numpy(i.astype(np.int32)), sys_)

    flips, nums = answer(0.4 * judge.CONST_REL)
    assert flips > 0                       # the band is exercised
    assert nums["code_err"] == nums["cand_miss"] == 0.0
    assert nums["rank_gap"] == nums["score_err"] == 0.0
    assert nums["excused"] < 40
    flips, nums = answer(200 * judge.CONST_REL)
    assert nums["code_err"] > 0
