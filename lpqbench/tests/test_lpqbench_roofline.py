"""The frozen work count against hand counts at two shapes, and the
trace's reduction on a hand-made timeline."""

import pytest

from lpqbench import roofline, trace


def test_work_count_bigann_one_query():
    cfg = {"rows": 31_250_000, "dim": 128, "k": 10,
           "quant": {"bits": 8}, "rerank": None}
    w = roofline.request_work(cfg, 1)
    # codes once + one fp32 query + ten (score, id) pairs
    assert w["bytes"] == 31_250_000 * 128 + 128 * 4 + 10 * 8
    assert w["int_ops"] == 2 * 31_250_000 * 128 and w["fp_ops"] == 0
    assert roofline.least_seconds(w) == pytest.approx(
        (4_000_000_000 + 592) / 3.35e12)            # bytes bound: 1.19 ms


def test_work_count_t2i_batch_with_rerank():
    cfg = {"rows": 10_000_000, "dim": 200, "k": 10,
           "quant": {"bits": 4}, "rerank": {"bits": 32, "depth": 40}}
    w = roofline.request_work(cfg, 256)
    assert w["bytes"] == (10_000_000 * 100 + 256 * 200 * 4 + 256 * 10 * 8
                          + 256 * 40 * 200 * 4)
    assert w["int_ops"] == 2 * 256 * 10_000_000 * 200
    assert w["fp_ops"] == 2 * 256 * 40 * 200
    ops_s = 1.024e12 / 1979e12 + 4_096_000 / 67e12
    assert roofline.least_seconds(w) == pytest.approx(ops_s)   # 0.52 ms
    assert ops_s > w["bytes"] / 3.35e12


def test_trace_reduce_busy_gaps_and_labels():
    events = [("void k1<1>(int)", "kernel", 1.0, 1.5),
              ("k1<2>", "kernel", 1.4, 2.0),        # overlaps the first
              ("Memset (Device)", "gpu_memset", 3.0, 3.25),
              ("k2", "kernel", 9.0, 9.5)]           # outside the window
    spans = [("wait_arrival", 0.0, 2.5), ("searcher_call", 2.5, 2.9)]
    r = trace.reduce(events, spans, 0.5, 4.0)
    assert r["busy_s"] == pytest.approx(1.25)
    assert r["window_s"] == pytest.approx(3.5) and r["kernels"] == 2
    assert r["device_ops"][0] == ["k1", pytest.approx(1.1)]   # op time
    # gaps 0.5-1.0 (mid 0.75), 2.0-3.0 (mid 2.5), 3.25-4.0; longest first
    assert r["idle_gaps"] == [["searcher_call", pytest.approx(1.0)],
                              ["harness", pytest.approx(0.75)],
                              ["wait_arrival", pytest.approx(0.5)]]
    assert trace.reduce(events, spans, 5.0, 6.0) is None
