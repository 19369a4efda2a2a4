"""The serving CLI (``repro_torch.launch.serve``) against the reference's
(``repro.launch.serve``), on the CPU under ``--profile ci-cpu``.

Both ``main``s run in this process on one corpus: each package's
``synthetic.load`` is replaced by a function returning the same numpy
corpus and queries (a tensor copy for the port), so both build the same
index, or the port loads the npz the reference saved.  The parity tests
hold equal every telemetry field that does not read a clock: the report's
``served`` / ``requests`` / ``writes`` / ``mean_*``, the counters
(``queries_served``, ``replans``, ``replans_avoided``, the filter's), the
sequence of event types and each request's bucket, padding, rerank count
and cache outcome, and the printed bucket and shard lines.  Exact
equality: these are counts.  They also hold equal, in order, the ids of
every result each package waited for: the warm-up searches, then each
request's result as served (a cache hit's included).

Profiles are process-start state in both packages, so every test forgets
the applied ones (``_reset_for_tests``) and any adopted tuning table.
Also here: the reference's ``TestServeLoop`` (``tests/test_runtime.py``),
``test_serve_main_runs_mixed`` (``tests/test_searcher.py``) and
``test_serving_loop_runs`` (``tests/test_system.py``) on the port, the
``cpu-mesh4`` shard count against the reference's, the CUDA default
raising where there is no card, and ``data.exact_topk`` (the recall
ground truth) against the reference's.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.data import synthetic as r_synthetic  # noqa: E402
from repro.launch import serve as r_serve  # noqa: E402
from repro.runtime import profile as r_profile  # noqa: E402
from repro.tune import table as r_T  # noqa: E402
from repro_torch.data import synthetic as t_synthetic  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.runtime import profile as t_profile  # noqa: E402
from repro_torch.tune import table as t_T  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_MAX, Q_MAX, D_FULL = 1032, 512, 32


@pytest.fixture(autouse=True)
def _fresh_process_state():
    for mod in (t_profile, r_profile):
        mod._reset_for_tests()
    t_T.clear()
    r_T.clear()
    yield
    for mod in (t_profile, r_profile):
        mod._reset_for_tests()
    t_T.clear()
    r_T.clear()


@pytest.fixture(scope="module")
def data():
    """Product-like corpus and queries (the reference's generator), as
    numpy: every test serves these through both packages."""
    c, q, _m = r_synthetic.load("product", N_MAX, Q_MAX)
    return np.asarray(c[:, :D_FULL]), np.asarray(q[:, :D_FULL])


@pytest.fixture
def same_data(monkeypatch, data):
    corpus, queries = data

    def r_load(name, n, n_queries=1000, key=None):
        assert n <= N_MAX and n_queries <= Q_MAX
        return corpus[:n], queries[:n_queries], "ip"

    def t_load(name, n, n_queries=1000, seed=None, device=None):
        assert n <= N_MAX and n_queries <= Q_MAX
        return (torch.from_numpy(corpus[:n].copy()),
                torch.from_numpy(queries[:n_queries].copy()), "ip")

    monkeypatch.setattr(r_synthetic, "load", r_load)
    monkeypatch.setattr(t_synthetic, "load", t_load)


def _run(main, argv, tmp_path, tag, capsys):
    out = tmp_path / f"{tag}.json"
    main([*argv, "--telemetry-out", str(out)])
    text = capsys.readouterr().out
    return json.loads(out.read_text()), text


#: counters that read no clock (admission and maintenance do)
_COUNTERS = ("queries_served", "replans", "replans_avoided",
             "filter_allowed_rows", "filter_selectivity_permille",
             "filtered_requests", "filtered_queries", "requests_degraded")
#: per-request fields that read no clock
_REQ_FIELDS = ("outcome", "degraded", "cache", "bucket", "padded_q",
               "reranked", "queries", "cache_hit", "filter_selectivity")


def _clock_free(tel: dict, text: str) -> dict:
    rep = tel["meta"]["report"]
    line = next(ln for ln in text.splitlines()
                if ln.startswith("[serve] index="))
    return {
        "report": {k: v for k, v in rep.items() if k != "qps"},
        "counters": {k: tel["counters"].get(k, 0) for k in _COUNTERS},
        "events": [e["type"] for e in tel["events"]],
        "requests": [{k: e.get(k) for k in _REQ_FIELDS}
                     for e in tel["events"] if e["type"] == "request"],
        "writes": [{k: e.get(k) for k in ("op", "rows", "replanned",
                                           "epoch")}
                   for e in tel["events"] if e["type"] == "write"],
        "plan": line[line.index("memory="):],
        "meta": {k: tel["meta"][k] for k in ("n", "d", "k", "batch",
                                             "requests", "mutate", "cache")},
    }


def _record_results(monkeypatch) -> tuple[list, list]:
    """Record the ids and scores of every result each package waits for:
    the warm-up searches, then each request's result as served (a cache
    hit included), in order.  Both ``main``s wait at the same points (the
    reference in ``jax.block_until_ready``, the port in ``_ready``)."""
    r_got, t_got = [], []
    r_wait, t_ready = jax.block_until_ready, t_serve._ready

    def r_record(x):
        r_got.append(np.asarray(x))
        return r_wait(x)

    def t_record(res):
        t_got.append(res.ids.cpu().numpy())
        return t_ready(res)

    monkeypatch.setattr(jax, "block_until_ready", r_record)
    monkeypatch.setattr(t_serve, "_ready", t_record)
    return r_got, t_got


def _assert_same_session(tmp_path, capsys, monkeypatch, argv, r_argv=None):
    r_ids, t_ids = _record_results(monkeypatch)
    rt, rtext = _run(r_serve.main, r_argv or argv, tmp_path, "ref", capsys)
    r_profile._reset_for_tests()
    tt, ttext = _run(t_serve.main, argv, tmp_path, "port", capsys)
    want, got = _clock_free(rt, rtext), _clock_free(tt, ttext)
    assert got == want
    # each request's result ids, in order, equal the reference's
    assert len(t_ids) == len(r_ids) >= len(got["requests"])
    for i, (t, r) in enumerate(zip(t_ids, r_ids)):
        assert np.array_equal(t, r), f"result {i} of {len(r_ids)}"
    assert tt["meta"]["runtime"]["profile"] == "ci-cpu"
    assert tt["meta"]["runtime"]["backend"] == "cpu"
    return got


# --------------------------------------------------------------------------
# parity on built indexes


PARITY_ARMS = {
    "flat,lpq8@gaussian:3": ["--batch", "32", "--requests", "9", "--mixed",
                             "--cache", "16", "--hot-repeat", "3"],
    "flat,lpq4+r32": ["--batch", "8", "--requests", "6", "--mixed",
                      "--k", "5"],
    "stream(flat,lpq4)": ["--batch", "8", "--requests", "6", "--mutate",
                          "--cache", "8", "--hot-repeat", "2"],
}


@pytest.mark.parametrize("filtered", [False, True],
                         ids=["unfiltered", "filtered"])
@pytest.mark.parametrize("arm", list(PARITY_ARMS))
def test_serve_matches_the_reference_clock_free(tmp_path, capsys, monkeypatch,
                                                same_data, arm, filtered):
    argv = ["--profile", "ci-cpu", "--index", arm, "--n", "1024", "--d",
            "32", *PARITY_ARMS[arm]]
    if filtered:
        argv += ["--filter-col", "brand", "--filter-value", "1,4",
                 "--filter-cats", "6"]
    got = _assert_same_session(tmp_path, capsys, monkeypatch, argv)
    assert got["report"]["served"] > 0
    if "--hot-repeat" in argv:
        assert any(r["cache"] == "hit" for r in got["requests"])
    if "--mutate" in argv:
        assert got["counters"]["replans"] >= 1
        assert got["counters"]["replans_avoided"] >= 1
    if filtered:
        assert got["counters"]["filtered_requests"] == len(got["requests"])


# --------------------------------------------------------------------------
# parity on indexes the reference saved and the port loaded


@pytest.mark.parametrize("arm", ["pq8+lpq", "ivf16,lpq8"])
def test_reference_saved_index_serves_the_same(tmp_path, capsys, monkeypatch,
                                               same_data, arm):
    path = tmp_path / "ref_index.npz"
    base = ["--profile", "ci-cpu", "--n", "1024", "--d", "32", "--batch",
            "8", "--requests", "6", "--mixed", "--k", "10", "--nprobe", "4"]
    r_serve.main([*base, "--index", arm, "--save-index", str(path),
                  "--requests", "1"])
    capsys.readouterr()
    r_profile._reset_for_tests()
    argv = [*base, "--index-path", str(path), "--cache", "8",
            "--hot-repeat", "2"]
    got = _assert_same_session(tmp_path, capsys, monkeypatch, argv)
    assert got["meta"]["n"] == 1024 and got["meta"]["d"] == 32

    # the loaded indexes report the reference's query dimension
    from repro.knn.registry import load_index as r_load
    from repro_torch.knn import load_index as t_load

    assert t_serve._index_dim(t_load(str(path), device="cpu")) == \
        r_serve._index_dim(r_load(str(path))) == 32


def test_save_index_embeds_the_adopted_tune_table(tmp_path, capsys,
                                                  same_data):
    """--tune adopts a standalone table the reference wrote (stamp-checked:
    the same hash in the session's stamp), --save-index embeds it, and the
    reference's loader adopts it back; a foreign table is parked."""
    ref_table = r_T.TuneTable(stamp=r_T.live_stamp())
    ref_table.put("scan", "ip", 8, 8, 1024, 32, r_T.TuneConfig("scan",
                                                               chunk=512))
    tune = tmp_path / "TUNE.json"
    ref_table.to_json(str(tune))
    npz = tmp_path / "tuned.npz"
    tel, text = _run(t_serve.main, [
        "--profile", "ci-cpu", "--index", "flat,lpq8", "--n", "256", "--d",
        "32", "--requests", "2", "--batch", "8", "--tune", str(tune),
        "--save-index", str(npz)], tmp_path, "port", capsys)
    h = ref_table.table_hash()
    assert tel["meta"]["runtime"]["tune_table"] == h
    assert f"tune: table={h}" in text and f"(tune={h})" in text
    r_T.clear()
    from repro.knn.registry import load_index as r_load

    r_load(str(npz))
    assert r_T.active().table_hash() == h

    foreign = r_T.TuneTable(stamp={**r_T.live_stamp(), "backend": "tpu",
                                   "device_kind": "TPU v5e"})
    foreign.put("scan", "ip", 8, 8, 1024, 32, r_T.TuneConfig("scan",
                                                             chunk=512))
    foreign.to_json(str(tune))
    t_T.clear()
    t_profile._reset_for_tests()
    tel, text = _run(t_serve.main, [
        "--profile", "ci-cpu", "--index", "flat,lpq8", "--n", "256", "--d",
        "32", "--requests", "1", "--batch", "8", "--tune", str(tune)],
        tmp_path, "port2", capsys)
    assert tel["meta"]["runtime"]["tune_table"] is None
    assert f"pending_mismatch={foreign.table_hash()}" in text


# --------------------------------------------------------------------------
# helpers held to the reference's


@pytest.mark.parametrize("mixed", [False, True])
def test_request_sizes_equal_the_reference(mixed):
    for n in (0, 1, 2, 3, 7, 20):
        for batch in (1, 3, 4, 8, 32, 257):
            assert (t_serve._request_sizes(n, batch, mixed)
                    == r_serve._request_sizes(n, batch, mixed))


@pytest.mark.parametrize("batch,sizes", [(1, None), (8, None), (40, None),
                                         (256, None), (300, None),
                                         (8, "4,1,16")])
def test_buckets_equal_the_reference(tmp_path, capsys, monkeypatch,
                                     same_data, batch, sizes):
    argv = ["--profile", "ci-cpu", "--index", "flat", "--n", "64", "--d",
            "8", "--requests", "1", "--batch", str(batch)]
    if sizes:
        argv += ["--batch-sizes", sizes]
    _assert_same_session(tmp_path, capsys, monkeypatch, argv)


# --------------------------------------------------------------------------
# devices: shards under cpu-mesh4, the CUDA default


def test_cpu_mesh4_shards_four_ways_as_the_reference(tmp_path):
    """--shards 4 under cpu-mesh4: the reference (its own process, so the
    profile's host device count takes effect before JAX starts) and the
    port both shard four ways, with the same placement."""
    argv = ["--profile", "cpu-mesh4", "--index", "ivf16,lpq8", "--n",
            "1000", "--d", "16", "--batch", "8", "--requests", "2",
            "--shards", "4"]
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu", "HOME": str(tmp_path)}
    ref = subprocess.run([sys.executable, "-m", "repro.launch.serve", *argv],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=ROOT)
    assert ref.returncode == 0, ref.stderr[-2000:]
    port = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *argv], capture_output=True, text=True,
                          timeout=300, env=env, cwd=ROOT)
    assert port.returncode == 0, port.stderr[-2000:]

    def shard_facts(out):
        head = next(ln for ln in out.splitlines() if "profile=" in ln)
        plan = next(ln for ln in out.splitlines() if "index=" in ln)
        place = next(ln for ln in out.splitlines() if "placement:" in ln)
        return (head.split()[4], plan.split("shards=")[1].split()[0],
                place.split(" balance")[0])

    assert shard_facts(port.stdout) == shard_facts(ref.stdout) == (
        "x4", "4", "[serve] placement: kind=lists shards=4 units=16")


def test_cpu_mesh4_default_devices_and_stamp():
    from repro_torch.dist import sharding, submeshes

    t_profile.apply(t_profile.resolve("cpu-mesh4"))
    devs = sharding.default_devices()
    assert devs == [torch.device("cpu")] * 4
    assert t_profile.stamp()["n_devices"] == 4
    assert [g.size for g in submeshes(2)] == [2, 2]
    t_profile._reset_for_tests()
    t_profile.apply(t_profile.resolve("ci-cpu"))
    assert sharding.default_devices() == [torch.device("cpu")]
    assert t_profile.stamp()["n_devices"] == 1


def test_shards_on_one_device_print_the_reference_clamp(tmp_path, capsys,
                                                        same_data):
    argv = ["--profile", "ci-cpu", "--index", "flat,lpq8", "--n", "256",
            "--d", "16", "--batch", "8", "--requests", "2", "--shards", "4"]
    t_serve.main(argv)
    text = capsys.readouterr().out
    assert ("[serve] --shards 4 > 1 devices; using 1 (pick a profile with "
            "host_device_count, e.g. --profile cpu-mesh4, for more)") in text
    assert "1 device available — serving unsharded" in text
    assert "shards=1 replicas=1" in text


def test_no_profile_and_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv(t_profile.ENV_VAR, raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_serve.main(["--index", "flat,lpq8", "--n", "64", "--d", "8",
                      "--requests", "1"])
    t_profile._reset_for_tests()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_serve.main(["--profile", "cuda-serve", "--n", "64", "--d", "8"])


# --------------------------------------------------------------------------
# the reference's serve-loop tests, on the port


class TestServeLoop:
    def test_smoke_cache_mutate_telemetry(self, tmp_path):
        out = tmp_path / "tel.json"
        t_serve.main([
            "--profile", "ci-cpu",
            "--index", "stream(flat,lpq4)", "--n", "500", "--d", "24",
            "--requests", "6", "--batch", "8", "--mutate",
            "--cache", "16", "--hot-repeat", "2",
            "--telemetry-out", str(out),
        ])
        tel = json.loads(out.read_text())
        c = tel["counters"]
        assert tel["meta"]["runtime"]["profile"]
        # memtable-only upsert skipped its re-plan; the real delete did not
        assert c["replans_avoided"] >= 1
        assert c["replans"] >= 1
        assert c.get("cache_hits", 0) or any(
            e.get("cache") == "hit" for e in tel["events"]
            if e["type"] == "request")
        assert c["queries_served"] > 0

    def test_overload_degrades_and_sheds_cleanly(self, tmp_path):
        out = tmp_path / "tel.json"
        t_serve.main([
            "--profile", "ci-cpu",
            "--index", "flat,lpq8", "--n", "500", "--d", "24",
            "--requests", "8", "--batch", "8",
            "--admission", "--rate", "64", "--burst", "20",
            "--max-queue", "4",
            "--telemetry-out", str(out),
        ])
        tel = json.loads(out.read_text())
        c = tel["counters"]
        # the ladder engaged: some degraded, some shed, none crashed
        assert c["admission_shed"] >= 1
        assert c["admission_degrade"] >= 1
        assert c["admission_shed_queries"] >= 8
        sheds = [e for e in tel["events"] if e["type"] == "shed"]
        assert len(sheds) == c["admission_shed"]
        # served + shed covers every query request issued
        assert c["queries_served"] + c["admission_shed_queries"] == 64

    def test_replicas_maintenance_and_admission(self, tmp_path):
        """Two replica threads behind the admission ladder, and the
        maintenance thread beside a written stream index."""
        out = tmp_path / "tel.json"
        t_serve.main([
            "--profile", "ci-cpu", "--index", "flat,lpq8", "--n", "500",
            "--d", "24", "--requests", "10", "--batch", "8",
            "--replicas", "2", "--cache", "8", "--hot-repeat", "3",
            "--telemetry-out", str(out),
        ])
        c = json.loads(out.read_text())["counters"]
        assert c["replica0_requests"] + c["replica1_requests"] == 10
        assert c.get("replica_shed", 0) == 0
        assert c["queries_served"] == 80
        t_profile._reset_for_tests()
        t_serve.main([
            "--profile", "ci-cpu", "--index", "stream(flat,lpq4)+r32",
            "--n", "600", "--d", "24", "--requests", "8", "--batch", "8",
            "--mutate", "--maintenance", "--admission", "--max-queue", "6",
            "--telemetry-out", str(out),
        ])
        tel = json.loads(out.read_text())
        c = tel["counters"]
        assert c.get("maintenance_errors", 0) == 0
        assert c["replans"] >= 1 and c["replans_avoided"] >= 1
        assert c["queries_served"] + c.get("admission_shed_queries", 0) == 64


def test_serve_main_runs_mixed(capsys):
    t_serve.main(["--profile", "ci-cpu", "--index", "flat,lpq4+r32", "--n",
                  "1024", "--d", "32", "--batch", "8", "--requests", "6",
                  "--mixed"])
    out = capsys.readouterr().out
    assert "QPS" in out
    assert "p95" in out and "p99" in out
    assert "stats/request mean" in out
    # mixed traffic pads 1-query and 2-query requests into buckets
    assert "padded_q=" in out


def test_serving_loop_runs(tmp_path):
    """The batched ANN serving entrypoint executes end to end."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--profile",
         "ci-cpu", "--n", "2048", "--d", "32", "--batch", "8", "--requests",
         "3"],
        capture_output=True, text=True, timeout=600,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)},
        cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "QPS" in out.stdout
    assert "backend=cpu" in out.stdout


@pytest.mark.parametrize("metric", ["ip", "l2", "angular"])
def test_exact_topk_equals_the_reference(data, metric):
    """``data.exact_topk``: the fp32 flat scan, ids equal and scores
    within rtol 1e-6 of the reference's (the two sum a dot in different
    orders; these random rows have no near-ties at k=10)."""
    from repro.data import exact_topk as r_exact
    from repro_torch.data import exact_topk

    corpus, queries = data
    rs, ri = r_exact(corpus[:600], queries[:20], 10, metric)
    got = exact_topk(corpus[:600], queries[:20], 10, metric, device="cpu")
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ri))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(rs), rtol=1e-6)
