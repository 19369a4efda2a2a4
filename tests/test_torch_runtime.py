"""``repro_torch.runtime`` against the reference's ``repro.runtime`` on
identical inputs: profile resolution and files read by both packages,
cache tiers and fingerprints (equal keys in both packages, hits
bit-identical to misses and to the reference's results on indexes the
reference built and the port loaded), the admission shed ladder (equal
decisions and counters under the same ``FakeClock``), telemetry (equal
percentiles), background compaction's atomic-swap invariant and the
maintenance scheduler (its thread test waits on the scheduler's swap
event, never on a clock loop), and the runtime hooks of
``tests/test_cascade.py``.  The serve-loop class is ported in
``tests/test_torch_serve.py``; the trend gate waits for the port's
benchmark.
"""

import io
import json
import threading
import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import repro.runtime as R  # noqa: E402
import repro_torch.runtime as P  # noqa: E402
from repro.data import synthetic  # noqa: E402
from repro.knn import SearchParams as RSearchParams  # noqa: E402
from repro.knn import make_index as r_make  # noqa: E402
from repro.runtime import profile as r_profile  # noqa: E402
from repro.tune import table as r_T  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.knn import SearchParams, load_index, make_index  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    ADMIT,
    DEGRADE,
    MISS,
    SHED,
    CachedSearcher,
    DegradePolicy,
    LUTCache,
    MaintenanceScheduler,
    RuntimeProfile,
    Telemetry,
    TTLLRUCache,
    fingerprint,
)
from repro_torch.runtime import profile as rtprofile  # noqa: E402
from repro_torch.tune import table as T  # noqa: E402

K = 10
D = 24


@pytest.fixture(autouse=True)
def _untuned():
    # both packages consult a process-wide tuning table: compare untuned
    with r_T.pinned(None), T.pinned(None):
        yield


@pytest.fixture(scope="module")
def corpus():
    c, _q, _m = synthetic.load("product", 600, 8)
    return np.asarray(c[:, :D])


@pytest.fixture(scope="module")
def extra():
    c, _q, _m = synthetic.load("product", 400, 8, key=jax.random.PRNGKey(3))
    return np.asarray(c[:, :D])


@pytest.fixture(scope="module")
def queries(corpus):
    _c, q, _m = synthetic.load("product", 64, 8)
    return np.asarray(q[:, :D])


@pytest.fixture(scope="module")
def saved(corpus, tmp_path_factory):
    """Reference-built indexes saved to npz: {factory: (index, path)}."""
    out = {}
    d = tmp_path_factory.mktemp("rt")
    for f, kw in (("flat,lpq8", {}),
                  ("pq4x4+lpq", dict(kmeans_iters=2,
                                     key=jax.random.PRNGKey(0)))):
        with r_T.pinned(None):
            idx = r_make(f, corpus, **kw)
            path = d / (f.replace(",", "_").replace("+", "_") + ".npz")
            idx.save(str(path))
        out[f] = (idx, path)
    return out


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# ---------------------------------------------------------------------------
# profiles


class TestRuntimeProfile:
    def test_resolve_default_and_explicit(self):
        assert rtprofile.resolve().name == "default"
        assert rtprofile.resolve("ci-cpu").host_device_count == 1
        assert rtprofile.resolve("cpu-mesh4").host_device_count == 4
        assert rtprofile.resolve("cuda-serve").platform == "cuda"
        shared = set(rtprofile.PROFILES) & set(r_profile.PROFILES)
        assert shared == {"default", "cpu-dev", "ci-cpu", "cpu-mesh4",
                          "debug-nan"}
        for name in shared:
            assert rtprofile.PROFILES[name].to_dict() == \
                r_profile.PROFILES[name].to_dict()

    def test_resolve_env(self, monkeypatch):
        monkeypatch.setenv(rtprofile.ENV_VAR, "cpu-dev")
        assert rtprofile.ENV_VAR == r_profile.ENV_VAR
        assert rtprofile.resolve().name == "cpu-dev"
        assert rtprofile.resolve("default").name == "default"

    def test_resolve_unknown_lists_registry(self):
        with pytest.raises(ValueError, match="ci-cpu"):
            rtprofile.resolve("nope")

    def test_round_trip(self):
        p = RuntimeProfile(name="x", platform="cpu", host_device_count=2,
                           xla_flags=("--flag=1",), seed=7,
                           deterministic=False)
        assert RuntimeProfile.from_dict(p.to_dict()) == p
        assert p.to_dict() == R.RuntimeProfile.from_dict(p.to_dict()).to_dict()
        with pytest.raises(ValueError, match="unknown"):
            RuntimeProfile.from_dict({"name": "x", "bogus": 1})

    def test_stamp_keys(self):
        s = rtprofile.stamp(rtprofile.resolve("default"))
        for key in ("profile", "backend", "device_kind", "interpret",
                    "torch_version", "cuda_version", "seed",
                    "deterministic", "n_devices", "tune_table"):
            assert key in s
        assert s["profile"] == "default"
        # no card here: the plain versions run, as the reference's
        # interpret mode on this CPU
        assert s["interpret"] is True and s["backend"] == "cpu"
        r = r_profile.stamp(r_profile.resolve("default"))
        for key in ("profile", "backend", "device_kind", "interpret",
                    "seed", "deterministic", "n_devices", "xla_flags",
                    "host_device_count", "x64", "nan_debug"):
            assert s[key] == r[key], key

    def test_apply_idempotent_and_sticky(self, monkeypatch):
        rtprofile._reset_for_tests()
        try:
            p = rtprofile.apply(rtprofile.resolve("cpu-dev"))
            assert rtprofile.active() is p
            assert rtprofile.apply(p) is p          # same profile: no-op
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                got = rtprofile.apply(rtprofile.resolve("default"))
            assert got.name == "cpu-dev"            # first apply wins
            assert any("already applied" in str(x.message) for x in w)
            assert rtprofile.stamp()["applied"] is True
            # the caller asked for the CPU: entry points default there
            from repro_torch.device import resolve_device

            assert resolve_device(None).type == "cpu"
            idx = make_index("flat,lpq8", np.eye(16, dtype=np.float32))
            assert idx.device.type == "cpu"
        finally:
            rtprofile._reset_for_tests()
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rtprofile.apply(rtprofile.resolve("cuda-serve"))
        with pytest.raises(ValueError, match="platform"):
            rtprofile.apply(RuntimeProfile(name="t", platform="tpu"))
        rtprofile._reset_for_tests()

    def test_key_is_seeded(self):
        g7 = rtprofile.key(RuntimeProfile(name="s7", seed=7))
        assert isinstance(g7, torch.Generator)
        ref = torch.Generator().manual_seed(7)
        assert torch.equal(torch.randn(5, generator=g7),
                           torch.randn(5, generator=ref))

    def test_register(self):
        p = rtprofile.register(RuntimeProfile(name="_test_prof", seed=3))
        try:
            assert rtprofile.resolve("_test_prof") is p
        finally:
            rtprofile.PROFILES.pop("_test_prof")


# ---------------------------------------------------------------------------
# cache tiers


def _drive_cache(mod, clock):
    """The reference test's LRU / TTL sequence on ``mod``'s cache class."""
    c = mod.TTLLRUCache(capacity=2)
    out = [c.get("a") is mod.MISS]
    c.put("a", 1)
    c.put("b", 2)
    out.append(c.get("a"))
    c.put("c", 3)
    out += [c.get("b") is mod.MISS, c.get("a"), c.get("c")]
    t = mod.TTLLRUCache(capacity=4, ttl_s=1.0, clock=clock)
    t.put("a", 1)
    clock.advance(0.5)
    out.append(t.get("a"))
    clock.advance(0.6)
    out.append(t.get("a") is mod.MISS)
    return out, c.stats(), t.stats()


class TestTTLLRUCache:
    def test_hit_miss_and_lru_eviction(self):
        out, st, _ = _drive_cache(R, FakeClock())
        assert _drive_cache(P, FakeClock())[:2] == (out, st)
        c = TTLLRUCache(capacity=2)
        assert c.get("a") is MISS
        c.put("a", 1)
        c.put("b", 2)
        assert c.get("a") == 1
        c.put("c", 3)
        assert c.get("b") is MISS
        assert c.get("a") == 1 and c.get("c") == 3
        st = c.stats()
        assert (st["hits"], st["misses"], st["evictions"]) == (3, 2, 1)
        assert st["entries"] == 2

    def test_ttl_expiry(self):
        _, _, port = _drive_cache(P, FakeClock())
        _, _, ref = _drive_cache(R, FakeClock())
        assert port == ref and port["expirations"] == 1

    def test_get_or_build(self):
        c = TTLLRUCache(capacity=2)
        calls = []
        build = lambda: calls.append(1) or "v"  # noqa: E731
        assert c.get_or_build("k", build) == "v"
        assert c.get_or_build("k", build) == "v"
        assert len(calls) == 1

    def test_validation(self):
        with pytest.raises(ValueError):
            TTLLRUCache(capacity=0)
        with pytest.raises(ValueError):
            TTLLRUCache(capacity=1, ttl_s=0.0)


class TestFingerprint:
    def test_array_identity_and_sensitivity(self):
        a = np.arange(12, dtype=np.float32)
        assert fingerprint(a) == fingerprint(a.copy())
        assert fingerprint(a) != fingerprint(a.astype(np.float64))
        assert fingerprint(a) != fingerprint(a.reshape(3, 4))
        b = a.copy()
        b[3] += 1e-3
        assert fingerprint(a) != fingerprint(b)
        # one batch, one key, in both packages and as a tensor
        for x in (a, a.reshape(3, 4), a.astype(np.float64), b,
                  np.zeros((0, 5), np.int8)):
            assert fingerprint(x) == R.fingerprint(x)
            assert fingerprint(torch.from_numpy(x.copy())) == R.fingerprint(x)

    def test_mixed_parts(self):
        a = np.zeros(3, np.float32)
        assert fingerprint(a, 10, "l2") == fingerprint(a, 10, "l2")
        assert fingerprint(a, 10, "l2") != fingerprint(a, 11, "l2")
        assert fingerprint(a, 10, "l2", b"x") == R.fingerprint(a, 10, "l2",
                                                               b"x")


class TestCachedSearcher:
    def test_hit_is_bit_identical(self, saved, queries):
        ref_idx, path = saved["flat,lpq8"]
        idx = load_index(str(path), device="cpu", adopt_tune=False)
        s = idx.searcher(K, SearchParams(), batch_sizes=(8,))
        cs = CachedSearcher(s, TTLLRUCache(capacity=8))
        q = queries[:8]
        r1 = cs(q)
        assert r1.stats["cache"] == "miss"
        r2 = cs(q)
        assert r2.stats["cache"] == "hit"
        assert torch.equal(r1.ids, r2.ids) and torch.equal(r1.scores,
                                                           r2.scores)
        assert r2.stats["bytes_read"] == 0 and r2.stats["chunks"] == 0
        r0 = s(q)
        assert torch.equal(r0.ids, r2.ids)
        # and the reference's own cached searcher gives the same answer
        ref = R.CachedSearcher(ref_idx.searcher(K, RSearchParams(),
                                                batch_sizes=(8,)),
                               R.TTLLRUCache(capacity=8))
        ref(q)
        rh = ref(q)
        assert rh.stats["cache"] == "hit"
        np.testing.assert_array_equal(r2.ids.numpy(), np.asarray(rh.ids))
        np.testing.assert_array_equal(r2.scores.numpy(), np.asarray(rh.scores))
        assert cs._key(cs.canonicalize(q))[1] == \
            ref._key(ref.canonicalize(q))[1]

    def test_version_invalidates(self, corpus, queries):
        idx = make_index("flat,lpq8", corpus, device="cpu")
        s = idx.searcher(K, SearchParams(), batch_sizes=(8,))
        cache = TTLLRUCache(capacity=8)
        gen = [0]
        cs = CachedSearcher(s, cache, version=lambda: gen[0])
        q = queries[:8]
        cs(q)
        assert cs(q).stats["cache"] == "hit"
        gen[0] += 1
        assert cs(q).stats["cache"] == "miss"
        assert cache.counters["misses"] == 2

    def test_proxies_plan_surface(self, corpus):
        idx = make_index("flat,lpq8", corpus, device="cpu")
        s = idx.searcher(K, SearchParams(), batch_sizes=(8,))
        cs = CachedSearcher(s, TTLLRUCache(capacity=2))
        assert cs.n_shards == s.n_shards
        assert cs.rerank is s.rerank
        assert cs.buckets_for(5) == s.buckets_for(5)


class TestLUTCacheTier:
    def test_eager_pq_search_hits_and_matches(self, saved, queries):
        ref_idx, path = saved["pq4x4+lpq"]
        idx = load_index(str(path), device="cpu", adopt_tune=False)
        q = queries[:8]
        baseline = idx.search(q, K)
        cache = LUTCache(capacity=4)
        engine.set_lut_cache(cache)
        try:
            assert engine.get_lut_cache() is cache
            r1 = idx.search(q, K)
            r2 = idx.search(q, K)
        finally:
            engine.set_lut_cache(None)
        assert cache.counters["misses"] == 1
        assert cache.counters["hits"] == 1
        ref = ref_idx.search(q, K)
        for r in (r1, r2):
            assert torch.equal(baseline.ids, r.ids)
            assert torch.equal(baseline.scores, r.scores)
            np.testing.assert_array_equal(r.ids.numpy(), np.asarray(ref.ids))
            np.testing.assert_array_equal(r.scores.numpy(),
                                          np.asarray(ref.scores))

    def test_jitted_searcher_bypasses_cache(self, saved, queries):
        # a bucketed Searcher's runs stand aside, as the reference's
        # compiled buckets (whose queries are tracers) do
        _ref_idx, path = saved["pq4x4+lpq"]
        idx = load_index(str(path), device="cpu", adopt_tune=False)
        s = idx.searcher(K, SearchParams(), batch_sizes=(8,))
        cache = LUTCache(capacity=4)
        engine.set_lut_cache(cache)
        try:
            r = s(queries[:8])
        finally:
            engine.set_lut_cache(None)
        assert tuple(r.ids.shape) == (8, K)
        assert len(cache) == 0


# ---------------------------------------------------------------------------
# admission


def _ctrl(mod, **kw):
    clk = FakeClock()
    kw.setdefault("rate_qps", 10.0)
    kw.setdefault("burst", 8.0)
    kw.setdefault("max_queue", 4)
    kw.setdefault("degrade_queue", 2)
    return mod.AdmissionController(clock=clk, **kw), clk


def _ladder(mod):
    """The reference tests' arrival sequence; returns the decisions and
    the counters."""
    out = []
    ctrl, clk = _ctrl(mod)
    for n, depth in ((4, 0), (4, 0), (4, 0), (1, 4), (8, 0), (1, 2)):
        out.append(ctrl.admit(n, queue_depth=depth))
    clk.advance(1.0)
    out.append(ctrl.admit(8, queue_depth=0))
    out.append(ctrl.admit(1, 0, deadline=clk() - 0.1))
    d = ctrl.admit(1, 0, deadline=clk() + 1.0)
    clk.advance(2.0)
    out.append(ctrl.recheck(d, deadline=clk() - 1.0))
    d = ctrl.admit(1, 0, deadline=clk() + 0.05)
    ctrl.observe(0.2)
    out.append(ctrl.recheck(d, deadline=clk() + 0.05))
    return ([(x.action, x.reason, x.tokens) for x in out],
            dict(ctrl.counters))


class TestAdmission:
    def test_ladder_under_overload(self):
        ctrl, _clk = _ctrl(P)
        d1 = ctrl.admit(4, queue_depth=0)
        d2 = ctrl.admit(4, queue_depth=0)
        assert (d1.action, d2.action) == (ADMIT, ADMIT)
        d3 = ctrl.admit(4, queue_depth=0)
        assert (d3.action, d3.reason) == (SHED, "budget")
        assert ctrl.counters["admission_shed_queries"] == 4

    def test_same_decisions_and_counters_as_the_reference(self):
        assert _ladder(P) == _ladder(R)

    def test_degrade_on_budget_and_watermark(self):
        ctrl, _clk = _ctrl(P, burst=5.0)
        assert ctrl.admit(4, queue_depth=0).action == ADMIT
        d = ctrl.admit(4, queue_depth=0)
        assert (d.action, d.reason) == (DEGRADE, "budget")
        ctrl2, _ = _ctrl(P)
        d = ctrl2.admit(4, queue_depth=2)
        assert (d.action, d.reason) == (DEGRADE, "queue")

    def test_hard_queue_bound_and_refill(self):
        ctrl, clk = _ctrl(P)
        d = ctrl.admit(1, queue_depth=4)
        assert (d.action, d.reason) == (SHED, "queue")
        ctrl.admit(8, queue_depth=0)
        assert ctrl.admit(8, queue_depth=0).action == SHED
        clk.advance(1.0)
        assert ctrl.admit(8, queue_depth=0).action == ADMIT

    def test_deadline_at_arrival_and_recheck(self):
        ctrl, clk = _ctrl(P)
        assert ctrl.admit(1, 0, deadline=clk() - 0.1).action == SHED
        d = ctrl.admit(1, 0, deadline=clk() + 1.0)
        assert d.action == ADMIT
        clk.advance(2.0)
        assert ctrl.recheck(d, deadline=clk() - 1.0).action == SHED
        d = ctrl.admit(1, 0, deadline=clk() + 0.05)
        ctrl.observe(0.2)
        out = ctrl.recheck(d, deadline=clk() + 0.05)
        assert (out.action, out.reason) == (DEGRADE, "deadline")
        assert ctrl.counters["admission_rechecks"] == 2

    def test_degrade_policy_scaling(self):
        pol, rpol = DegradePolicy(), R.DegradePolicy()
        sp = pol.params(SearchParams(nprobe=8, ef_search=100))
        assert (sp.nprobe, sp.ef_search) == (4, 50)
        assert pol.params(SearchParams(nprobe=1, ef_search=1)).nprobe == 1
        for depth in (40, 100, 0, 12):
            assert pol.rerank_depth(depth, k=10) == rpol.rerank_depth(depth,
                                                                      k=10)
        assert pol.rerank_depth(40, k=10) == 10
        assert pol.rerank_depth(100, k=10) == 25
        assert pol.rerank_depth(0, k=10) == 0
        assert pol.rerank_depth(12, k=10) == 10
        rsp = rpol.params(RSearchParams(nprobe=8, ef_search=100,
                                        budgets=(128, 32)), K)
        psp = pol.params(SearchParams(nprobe=8, ef_search=100,
                                      budgets=(128, 32)), K)
        assert (psp.nprobe, psp.ef_search, psp.budgets) == \
            (rsp.nprobe, rsp.ef_search, rsp.budgets)

    def test_ema(self):
        ctrl, _ = _ctrl(P)
        ctrl.observe(0.1)
        assert ctrl.ema_latency == pytest.approx(0.1)
        ctrl.observe(0.2)
        assert ctrl.ema_latency == pytest.approx(0.125)


# ---------------------------------------------------------------------------
# telemetry


class TestTelemetry:
    def test_request_trace_and_summary(self):
        def drive(tel_cls):
            clk = FakeClock()
            t = tel_cls(clock=clk, meta={"runtime": {"profile": "default"}})
            for i, ms in enumerate((10.0, 30.0, 20.0, 5.0)):
                tr = t.request(i)
                with tr.span("execute"):
                    clk.advance(ms / 1e3)
                tr.phase("queue_wait", 0.005)
                tr.annotate(outcome="served", bucket=8)
                tr.finish()
                tr.finish()                      # idempotent
            return t

        t, r = drive(Telemetry), drive(R.Telemetry)
        assert t.counters["requests"] == 4 and len(t.events) == 4
        ev = t.events[0]
        assert ev["execute_s"] == pytest.approx(0.010)
        assert ev["queue_wait_s"] == pytest.approx(0.005)
        assert ev["outcome"] == "served"
        assert t.summary()["execute"]["count"] == 4
        assert t.percentiles("execute")["p50_ms"] == pytest.approx(15.0)
        assert t.summary() == r.summary()
        assert t.events == r.events

    def test_adhoc_span_and_events(self):
        clk = FakeClock()
        t = Telemetry(clock=clk)
        with t.span("maintenance/compact", trigger="drift"):
            clk.advance(0.5)
        t.event("write", op="delete", rows=4)
        kinds = [e["type"] for e in t.events]
        assert kinds == ["span", "write"]
        assert t.events[0]["dur_s"] == pytest.approx(0.5)
        # a CPU device needs no synchronization; a span still times
        tr = t.request(0)
        with tr.span("execute", device=torch.device("cpu")):
            clk.advance(0.25)
        assert tr.phases["execute"] == pytest.approx(0.25)

    def test_to_json_round_trip(self):
        t = Telemetry(meta={"runtime": {"profile": "ci-cpu"}})
        t.counters["queries_served"] += np.int64(8)
        t.event("shed", reason="queue", queries=np.int32(4))
        buf = io.StringIO()
        payload = t.to_json(buf)
        parsed = json.loads(buf.getvalue())
        assert parsed["meta"]["runtime"]["profile"] == "ci-cpu"
        assert parsed["counters"]["queries_served"] == 8
        assert parsed["events"][0]["queries"] == 4
        assert payload["counters"] == parsed["counters"]

    def test_to_json_path(self, tmp_path):
        t = Telemetry()
        out = tmp_path / "tel.json"
        t.to_json(out)
        assert set(json.loads(out.read_text())) == {
            "meta", "counters", "summary", "events"}


# ---------------------------------------------------------------------------
# background compaction + maintenance


def _map_ids(scratch_ids, ext_ids) -> np.ndarray:
    return np.asarray(ext_ids)[np.asarray(scratch_ids)]


def _make(build, corpus, extra, n_extra=200, **kw):
    idx = build("stream(flat,lpq4)", corpus, seal_threshold=100,
                auto_compact=False, **kw)
    idx.upsert(np.arange(2000, 2000 + n_extra), extra[:n_extra])
    idx.delete(np.arange(0, 8))
    return idx


class TestBackgroundCompaction:
    def test_full_snapshot_parity_with_from_scratch(self, corpus, extra,
                                                    queries):
        idx = _make(make_index, corpus, extra, device="cpu")
        pending = idx.compact_snapshot(full=True)
        assert pending is not None and pending.recalibrated
        assert idx.apply_compaction(pending)
        st = idx.stats()
        assert st["segments"] == 1 and st["tombstones"] == 0
        ext_ids, vecs = idx.live_items()
        ref = make_index("flat,lpq4", vecs, device="cpu")
        res_ref = ref.search(queries, K)
        res = idx.search(queries, K)
        np.testing.assert_array_equal(_map_ids(res_ref.ids, ext_ids),
                                      res.ids.numpy())
        assert torch.equal(res_ref.scores, res.scores)
        # the reference's background round on the same writes
        r_idx = _make(r_make, corpus, extra)
        assert r_idx.apply_compaction(r_idx.compact_snapshot(full=True))
        r_res = r_idx.search(queries, K)
        assert r_idx.stats()["segments"] == st["segments"]
        np.testing.assert_array_equal(res.ids.numpy(), np.asarray(r_res.ids))
        np.testing.assert_array_equal(res.scores.numpy(),
                                      np.asarray(r_res.scores))

    def test_background_matches_synchronous_compact(self, corpus, extra,
                                                    queries):
        idx_a = _make(make_index, corpus, extra, device="cpu")
        idx_b = _make(make_index, corpus, extra, device="cpu")
        pending = idx_a.compact_snapshot(full=True)
        assert idx_a.apply_compaction(pending)
        idx_b.compact(full=True)
        ra, rb = idx_a.search(queries, K), idx_b.search(queries, K)
        assert torch.equal(ra.ids, rb.ids) and torch.equal(ra.scores,
                                                           rb.scores)

    def test_concurrent_delete_survives_swap(self, corpus, extra):
        idx = _make(make_index, corpus, extra, device="cpu")
        pending = idx.compact_snapshot(full=True)
        killed = idx.delete(np.arange(20, 24))
        assert killed == 4
        n_before = idx.n
        assert idx.apply_compaction(pending)
        assert idx.n == n_before
        ext_ids, _vecs = idx.live_items()
        assert not np.isin(np.arange(20, 24), ext_ids).any()

    def test_competing_swap_is_dropped(self, corpus, extra):
        idx = _make(make_index, corpus, extra, device="cpu")
        p1 = idx.compact_snapshot(full=True)
        p2 = idx.compact_snapshot(full=True)
        assert idx.apply_compaction(p1)
        assert not idx.apply_compaction(p2)
        assert idx.counters["swap_conflicts"] == 1

    def test_epoch_tracks_structural_change(self, corpus, extra):
        idx = make_index("stream(flat,lpq4)", corpus, seal_threshold=100,
                         auto_compact=False, device="cpu")
        e0 = idx.epoch
        idx.upsert(np.arange(2000, 2010), extra[:10])
        assert idx.epoch == e0
        idx.delete([999_999])
        assert idx.epoch == e0
        idx.delete([3])
        assert idx.epoch > e0


def _segmented(build, corpus, extra, **kw):
    idx = build("stream(flat,lpq4)", corpus, seal_threshold=50,
                auto_compact=False, max_segments=2, **kw)
    for i in range(4):                           # one sealed segment each
        idx.upsert(np.arange(2000 + i * 50, 2050 + i * 50),
                   extra[i * 50:(i + 1) * 50])
    return idx


class TestMaintenanceScheduler:
    def test_rejects_immutable_index(self, corpus):
        with pytest.raises(TypeError, match="mutable"):
            MaintenanceScheduler(make_index("flat,lpq8", corpus,
                                            device="cpu"))

    def test_run_once_idle_and_forced(self, corpus, extra):
        def drive(build, sched_cls, tel_cls, **kw):
            idx = build("stream(flat,lpq4)", corpus, seal_threshold=100,
                        auto_compact=False, **kw)
            idx.upsert(np.arange(2000, 2200), extra[:200])
            t = tel_cls()
            sched = sched_cls(idx, telemetry=t)
            out = sched.run_once(force_full=True)
            idle = sched.run_once()
            return out, idle, idx.stats()["segments"], dict(t.counters)

        port = drive(make_index, MaintenanceScheduler, Telemetry,
                     device="cpu")
        ref = drive(r_make, R.MaintenanceScheduler, R.Telemetry)
        out, idle, segments, counters = port
        assert out["swapped"] and out["trigger"] == "forced"
        assert segments == 1 and counters["maintenance_swaps"] == 1
        assert idle == {"ran": False}
        assert {k: v for k, v in out.items() if k != "epoch"} == \
            {k: v for k, v in ref[0].items() if k != "epoch"}
        assert port[1:] == ref[1:]

    def test_segment_trigger_and_thread(self, corpus, extra):
        """The background thread compacts while this thread serves; the
        test waits on the scheduler's swap event (C7: never a clock
        loop)."""
        idx = _segmented(make_index, corpus, extra, device="cpu")
        assert idx.stats()["segments"] > 2
        with MaintenanceScheduler(idx, interval_s=0.001) as sched:
            res = idx.searcher(K, batch_sizes=(8,))
            # each swap merges one group: wait for swaps until none is due
            while idx.compactor.should_compact(idx.manifest.segments):
                assert sched.swapped.wait(timeout=120)
                sched.swapped.clear()
        assert sched._thread is None                   # stopped and joined
        assert sched.counters["maintenance_swaps"] >= 1
        assert sched.counters["maintenance_errors"] == 0, sched.last_error
        assert idx.stats()["segments"] <= 2
        assert tuple(res(np.zeros((3, D), np.float32)).ids.shape) == (3, K)

    def test_thread_rounds_keep_exact_counts(self, corpus, extra):
        """Launch counts taken beside a maintenance thread lose no update
        (the wrappers count under a lock), and a thread stopped before
        its first round leaves the index alone."""
        counts = {"x": 0}
        import repro_torch.kernels._build as Bd

        def bump():
            for _ in range(2000):
                Bd.count(counts, "x")

        import sys

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            ts = [threading.Thread(target=bump) for _ in range(8)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
        finally:
            sys.setswitchinterval(old)
        assert counts["x"] == 16000
        assert kernels.launch_counts() is not None
        idx = _segmented(make_index, corpus, extra, device="cpu")
        sched = MaintenanceScheduler(idx, interval_s=3600).start()
        sched.stop()
        assert sched.counters["maintenance_rounds"] == 0
        assert idx.stats()["segments"] > 2


# ---------------------------------------------------------------------------
# the cascade tests' runtime hooks (tests/test_cascade.py:254-365)


def test_profile_file_round_trip(tmp_path):
    prof = RuntimeProfile(
        name="test-file-prof", platform="cpu", host_device_count=2,
        xla_flags=("--xla_foo=1",), seed=7, deterministic=False,
    )
    path = str(tmp_path / "prof.json")
    rtprofile.to_file(prof, path)
    try:
        loaded = rtprofile.from_file(path)
        assert loaded == prof
        assert rtprofile.PROFILES["test-file-prof"] == prof
        # one profile file serves both packages, both ways
        r_loaded = r_profile.from_file(path)
        assert r_loaded.to_dict() == prof.to_dict()
        r_path = str(tmp_path / "ref.json")
        r_profile.to_file(r_loaded, r_path)
        assert open(r_path).read() == open(path).read()
        assert rtprofile.from_file(r_path) == prof
    finally:
        rtprofile.PROFILES.pop("test-file-prof", None)
        r_profile.PROFILES.pop("test-file-prof", None)


def test_profile_file_rejects_unknown_and_nameless(tmp_path):
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        json.dump({"name": "x", "platfrm": "cpu"}, f)
    with pytest.raises(ValueError, match="platfrm"):
        rtprofile.from_file(bad)
    nameless = str(tmp_path / "nameless.json")
    with open(nameless, "w") as f:
        json.dump({"platform": "cpu"}, f)
    with pytest.raises(ValueError, match="name"):
        rtprofile.from_file(nameless)


def test_semantic_cache_keys_unify_query_representations(corpus, queries):
    """A float64 copy, a strided fp32 view and a tensor of the same batch
    hit the entry the canonical batch populated, bit-identical to it."""
    idx = make_index("flat,lpq8", corpus, device="cpu")
    cached = CachedSearcher(idx.searcher(K), TTLLRUCache(capacity=8))
    q = queries[:16]
    miss = cached(q)
    assert miss.stats["cache"] == "miss"
    hit = cached(np.asarray(q, np.float64))
    assert hit.stats["cache"] == "hit"
    assert torch.equal(miss.ids, hit.ids) and torch.equal(miss.scores,
                                                          hit.scores)
    strided = np.ascontiguousarray(np.stack([q, q], axis=1))[:, 0, :]
    assert not strided.flags["C_CONTIGUOUS"]
    assert cached(strided).stats["cache"] == "hit"
    assert cached(torch.from_numpy(q.copy())).stats["cache"] == "hit"
    assert cached.cache.counters["misses"] == 1
    assert cached.cache.counters["hits"] == 3


def test_maintenance_refreshes_rerank_store_after_swap(corpus, queries):
    idx = make_index("stream(flat,lpq8)+r32", corpus, seal_threshold=64,
                     auto_compact=False, key=0, device="cpu")
    idx.searcher(K)(queries)                       # warm the merge cache
    warm_refreshes = idx.counters["rerank_refreshes"]
    assert warm_refreshes >= 1
    sched = MaintenanceScheduler(idx, interval_s=10.0)
    out = sched.run_once(force_full=True)
    assert out["swapped"] is True
    assert out["rerank_refreshed"] is True
    assert sched.counters["rerank_refreshes"] == 1
    assert idx.counters["rerank_refreshes"] == warm_refreshes + 1
    idx.searcher(K)(queries)
    assert idx.counters["rerank_refreshes"] == warm_refreshes + 1


def test_merge_store_cache_invalidates_on_writes(corpus, queries, extra):
    idx = make_index("stream(flat,lpq8)+r32", corpus, seal_threshold=64,
                     auto_compact=False, key=0, device="cpu")
    idx.searcher(K)(queries)
    base = idx.counters["rerank_refreshes"]
    idx.searcher(K)(queries)                       # same epoch -> cache hit
    assert idx.counters["rerank_refreshes"] == base
    idx.upsert(np.arange(600, 604), extra[:4] * 0.05)
    idx.searcher(K)(queries)                       # upsert -> rebuild
    assert idx.counters["rerank_refreshes"] == base + 1


def test_degrade_policy_shrinks_cascade_budgets(corpus, queries):
    policy = DegradePolicy()
    assert policy.budgets((128, 32), K) == (64, 16)
    assert policy.budgets((16, 12), K) == (K, K)
    assert policy.budgets(None, K) is None
    for b in ((128, 32), (16, 12), (7,), (1000, 999, 10)):
        assert policy.budgets(b, K) == R.DegradePolicy().budgets(b, K)
    idx = make_index("cascade(flat,lpq4|r32)", corpus, device="cpu")
    sp = policy.params(SearchParams(budgets=(128,)), K)
    assert sp.budgets == (64,)
    res = idx.search(queries, K, sp)
    assert res.stats["stages"][-1][1] == 64
