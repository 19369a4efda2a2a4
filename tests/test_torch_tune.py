"""``repro_torch.tune`` against the reference's ``repro.tune`` on identical
inputs: the tuning space (the port's re-derived from its own kernel
layouts), tuner determinism under the injected cost-model timer, JSON and
saved-index round-trips (tables cross the two packages with equal
``table_hash``), stamp-mismatch adoption, tuned-vs-untuned dispatch
bit-parity, tile-query routing, plan-time table pinning, and the
maintenance scheduler's re-tune trigger.  Each test of
``tests/test_tune.py`` has its counterpart here, held to the reference
where both run; no test runs the reference's autotuner on fused
candidates (interpret mode is slow): its tables are built with
``TuneTable.put``.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro import engine as r_engine  # noqa: E402
from repro.data import synthetic  # noqa: E402
from repro.knn import make_index as r_make  # noqa: E402
from repro.runtime import profile as r_profile  # noqa: E402
from repro.tune import autotuner as r_AT  # noqa: E402
from repro.tune import space as r_S  # noqa: E402
from repro.tune import table as r_T  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.kernels import adc as A  # noqa: E402
from repro_torch.kernels import fused_topk as F  # noqa: E402
from repro_torch.kernels import ops as Kops  # noqa: E402
from repro_torch.knn import load_index, make_index  # noqa: E402
from repro_torch.runtime import MaintenanceScheduler  # noqa: E402
from repro_torch.runtime import profile as rtprofile  # noqa: E402
from repro_torch.tune import autotuner as AT  # noqa: E402
from repro_torch.tune import space as S  # noqa: E402
from repro_torch.tune import table as T  # noqa: E402
from repro_torch.tune.table import TuneConfig, TuneTable  # noqa: E402

K = 10


@pytest.fixture(autouse=True)
def clean_table_state():
    """Every test starts and ends with no installed / pending table in
    either package (the registered fallback rows stay)."""
    T.clear()
    r_T.clear()
    yield
    T.clear()
    r_T.clear()


@pytest.fixture(scope="module")
def corpus():
    c, _q, _m = synthetic.load("product", 3000, 8)
    return np.asarray(c[:, :16])


@pytest.fixture(scope="module")
def queries():
    _c, q, _m = synthetic.load("product", 64, 8)
    return np.asarray(q[:8, :16])


@pytest.fixture(scope="module")
def ref_flat(corpus, tmp_path_factory):
    """A reference-built flat,lpq8 index, saved untuned: (index, path)."""
    with r_T.pinned(None):
        idx = r_make("flat,lpq8", corpus, metric="ip")
        path = tmp_path_factory.mktemp("tune") / "flat.npz"
        idx.save(str(path))
    return idx, path


def _foreign_stamp() -> dict:
    """A stamp from a machine this process is not."""
    return {**T.live_stamp(), "backend": "tpu", "device_kind": "TPU v5e"}


def _tiny_table(entries=None, module=T) -> "TuneTable":
    t = module.TuneTable(stamp=module.live_stamp())
    for (kernel, metric, bits, q, n, d), cfg in (entries or {}).items():
        t.put(kernel, metric, bits, q, n, d, cfg)
    return t


def _both(entries: dict):
    """The same entries as a port table and as a reference table."""
    port = _tiny_table({k: TuneConfig(**v) for k, v in entries.items()})
    ref = _tiny_table({k: r_T.TuneConfig(**v) for k, v in entries.items()},
                      module=r_T)
    return port, ref


# --------------------------------------------------------------------------
# tuning space
# --------------------------------------------------------------------------

class TestSpace:
    def test_bucket_powers_of_two(self):
        xs = (1, 2, 3, 8, 9, 20480)
        assert [T.bucket(x) for x in xs] == [1, 2, 4, 8, 16, 32768]
        assert [T.bucket(x) for x in xs] == [r_T.bucket(x) for x in xs]
        k = lambda n: T.key_for("cpu", "cpu", "scan", "ip", 8, 8, n, 16)  # noqa: E731
        assert k(20000) == k(32768) != k(32769)
        for n in (20000, 32768, 32769):
            assert k(n) == r_T.key_for("cpu", "cpu", "scan", "ip", 8, 8, n, 16)
        assert T.split_key(T.key_for("cuda", "NVIDIA H100 80GB HBM3",
                                     "fused_adc", "l2", 4, 200, 5000, 64)) \
            == ("fused_adc", "l2", 4, 256, 8192, 64)

    def test_fused_candidates_are_legal(self):
        w = S.Workload("fused_topk", "ip", 8, q=64, n=8192, d=64)
        cands = S.candidates(w, "cuda")
        assert cands and all(c.impl == "fused" for c in cands)
        runs = set()
        for c in cands:
            assert c.bq in F.I8_BQ and c.bn >= F.I8_BM
            lay = S.kernel_layout(w, c)
            # ceil(n / bn) within the layout's cap: 2048 and 2k rows a split
            assert lay.splits == min(-(-w.n // c.bn),
                                     -(-w.n // max(2048, 2 * w.k))) <= 65535
            gbuf = lay.gbuf_keys > 0
            assert F.i8_smem_bytes(lay.bq, lay.cap, gbuf, 64) <= F.SMEM_MAX
            runs.add((lay.bq, lay.splits))
        assert len(runs) == len(cands)          # no layout listed twice
        assert {c.bq for c in cands} == set(F.I8_BQ)
        # an ip / l2 CUDA store always runs its kernel: no scan crossover
        assert S.default_config(w, "cuda") in cands
        # on the CPU, where the plain scan runs, the reference's ladder
        r_w = r_S.Workload("fused_topk", "ip", 8, q=64, n=8192, d=64)
        ref_scan = [c.chunk for c in r_S.candidates(r_w) if c.impl == "scan"]
        assert [c.chunk for c in S.candidates(w, "cpu")] == ref_scan

    @pytest.mark.parametrize("k", [100, 1500, 70_000, 10 ** 6])
    def test_tuned_splits_keep_the_k_cap(self, k):
        """A table entry's ``bn`` (keys carry no k) never gives more splits
        than the untuned layout's cap of 2048 and 2k rows a split, so a
        tuned plan's partial lists stay within the untuned bound at every
        over-fetch depth: the default entries of the main path's 4M-row
        bucket (33 splits at k=100) run 2 splits at k=10^6."""
        n, q = 4_000_000, 256
        cap = -(-n // max(2048, 2 * k))
        for w in AT.default_workloads():
            if w.kernel == "scan":
                continue
            at_k = dataclasses.replace(w, k=k)
            cfg = S.default_config(w, "cuda")          # measured at k=100
            for c in (cfg, dataclasses.replace(cfg, bn=F.I8_BM * 8)):
                tuned = S.kernel_layout(at_k, c)
                assert tuned.splits <= cap, (w, c, tuned)
                untuned = S.kernel_layout(at_k, TuneConfig("fused"))
                assert untuned.splits <= cap
        lay = F.layout(F.KIND_I8, q, n, 10 ** 6, 256, bq=32, bn=-(-n // 33))
        assert lay.splits == 2 and q * lay.splits * 10 ** 6 * 8 < 5e9
        a = A.adc_layout(10 ** 6, 32, 8, q, n, bq=8, bn=-(-n // 33))
        assert a.splits == 2

    def test_scan_family_has_no_fused_candidates(self):
        w = S.Workload("scan", "angular", 8, q=8, n=20480, d=32)
        r_w = r_S.Workload("scan", "angular", 8, q=8, n=20480, d=32)
        for backend in ("cuda", "cpu"):
            cands = S.candidates(w, backend)
            assert cands and all(c.impl == "scan" for c in cands)
            assert [c.chunk for c in cands] == [c.chunk
                                                for c in r_S.candidates(r_w)]
        assert any(c.chunk == S.round_up(20480, 8) for c in cands)

    def test_prune_keeps_default_and_drops_losers(self):
        w = S.Workload("scan", "angular", 8, q=8, n=20480, d=32)
        cands = S.candidates(w)
        keep = TuneConfig("scan", chunk=S.DEFAULT_CHUNK)
        pruned = S.prune(w, cands, keep=keep)
        assert keep in pruned
        assert set(pruned) <= set(cands) | {keep}
        best = min(S.estimate(w, c) for c in cands)
        for c in pruned:
            if c != keep:
                assert S.estimate(w, c) <= 4.0 * best
        # the same chunks survive as in the reference's model (memory-bound
        # on both: the pad rows decide)
        r_w = r_S.Workload("scan", "angular", 8, q=8, n=20480, d=32)
        r_keep = r_T.TuneConfig("scan", chunk=r_S.DEFAULT_CHUNK)
        r_pruned = r_S.prune(r_w, r_S.candidates(r_w), keep=r_keep)
        assert sorted(c.chunk for c in pruned) == sorted(c.chunk
                                                         for c in r_pruned)

    def test_vmem_budget_excludes_oversize_tiles(self):
        # the port's budget is the card's shared memory: a row too wide
        # for 8 resident queries has no legal layout at all
        w = S.Workload("fused_topk", "ip", 8, q=64, n=8192, d=65536)
        assert S.candidates(w, "cuda") == []
        with pytest.raises(ValueError, match="shared memory|too wide"):
            S.kernel_layout(w, TuneConfig("fused", bq=8))


# --------------------------------------------------------------------------
# tuner determinism + persistence round-trips
# --------------------------------------------------------------------------

WORKLOADS = (S.Workload("scan", "angular", 8, q=4, n=3000, d=16, k=K),)


class TestTunerAndRoundTrips:
    def test_tuner_is_deterministic(self):
        """Same backend + seed + timer => bit-identical tables, and the same
        dispatch (table_hash) as the reference's tuner on the same
        workloads."""
        a = AT.autotune(WORKLOADS, seed=0, timer=AT.estimate_timer,
                        device="cpu")
        b = AT.autotune(WORKLOADS, seed=0, timer=AT.estimate_timer,
                        device="cpu")
        assert a.to_dict() == b.to_dict()
        assert a.table_hash() == b.table_hash()
        r_w = tuple(r_S.Workload(w.kernel, w.metric, w.bits, w.q, w.n, w.d,
                                 w.k) for w in WORKLOADS)
        ref = r_AT.autotune(r_w, seed=0, timer=r_AT.estimate_timer)
        assert a.table_hash() == ref.table_hash()
        assert sorted(a.entries) == sorted(ref.entries)

    def test_parity_rejects_a_row_returned_twice(self):
        """The tie-robust parity rule also refuses a result that returns one
        row twice, which a tile scanned by two splits gives and a tie
        would otherwise hide."""
        full = torch.tensor([[5.0, 5.0, 3.0, 1.0], [2.0, 7.0, 7.0, 7.0]])
        ctx = AT._Ctx(None, None, None, full, torch.tensor([[5.0, 5.0],
                                                            [7.0, 7.0]]))
        s = ctx.top.clone()
        assert AT._parity_ok(ctx, s, torch.tensor([[0, 1], [3, 2]]))
        assert AT._parity_ok(ctx, s, torch.tensor([[1, 0], [1, 3]]))
        assert not AT._parity_ok(ctx, s, torch.tensor([[0, 0], [1, 2]]))
        assert not AT._parity_ok(ctx, s, torch.tensor([[0, 1], [2, 2]]))
        assert not AT._parity_ok(ctx, s, torch.tensor([[0, 2], [1, 2]]))

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_json_round_trip_bit_exact(self, tmp_path, writer):
        """A table written by either package reads in both with the same
        dict and table_hash."""
        port, ref = _both({("scan", "angular", 8, 4, 3000, 16):
                           dict(impl="scan", chunk=2048, measured_us=3.5),
                           ("fused_topk", "ip", 8, 256, 4_000_000, 256):
                           dict(impl="fused", bq=16, bn=131072,
                                default_us=6.1)})
        table = port if writer == "port" else ref
        p = tmp_path / "TUNE.json"
        table.to_json(p)
        back = TuneTable.from_json(p)
        r_back = r_T.TuneTable.from_json(p)
        assert back.to_dict() == table.to_dict() == r_back.to_dict()
        assert (back.table_hash() == r_back.table_hash()
                == port.table_hash() == ref.table_hash())
        # both packages' CPU stamps agree, so each adopts the other's table
        assert back.matches() and r_back.matches()

    def test_json_version_gate(self):
        doc = _tiny_table().to_dict()
        doc["version"] = 99
        with pytest.raises(ValueError, match="version"):
            TuneTable.from_dict(doc)
        with pytest.raises(ValueError, match="version"):
            r_T.TuneTable.from_dict(doc)

    def test_hash_ignores_timings_but_not_dispatch(self):
        key = ("scan", "angular", 8, 8, 3000, 16)
        a = _tiny_table({key: TuneConfig("scan", chunk=1024,
                                         measured_us=1.0)})
        b = _tiny_table({key: TuneConfig("scan", chunk=1024,
                                         measured_us=99.0)})
        c = _tiny_table({key: TuneConfig("scan", chunk=2048,
                                         measured_us=1.0)})
        assert a.table_hash() == b.table_hash() != c.table_hash()
        ref = _tiny_table({key: r_T.TuneConfig("scan", chunk=1024,
                                               measured_us=7.0)}, module=r_T)
        assert ref.table_hash() == a.table_hash()

    def test_npz_round_trip_via_saved_index(self, tmp_path, corpus):
        table = _tiny_table({("scan", "ip", 8, 8, 3000, 16):
                             TuneConfig("scan", chunk=1024,
                                        measured_us=12.5)})
        T.install(table)
        idx = make_index("flat,lpq8", corpus, metric="ip", device="cpu")
        path = tmp_path / "idx.npz"
        idx.save(str(path))

        T.clear()
        assert T.active() is None
        before = T.COUNTERS["tune_adopted"]
        idx2 = load_index(str(path), device="cpu")
        assert T.COUNTERS["tune_adopted"] == before + 1
        assert T.active() is not None
        assert T.active().to_dict() == table.to_dict()
        assert idx2.n == idx.n
        # the reference reads the port's npz and adopts the same table
        from repro.knn.registry import load_index as r_load

        r_load(str(path))
        assert r_T.active().table_hash() == table.table_hash()

    def test_stamp_mismatch_parks_not_crashes(self, tmp_path, corpus):
        """A table measured on a foreign backend is parked for the
        maintenance re-tune trigger; dispatch keeps its configs."""
        foreign = TuneTable(stamp=_foreign_stamp())
        foreign.put("scan", "ip", 8, 8, 3000, 16,
                    TuneConfig("scan", chunk=1024))
        before = T.COUNTERS["tune_adopt_mismatch"]
        assert T.adopt(foreign) is False
        assert T.COUNTERS["tune_adopt_mismatch"] == before + 1
        assert T.active() is None                      # not installed
        assert T.pending_mismatch() is foreign         # parked

        # the same protocol through a saved index
        T.clear()
        T.install(foreign)      # force the foreign table into the save
        idx = make_index("flat,lpq8", corpus, metric="ip", device="cpu")
        path = tmp_path / "idx.npz"
        idx.save(str(path))
        T.clear()
        load_index(str(path), device="cpu")
        assert T.active() is None
        assert T.pending_mismatch() is not None

    def test_stamp_integration(self):
        """runtime.profile.stamp() reports the active table's hash."""
        assert rtprofile.stamp()["tune_table"] is None
        table = _tiny_table({("scan", "ip", 8, 8, 3000, 16):
                             TuneConfig("scan", chunk=1024)})
        T.install(table)
        assert rtprofile.stamp()["tune_table"] == table.table_hash()
        s = rtprofile.stamp()
        r = r_profile.stamp()
        for k in T.STAMP_KEYS:
            assert s[k] == r[k], k


# --------------------------------------------------------------------------
# dispatch integration
# --------------------------------------------------------------------------

class TestDispatch:
    def test_tuned_scan_is_bit_identical(self, ref_flat, queries):
        ref_idx, path = ref_flat
        idx = load_index(str(path), device="cpu")
        s0, i0, st0 = engine.topk(queries, idx.store, K, "ip")
        assert st0["tuned"] is False

        entry = ("fused_topk", "ip", 8, len(queries), idx.store.n, 16)
        port, ref = _both({entry: dict(impl="scan", chunk=1024)})
        with T.pinned(port):
            s1, i1, st1 = engine.topk(queries, idx.store, K, "ip")
        with r_T.pinned(ref):
            rs1, ri1, rst1 = r_engine.topk(queries, ref_idx.store, K, "ip")
        assert st1["tuned"] is True
        assert st1["chunks"] > st0["chunks"]           # config really used
        assert torch.equal(s0, s1) and torch.equal(i0, i1)
        np.testing.assert_array_equal(s1.numpy(), np.asarray(rs1))
        np.testing.assert_array_equal(i1.numpy(), np.asarray(ri1))
        for key in ("tuned", "chunks", "bytes_read", "candidates"):
            assert st1[key] == rst1[key], key

    def test_tile_query_routing(self):
        # the fallback rows name the implementation only: untuned, the
        # layouts answer
        for fam in T.FUSED_FAMILIES:
            assert T.fallback(fam) == TuneConfig("fused")
        assert T.fallback("scan") == TuneConfig("scan")
        assert Kops.fused_query_tile(64, 8192, 64) == \
            F.layout(F.KIND_I8, 64, 8192, 100, 64).bq
        assert Kops.fused_query_tile(256, 8192, 256, packed=True, bits=4,
                                     k=1500) == \
            F.layout(F.KIND_I4, 256, 8192, 1500, 128).bq
        assert Kops.fused_adc_query_tile(256, 8192, 64, bits=4) == \
            A.adc_layout(100, 32, 4, 256, 8192).bq
        table = _tiny_table({("fused_topk", "ip", 8, 64, 8192, 64):
                             TuneConfig("fused", bq=16, bn=4096),
                             ("fused_adc", "ip", 8, 64, 8192, 32):
                             TuneConfig("fused", bq=4, bn=4096)})
        T.install(table)
        assert Kops.fused_query_tile(64, 8192, 64, metric="ip", bits=8) == 16
        assert Kops.fused_adc_query_tile(64, 8192, 32, metric="ip") == 4
        # a bucket the table never measured -> today's layouts
        assert Kops.fused_query_tile(64, 8192, 128, metric="ip",
                                     bits=8) == \
            F.layout(F.KIND_I8, 64, 8192, 100, 128).bq
        assert Kops.fused_adc_query_tile(64, 8192, 16) == \
            A.query_tile(100, 16, 8, 64)
        # the reference routes the same table the same way
        r_table = r_T.TuneTable.from_dict(table.to_dict())
        r_T.install(r_table)
        from repro.kernels import ops as r_ops

        assert r_ops.fused_query_tile(64, 8192, 64, metric="ip", bits=8) == 16
        assert r_ops.fused_adc_query_tile(64, 8192, 32, metric="ip") == 4

    def test_lookup_counters(self):
        table = _tiny_table({("scan", "ip", 8, 8, 3000, 16):
                             TuneConfig("scan", chunk=1024)})
        T.install(table)
        hits, misses = (T.COUNTERS["tune_lookup_hit"],
                        T.COUNTERS["tune_lookup_miss"])
        assert T.lookup("scan", "ip", 8, 8, 3000, 16) is not None
        assert T.lookup("scan", "l2", 8, 8, 3000, 16) is None
        assert T.COUNTERS["tune_lookup_hit"] == hits + 1
        assert T.COUNTERS["tune_lookup_miss"] == misses + 1

    def test_searcher_pins_table_at_plan_time(self, ref_flat, queries):
        """A plan freezes the table active at construction; installing or
        clearing afterwards cannot change it."""
        _ref_idx, path = ref_flat
        idx = load_index(str(path), device="cpu", adopt_tune=False)
        table = _tiny_table({("fused_topk", "ip", 8,
                              T.bucket(len(queries)), idx.store.n, 16):
                             TuneConfig("scan", chunk=1024)})
        T.install(table)
        searcher = idx.searcher(K, batch_sizes=(len(queries),))
        T.clear()                                      # after plan time
        res = searcher(queries)
        assert res.stats["tuned"] is True
        assert res.stats["chunks"] == -(-idx.store.n // 1024)

        # and the inverse: a plan made untuned stays untuned
        untuned = idx.searcher(K, batch_sizes=(len(queries),))
        T.install(table)
        res2 = untuned(queries)
        assert res2.stats["tuned"] is False
        assert torch.equal(res.ids, res2.ids)
        assert torch.equal(res.scores, res2.scores)
        # the pin is the running thread's: the installed table is untouched
        assert T.active() is table

    def test_cuda_tables_refuse_what_the_card_cannot_run(self):
        """A cuda table may not send an ip / l2 fused family to the scan,
        nor name a block no kernel has; the layouts refuse illegal
        overrides."""
        stamp = {**T.live_stamp(), "backend": "cuda",
                 "device_kind": "NVIDIA H100 80GB HBM3", "interpret": False}
        scan = TuneTable(stamp=stamp)
        scan.put("fused_topk", "ip", 8, 256, 4_000_000, 256,
                 TuneConfig("scan", chunk=16384))
        with pytest.raises(ValueError, match="scan"):
            T.install(scan)
        with pytest.raises(ValueError, match="scan"):
            T.adopt(scan)
        assert T.active() is None and T.pending_mismatch() is None
        wide = TuneTable(stamp=stamp)
        wide.put("fused_adc", "l2", 8, 256, 4_000_000, 32,
                 TuneConfig("fused", bq=32, bn=1 << 17))
        with pytest.raises(ValueError, match="bq=32"):
            T.adopt(wide)
        ok = TuneTable(stamp=stamp)
        ok.put("scan", "angular", 8, 256, 4_000_000, 100,
               TuneConfig("scan", chunk=4096))
        ok.put("packed", "ip", 4, 256, 4_000_000, 256,
               TuneConfig("fused", bq=8, bn=1 << 17))
        assert T.adopt(ok) is False                    # parked: not a card
        for bad in (dict(bq=64), dict(bn=16), dict(bn=1)):
            with pytest.raises(ValueError, match="layout"):
                F.layout(F.KIND_I8, 256, 4_000_000, 100, 256, **bad)
        with pytest.raises(ValueError, match="layout"):
            F.layout(F.KIND_F32, 256, 4_000_000, 100, 256, bq=16)
        with pytest.raises(ValueError, match="65535"):
            F.layout(F.KIND_I8, 256, 10 ** 8, 100, 256, bn=1024)
        with pytest.raises(ValueError, match="layout"):
            A.adc_layout(100, 32, 8, 256, 4_000_000, bq=16)
        with pytest.raises(ValueError, match="gather"):
            A.adc_layout(100, 1000, 4, 256, 4_000_000, bq=8)

    def test_default_config_is_todays_layout(self):
        """``default_config`` spells out the layout dispatch runs without a
        table, at every main-path workload."""
        for w in AT.default_workloads():
            cfg = S.default_config(w, "cuda")
            if w.kernel == "scan":
                assert cfg == TuneConfig("scan", chunk=16384)
                continue
            k = min(w.k, w.n)
            if w.kernel == "fused_adc":
                today = A.adc_layout(k, S.row_bytes(w), w.bits, w.q, w.n)
            else:
                today = F.layout(S.fused_kind(w), w.q, w.n, k, S.row_bytes(w))
            assert S.kernel_layout(w, cfg) == today
            assert cfg in S.candidates(w, "cuda")
        assert S.default_config(AT.default_workloads()[0], "cpu") == \
            TuneConfig("scan", chunk=16384)

    def test_pq_stats_follow_the_reference_under_a_table(self, corpus,
                                                         queries, tmp_path):
        with r_T.pinned(None):
            ref = r_make("pq4+lpq", corpus, metric="ip", kmeans_iters=2,
                         key=jax.random.PRNGKey(0))
            path = tmp_path / "pq.npz"
            ref.save(str(path))
        idx = load_index(str(path), device="cpu", adopt_tune=False)
        entry = ("fused_adc", "ip", 8, len(queries), 3000, 4)
        port, r_table = _both({entry: dict(impl="scan", chunk=512)})
        with T.pinned(port):
            s, i, st = engine.topk(torch.from_numpy(queries.copy()), idx.store, K,
                                   "ip")
        with r_T.pinned(r_table):
            rs, ri, rst = r_engine.topk(queries, ref.store, K, "ip")
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        assert st["tuned"] is True and st["chunks"] == 6
        for key in ("tuned", "chunks", "bytes_read"):
            assert st[key] == rst[key], key


# --------------------------------------------------------------------------
# maintenance re-tune trigger
# --------------------------------------------------------------------------

class TestMaintenanceRetune:
    def test_pending_mismatch_triggers_retune(self, corpus):
        idx = make_index("stream(flat,lpq8)", corpus, metric="ip",
                         device="cpu")
        fresh = _tiny_table({("scan", "ip", 8, 8, 3000, 16):
                             TuneConfig("scan", chunk=1024)})
        sched = MaintenanceScheduler(idx, retune_fn=lambda: fresh)

        assert sched.run_once() == {"ran": False}      # nothing pending

        T.adopt(TuneTable(stamp=_foreign_stamp()))     # parks
        out = sched.run_once()
        assert out["trigger"] == "tune" and out["swapped"] is True
        assert out["table_hash"] == fresh.table_hash()
        assert sched.counters["maintenance_retunes"] == 1
        assert T.active() is fresh                     # re-tune installed
        assert T.pending_mismatch() is None            # pending consumed
        assert sched.run_once() == {"ran": False}      # trigger cleared

    def test_no_retune_fn_means_no_trigger(self, corpus):
        idx = make_index("stream(flat,lpq8)", corpus, metric="ip",
                         device="cpu")
        sched = MaintenanceScheduler(idx)
        T.adopt(TuneTable(stamp=_foreign_stamp()))
        assert sched.run_once() == {"ran": False}
