"""ANN serving loop on the production runtime subsystem (port of
``repro.launch.serve``; DESIGN.md §9 request path, §12 runtime
architecture).

The index is chosen by a FAISS-style factory string and built through
``repro_torch.knn.make_index``; the serving session is a single
``index.searcher(k, params, batch_sizes=...)`` plan, bucketed by batch
size, that a request queue drains.  Around it, ``repro_torch.runtime``
supplies the production machinery:

  * ``--profile`` — a named :mod:`repro_torch.runtime.profile` resolved
    and applied at process start (platform, host devices, NaN debug,
    deterministic seed) and stamped into the report/telemetry.  With no
    profile the session runs on the card and raises where there is none;
    ``--profile ci-cpu`` (or ``cpu-dev`` / ``cpu-mesh4``) runs it on the
    CPU, ``--profile cuda-serve`` on the card.
  * ``--cache`` — the hot-path result tier: repeated query batches are
    served bit-identically from an LRU+TTL cache keyed on query
    fingerprint + replan generation (``--hot-repeat`` replays the first
    request every Nth request to exercise it).
  * ``--admission`` — token-bucket admission with a bounded queue and
    the degrade/shed ladder: over-budget requests run a **degraded
    plan** (shallower rerank, smaller nprobe/ef) before being shed;
    ``--deadline-ms`` propagates per-request deadlines that are
    re-checked at dequeue against the observed latency EMA.
  * ``--maintenance`` — a background scheduler runs stream-index
    compaction and drift recalibration off the request path
    (snapshot -> off-lock build -> atomic manifest swap), so a
    ``compact()`` never blocks a query.
  * ``--telemetry-out`` — the structured event log (per-request
    queue-wait/execute spans, shared cache/admission counters) as JSON.
  * ``--tune`` / ``--index-path`` / ``--save-index`` — measured-dispatch
    plumbing (DESIGN.md §13): adopt a standalone TuneTable JSON, load a
    saved index (its embedded table adopted, stamp-checked), or save the
    served index with the active table embedded.  The runtime stamp is
    taken *after* adoption so the report/telemetry records the tuning
    hash the session actually dispatched through; a foreign-backend
    table parks as a pending mismatch that the maintenance scheduler's
    lowest-priority trigger re-measures off the request path.

Mutable (``stream(...)``) indexes serve writes too: ``--mutate``
interleaves an upsert and a delete into the request mix.  A Searcher is
a snapshot plan (LSM readers pin a manifest version, DESIGN.md §10), so
a write re-plans the session — **unless the mutation left the manifest
epoch unchanged** (no-op delete, memtable-only upsert below the seal
threshold): those skip the re-plan and are counted as
``replans_avoided``; under snapshot semantics the write simply becomes
visible at the next structural re-plan.

A request's latency includes its device work: a result on the card is
waited for (``torch.cuda.synchronize``) before the clock stops, as the
reference blocks on its arrays; a result-cache hit launched nothing and
waits for nothing.

    PYTHONPATH=src python -m repro_torch.launch.serve --profile cuda-serve \
        --index flat,lpq4+r32 --requests 4
    PYTHONPATH=src python -m repro_torch.launch.serve --index flat,lpq8 \
        --profile ci-cpu --n 2048 --d 32 --cache 64 --hot-repeat 2
    PYTHONPATH=src python -m repro_torch.launch.serve --profile cuda-serve \
        --index "stream(flat,lpq4)+r32" --requests 8 --mutate \
        --admission --max-queue 6 --maintenance \
        --telemetry-out TELEMETRY_serve.json
"""

from __future__ import annotations

import argparse
import collections
import time

import numpy as np
import torch

from repro_torch.runtime import profile as rtprofile

#: stats keys summed across requests and reported as per-request means
_AGG_KEYS = ("candidates", "bytes_read", "chunks", "padded_q", "reranked",
             "merge_wire_bytes")


def _request_sizes(n_requests: int, batch: int, mixed: bool) -> list[int]:
    """Per-request query counts: fixed ``batch``, or a mixed cycle that
    exercises several buckets (the realistic open-loop traffic shape)."""
    if not mixed:
        return [batch] * n_requests
    cycle = [1, max(1, batch // 4), batch]
    return [cycle[i % len(cycle)] for i in range(n_requests)]


def _parse_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", default="flat,lpq8@gaussian:3",
                    help="factory string, e.g. flat,lpq4+r32 / ivf64,lpq8 / "
                         "hnsw32,lpq8 / graph24,lpq8 / pq8+lpq")
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--nprobe", type=int, default=8)
    ap.add_argument("--ef-search", type=int, default=100)
    ap.add_argument("--chunk", type=int, default=16384)
    ap.add_argument("--batch-sizes", default=None,
                    help="comma-separated batch buckets (default 1,8,32,256 "
                         "clipped to --batch)")
    ap.add_argument("--shards", type=int, default=0,
                    help="shard every plan kind over this many devices "
                         "(rows/lists/segments placement; 0 = unsharded)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel serving replicas behind per-replica "
                         "queues; with --shards the host's devices split "
                         "into this many disjoint sub-meshes "
                         "(dist.submeshes), one per replica")
    ap.add_argument("--rerank-depth", type=int, default=0,
                    help="override the rerank candidate depth (0 = the "
                         "index's default when built with +rN)")
    ap.add_argument("--filter-col", default=None,
                    help="serve every query under a metadata predicate "
                         "(DESIGN.md §16): synthesize a per-row integer "
                         "column with this name and keep only rows whose "
                         "value matches --filter-value")
    ap.add_argument("--filter-value", default="0",
                    help="allowed value(s) for --filter-col, "
                         "comma-separated (e.g. '3' or '1,4,6')")
    ap.add_argument("--filter-cats", type=int, default=8,
                    help="cardinality of the synthesized --filter-col "
                         "column (selectivity = |values| / cats)")
    ap.add_argument("--mixed", action="store_true",
                    help="cycle request sizes through several buckets")
    ap.add_argument("--mutate", action="store_true",
                    help="interleave an upsert and a delete request into "
                         "the traffic (stream(...) indexes only)")
    # -- runtime subsystem flags (DESIGN.md §12) ---------------------------
    ap.add_argument("--profile", default=None,
                    help="named runtime profile (default: "
                         "$REPRO_RUNTIME_PROFILE or 'default'); see "
                         "repro_torch.runtime.profile.PROFILES")
    ap.add_argument("--profile-file", default=None,
                    help="load the runtime profile from a JSON file "
                         "(RuntimeProfile.to_dict() format) instead of "
                         "the named registry; overrides --profile")
    ap.add_argument("--budgets", default=None,
                    help="explicit cascade stage budgets, comma-separated "
                         "(e.g. '128,32' for cascade(pq16x4|lpq8|r32)); "
                         "cascade indexes only — validated at plan time")
    ap.add_argument("--cache", type=int, default=0,
                    help="result-cache capacity in entries (0 = off)")
    ap.add_argument("--cache-ttl", type=float, default=0.0,
                    help="result-cache TTL seconds (0 = no TTL)")
    ap.add_argument("--hot-repeat", type=int, default=0,
                    help="replay the first request every Nth request "
                         "(hot-query traffic shape; exercises the cache)")
    ap.add_argument("--admission", action="store_true",
                    help="enable token-bucket admission control with the "
                         "degrade/shed ladder")
    ap.add_argument("--rate", type=float, default=256.0,
                    help="admission token rate, tokens(=queries)/s")
    ap.add_argument("--burst", type=float, default=0.0,
                    help="admission bucket burst (default 8 * batch)")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="hard backlog bound; arrivals beyond it are shed")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request deadline budget (0 = none); blown "
                         "deadlines shed, tight ones degrade")
    ap.add_argument("--maintenance", action="store_true",
                    help="run stream compaction/recalibration on a "
                         "background scheduler (off the request path)")
    ap.add_argument("--maintenance-interval", type=float, default=0.05,
                    help="background maintenance poll interval, seconds")
    ap.add_argument("--telemetry-out", default=None,
                    help="write the structured telemetry JSON here")
    # -- measured-dispatch (TuneTable) flags (DESIGN.md §13) ---------------
    ap.add_argument("--tune", default=None,
                    help="adopt a standalone TuneTable JSON (e.g. "
                         "TUNE.json) before planning; stamp-checked — "
                         "a foreign-backend table is parked for the "
                         "maintenance re-tune trigger, not crashed on")
    ap.add_argument("--index-path", default=None,
                    help="load a saved .npz index instead of building "
                         "(--index/--n/--d then come from the file; an "
                         "embedded TuneTable is adopted, stamp-checked)")
    ap.add_argument("--save-index", default=None,
                    help="save the served index to this .npz after build "
                         "(the active TuneTable rides along embedded)")
    return ap.parse_args(argv)


def _index_dim(index) -> int | None:
    """Logical query dimension of a loaded index (any kind)."""
    store = getattr(index, "store", None)
    if store is None:
        return None
    if hasattr(store, "d"):
        return int(store.d)
    # PQStore: m subspaces x ds dims per codebook
    return int(store.m * store.codebooks.shape[-1])


def _ready(res):
    """Wait for a result's device work (the reference's
    ``jax.block_until_ready``): a result on the card synchronises its
    device; a CPU result is ready; a result-cache hit holds tensors an
    earlier, already waited-for request made, and waits for nothing."""
    if res.stats.get("cache") != "hit" and res.ids.is_cuda:
        torch.cuda.synchronize(res.ids.device)
    return res


def main(argv: list[str] | None = None) -> None:
    args = _parse_args(argv)

    # profile first: the platform and host devices are process-start state
    prof = rtprofile.apply(
        rtprofile.from_file(args.profile_file) if args.profile_file
        else rtprofile.resolve(args.profile)
    )

    from repro_torch.data import synthetic
    from repro_torch.dist.sharding import default_devices, make_mesh
    from repro_torch.knn import SearchParams, make_index
    from repro_torch.runtime import (
        SHED,
        AdmissionController,
        CachedSearcher,
        MaintenanceScheduler,
        Telemetry,
        TTLLRUCache,
    )

    # -- measured dispatch: adopt tables BEFORE stamping, so the stamp
    # (and therefore the telemetry report + trend comparability key)
    # records the tuning the session actually serves through
    from repro_torch.knn import registry as knn_registry
    from repro_torch.tune import table as tunetable

    if args.tune:
        tunetable.adopt(tunetable.TuneTable.from_json(args.tune))

    index = None
    build_s = 0.0
    if args.index_path:
        t0 = time.perf_counter()
        index = knn_registry.load_index(args.index_path)  # adopts any
        build_s = time.perf_counter() - t0                # embedded table
        args.index = f"loaded:{args.index_path}"
        args.n = index.n
        args.d = _index_dim(index) or args.d

    stamp = rtprofile.stamp(prof)
    telemetry = Telemetry(meta={
        "runtime": stamp,
        "index": args.index, "n": args.n, "d": args.d, "k": args.k,
        "batch": args.batch, "requests": args.requests,
        "mutate": bool(args.mutate), "admission": bool(args.admission),
        "cache": args.cache, "maintenance": bool(args.maintenance),
    })
    print(f"[serve] profile={prof.name} backend={stamp['backend']} "
          f"device={stamp['device_kind']} x{stamp['n_devices']} "
          f"interpret={stamp['interpret']} seed={prof.seed}")
    pend = tunetable.pending_mismatch()
    print(f"[serve] tune: table={stamp['tune_table'] or 'none'}"
          + (f" pending_mismatch={pend.table_hash()}" if pend is not None
             else ""))

    sizes = _request_sizes(args.requests, args.batch, args.mixed)
    n_extra = 8 if args.mutate else 0
    corpus, queries, _metric = synthetic.load(
        "product", args.n + n_extra, sum(sizes)
    )
    corpus = corpus[:, : args.d].contiguous()
    queries = queries[:, : args.d].contiguous()
    corpus, extra_rows = corpus[: args.n], corpus[args.n:]

    if index is None:
        t0 = time.perf_counter()
        # the port's builders take the profile's seed as their key (an
        # int; a stream build reads s as the reference's PRNGKey(s))
        index = make_index(args.index, corpus, key=prof.seed)
        build_s = time.perf_counter() - t0
    if args.save_index:
        index.save(args.save_index)   # active TuneTable embeds via save_state
        print(f"[serve] saved index -> {args.save_index} "
              f"(tune={tunetable.active_hash() or 'none'})")

    # metadata predicate (DESIGN.md §16): a deterministic synthetic
    # column stands in for real per-row metadata; the bitmap rides
    # SearchParams into every plan (external-id space, so stream upserts
    # beyond the horizon pass until the column is extended)
    filt = None
    if args.filter_col:
        import zlib

        from repro_torch.filter import Filter

        col = np.random.default_rng(
            zlib.crc32(args.filter_col.encode())
        ).integers(0, args.filter_cats, args.n)
        vals = sorted({int(v) for v in args.filter_value.split(",")})
        filt = Filter.from_column(col, vals)
        telemetry.counters["filter_allowed_rows"] = int(filt.count)
        telemetry.counters["filter_selectivity_permille"] = int(
            round(filt.selectivity * 1000)
        )
        telemetry.meta["filter"] = {
            "col": args.filter_col, "values": vals,
            "cats": args.filter_cats,
            "selectivity": round(filt.selectivity, 6),
        }
        print(f"[serve] filter: col={args.filter_col} values={vals} "
              f"selectivity={filt.selectivity:.3f} "
              f"({filt.count}/{args.n} rows allowed)")

    budgets = (tuple(int(b) for b in args.budgets.split(","))
               if args.budgets else None)
    sp = SearchParams(chunk=args.chunk, nprobe=args.nprobe,
                      ef_search=args.ef_search, budgets=budgets,
                      filter=filt)
    if args.batch_sizes:
        buckets = tuple(sorted(int(b) for b in args.batch_sizes.split(",")))
    else:
        buckets = tuple(b for b in (1, 8, 32, 256) if b <= args.batch) or (args.batch,)
        if buckets[-1] < args.batch:
            buckets = buckets + (args.batch,)

    mesh = None
    replica_meshes = None
    n_replicas = max(1, args.replicas)
    if n_replicas > 1:
        if args.shards > 1 and len(default_devices()) > 1:
            # each replica shards over its own disjoint sub-mesh, so
            # R x S never oversubscribes a device
            from repro_torch.dist.replica import submeshes

            groups = submeshes(n_replicas)
            n_replicas = len(groups)
            per = int(groups[0].devices.size)
            if per > 1:
                if args.shards > per:
                    print(f"[serve] --shards {args.shards} > {per} devices "
                          f"per replica group; using {per}")
                replica_meshes = groups
            else:
                print(f"[serve] {per} device per replica group — each "
                      "replica serves unsharded")
                replica_meshes = [None] * n_replicas
        else:
            # CPU-thread replicas sharing the device pool
            replica_meshes = [None] * n_replicas
    elif args.shards > 1:
        devices = default_devices()
        n_dev = len(devices)
        if args.shards > n_dev:
            print(f"[serve] --shards {args.shards} > {n_dev} devices; "
                  f"using {n_dev} (pick a profile with host_device_count, "
                  "e.g. --profile cpu-mesh4, for more)")
        if min(args.shards, n_dev) > 1:
            n_mesh = min(args.shards, n_dev)
            mesh = make_mesh((n_mesh,), ("data",), devices=devices[:n_mesh])
        else:
            print("[serve] 1 device available — serving unsharded (a "
                  "1-shard mesh would be the degenerate merge formulation)")

    if args.mutate and not hasattr(index, "upsert"):
        raise SystemExit(
            f"--mutate needs a mutable index; {args.index!r} is {index.kind!r}"
            " — wrap it: stream(" + args.index + ")"
        )
    if args.maintenance and not hasattr(index, "compact_snapshot"):
        raise SystemExit(
            f"--maintenance needs a mutable (stream) index; {args.index!r} "
            f"is {index.kind!r}"
        )

    # -- admission + degrade ladder ---------------------------------------
    ctrl = None
    if args.admission:
        ctrl = AdmissionController(
            rate_qps=args.rate,
            burst=args.burst or 8.0 * args.batch,
            max_queue=args.max_queue,
            counters=telemetry.counters,
        )

    # warmup: run every distinct request size once through both plans —
    # each bucket the traffic will hit (incl. remainder-slice buckets of
    # oversize requests, cf. Searcher.buckets_for) and the per-shape
    # pad/slice glue, so the timed percentiles measure serving.  Warmup
    # goes through the raw searchers: the cache must not be pre-populated.
    def warm(primary, degraded):
        for sz in sorted(set(sizes)):
            _ready(primary(queries[:sz]))
            if degraded is not None:
                _ready(degraded(queries[:sz]))

    def make_searchers(shard_mesh=mesh):
        primary = index.searcher(
            args.k, sp, batch_sizes=buckets, shards=shard_mesh,
            rerank=args.rerank_depth or None,
        )
        degraded = None
        if ctrl is not None:
            d_depth = ctrl.policy.rerank_depth(
                primary.rerank.depth if primary.rerank else 0, args.k
            )
            # params(sp, k) also shrinks cascade stage budgets (floor k)
            degraded = index.searcher(
                args.k, ctrl.policy.params(sp, args.k), batch_sizes=buckets,
                shards=shard_mesh, rerank=(d_depth or False),
            )
        return primary, degraded

    # -- result cache tier -------------------------------------------------
    cache = None
    replan_gen = [0]                 # replan generation feeds cache keys
    if args.cache:
        cache = TTLLRUCache(args.cache, ttl_s=args.cache_ttl or None)

    def wrap(s, c=None):
        c = cache if c is None else c
        if s is None or c is None:
            return s
        return CachedSearcher(s, c, version=lambda: replan_gen[0])

    # -- replica group (dist.replica): R independent serving replicas ------
    replicas = None
    searcher = searcher_deg = serve_primary = serve_deg = None
    if n_replicas > 1:
        from repro_torch.dist.replica import ReplicaSet

        replica_primaries: dict = {}

        def make_replica(r):
            primary, degraded = make_searchers(replica_meshes[r])
            replica_primaries[r] = primary
            # the result cache is per replica (TTLLRUCache is not
            # thread-safe; replica workers are threads)
            rc = (TTLLRUCache(args.cache, ttl_s=args.cache_ttl or None)
                  if args.cache else None)
            sx_p, sx_d = wrap(primary, rc), wrap(degraded, rc)
            # warm every bucket inside the build so worker threads never
            # pay a first run on the request path
            warm(primary, degraded)

            def run(item):
                payload, use_deg = item
                return _ready((sx_d if use_deg else sx_p)(payload))

            return run

        replicas = ReplicaSet(make_replica, n_replicas,
                              max_queue=args.max_queue, telemetry=telemetry)
        head = replica_primaries[0]
    else:
        searcher, searcher_deg = make_searchers()
        serve_primary, serve_deg = wrap(searcher), wrap(searcher_deg)
        head = searcher

    print(f"[serve] index={args.index} kind={index.kind} build={build_s:.2f}s "
          f"memory={index.memory_bytes() / 1e6:.1f}MB buckets={buckets} "
          f"shards={head.n_shards} replicas={n_replicas} "
          f"rerank={head.rerank.depth if head.rerank else 0}"
          + (f" degraded_rerank="
             f"{searcher_deg.rerank.depth if searcher_deg and searcher_deg.rerank else 0}"
             if searcher_deg else ""))

    # placement accounting (DESIGN.md §15): what each shard holds
    if head.placement is not None:
        psum = head.placement.summary()
        row_bytes = getattr(getattr(index, "store", None), "row_bytes", None)
        if row_bytes:
            psum["shard_bytes"] = list(head.placement.shard_bytes(row_bytes))
        telemetry.meta["placement"] = psum
        print(f"[serve] placement: kind={psum['kind']} "
              f"shards={psum['n_shards']} units={psum['n_units']} "
              f"balance={psum['balance']}"
              + (f" shard_bytes={psum['shard_bytes']}"
                 if "shard_bytes" in psum else ""))

    # request queue (open loop: all arrivals enqueued up front); with
    # --mutate an upsert lands a third of the way in and a delete two
    # thirds in, between query requests (clamped so both ops always fire
    # even at --requests 1).  Admission runs at the door: shed arrivals
    # never enqueue; --hot-repeat replays the first payload every Nth
    # request (the hot-query traffic the cache tier exists for).
    up_at = min(max(1, len(sizes) // 3), len(sizes) - 1)
    del_at = min(max(2, (2 * len(sizes)) // 3), len(sizes) - 1)
    queue: collections.deque = collections.deque()
    off = 0
    first_payload = None
    for i, sz in enumerate(sizes):
        if args.mutate and i == up_at:
            queue.append(("upsert",
                          np.arange(args.n, args.n + extra_rows.shape[0]),
                          extra_rows, None, None))
        if args.mutate and i == del_at:
            queue.append(("delete", np.arange(0, 4), None, None, None))
        payload = queries[off : off + sz]
        off += sz
        if first_payload is None:
            first_payload = payload
        elif args.hot_repeat and i % args.hot_repeat == 0:
            payload = first_payload
        now = time.perf_counter()
        deadline = now + args.deadline_ms / 1e3 if args.deadline_ms else None
        decision = None
        if ctrl is not None:
            decision = ctrl.admit(int(payload.shape[0]), len(queue), deadline)
            if decision.action == SHED:
                telemetry.event("shed", request=i, reason=decision.reason,
                                queries=int(payload.shape[0]))
                continue
        queue.append(("query", payload, None, (now, deadline), decision))

    if replicas is None:
        warm(searcher, searcher_deg)   # replicas warm inside make_replica

    maint = None
    if args.maintenance:
        # lowest-priority trigger: a loaded index carried a TuneTable
        # measured on a foreign backend — re-measure here, off the
        # request path (only fires when pending_mismatch() is set)
        def retune_fn():
            from repro_torch.tune import autotune

            return autotune(smoke=True)

        maint = MaintenanceScheduler(
            index, interval_s=args.maintenance_interval, telemetry=telemetry,
            retune_fn=retune_fn,
        ).start()

    latencies = []
    write_latencies = []
    totals: collections.Counter = collections.Counter()
    served = 0
    writes = 0
    seq = 0
    t0 = time.perf_counter()
    pending = []       # replica mode: (future, n_queries, degraded)
    while queue:
        op, payload, vecs, timing, decision = queue.popleft()
        t_req = time.perf_counter()
        if op == "query" and replicas is not None:
            # async path: route to the least-loaded replica; workers
            # record the per-request telemetry (queue_wait/execute)
            _t_enq, deadline = timing
            if ctrl is not None and decision is not None:
                decision = ctrl.recheck(decision, deadline)
                if decision.action == SHED:
                    telemetry.event("shed", reason=decision.reason,
                                    queries=int(payload.shape[0]))
                    continue
            degraded = decision.degraded if decision is not None else False
            fut = replicas.submit((payload, degraded),
                                  queries=int(payload.shape[0]))
            if fut is None:          # per-replica admission: queue full
                telemetry.event("shed", reason="replica_queue",
                                queries=int(payload.shape[0]))
                continue
            t_sub = time.perf_counter()
            fut.add_done_callback(
                lambda _f, t=t_sub: latencies.append(time.perf_counter() - t)
            )
            pending.append((fut, int(payload.shape[0]), degraded))
            continue
        if op == "query":
            t_enq, deadline = timing
            tr = telemetry.request(seq)
            seq += 1
            tr.phase("queue_wait", t_req - t_enq)
            if ctrl is not None and decision is not None:
                decision = ctrl.recheck(decision, deadline)
                if decision.action == SHED:
                    tr.annotate(outcome="shed", reason=decision.reason)
                    tr.finish()
                    continue
            degraded = decision.degraded if decision is not None else False
            sx = serve_deg if degraded else serve_primary
            with tr.span("execute"):
                res = _ready(sx(payload))
            dt_req = time.perf_counter() - t_req
            latencies.append(dt_req)
            if ctrl is not None:
                ctrl.observe(dt_req)
            served += int(payload.shape[0])
            for key in _AGG_KEYS:
                totals[key] += int(res.stats.get(key, 0))
            hit = res.stats.get("cache") == "hit"
            telemetry.counters["queries_served"] += int(payload.shape[0])
            if degraded:
                telemetry.counters["requests_degraded"] += 1
            if filt is not None:
                telemetry.counters["filtered_requests"] += 1
                telemetry.counters["filtered_queries"] += int(
                    payload.shape[0])
                tr.annotate(
                    filter_selectivity=res.stats.get("filter_selectivity"))
            tr.annotate(outcome="served", degraded=degraded,
                        cache=res.stats.get("cache", "off"),
                        bucket=res.stats.get("bucket"),
                        padded_q=res.stats.get("padded_q"),
                        reranked=res.stats.get("reranked"),
                        queries=int(payload.shape[0]), cache_hit=hit)
            tr.finish()
        else:
            # write op: apply, then re-plan — a Searcher is a snapshot
            # (manifest-pinned) session.  If the mutation left the
            # manifest epoch unchanged (no-op delete, memtable-only
            # upsert below the seal threshold) the pinned snapshot is
            # still the authoritative sealed state and the re-plan is
            # skipped (counted; the write surfaces at the next
            # structural re-plan under LSM snapshot semantics).
            epoch_before = getattr(index, "epoch", None)
            if replicas is not None:
                replicas.drain()     # write barrier: no in-flight queries
            if op == "upsert":
                index.upsert(payload, vecs)
            else:
                index.delete(payload)
            replanned = epoch_before is None or index.epoch != epoch_before
            if replanned:
                replan_gen[0] += 1
                if replicas is not None:
                    # every replica re-plans (and re-warms) against the
                    # new manifest epoch before traffic resumes
                    replicas.rebuild()
                else:
                    searcher, searcher_deg = make_searchers()
                    serve_primary, serve_deg = wrap(searcher), wrap(searcher_deg)
                    # warm every distinct request size, as at startup — a
                    # cold bucket after the re-plan would pollute the query
                    # p95/p99
                    warm(searcher, searcher_deg)
                telemetry.counters["replans"] += 1
            else:
                telemetry.counters["replans_avoided"] += 1
            write_latencies.append(time.perf_counter() - t_req)
            writes += len(payload)
            telemetry.event("write", op=op, rows=int(len(payload)),
                            replanned=replanned, epoch=index.epoch
                            if epoch_before is not None else None)
    if replicas is not None:
        replicas.drain()
        for fut, nq, degraded in pending:
            res = fut.result()
            served += nq
            for key in _AGG_KEYS:
                totals[key] += int(res.stats.get(key, 0))
            telemetry.counters["queries_served"] += nq
            if degraded:
                telemetry.counters["requests_degraded"] += 1
            if filt is not None:
                telemetry.counters["filtered_requests"] += 1
                telemetry.counters["filtered_queries"] += nq
    dt = time.perf_counter() - t0

    # per-shard scan-bytes counters (placement accounting: each shard's
    # share of the session's scanned payload)
    if head.placement is not None and totals["bytes_read"]:
        p = head.placement
        rows_all = sum(p.shard_rows(s) for s in range(p.n_shards)) or 1
        for s in range(p.n_shards):
            telemetry.counters[f"shard{s}_scan_bytes"] = int(
                totals["bytes_read"] * p.shard_rows(s) / rows_all
            )

    if maint is not None:
        maint.stop()

    n_req = len(latencies)
    # query throughput excludes write ops' apply+replan+re-warm time —
    # that cost is reported separately below
    query_dt = max(dt - sum(write_latencies), 1e-9)
    print(f"[serve] {served} queries / {n_req} requests in {dt:.3f}s -> "
          f"{served / query_dt:.1f} QPS (k={args.k}, corpus={index.n}, "
          f"kind={index.kind})")
    if latencies:
        p50, p95, p99 = (float(np.percentile(latencies, p))
                         for p in (50, 95, 99))
        print(f"[serve] latency p50={p50 * 1e3:.2f}ms p95={p95 * 1e3:.2f}ms "
              f"p99={p99 * 1e3:.2f}ms")
    if write_latencies:
        print(f"[serve] writes: {writes} rows / {len(write_latencies)} ops, "
              f"apply+replan p50="
              f"{float(np.percentile(write_latencies, 50)) * 1e3:.2f}ms "
              f"replans={telemetry.counters['replans']} "
              f"avoided={telemetry.counters['replans_avoided']}; "
              f"index now n={index.n} "
              f"segments={index.stats()['segments']} "
              f"tombstones={index.stats()['tombstones']}")
    if cache is not None:
        cs = cache.stats()
        print(f"[serve] cache: hits={cs['hits']} misses={cs['misses']} "
              f"evictions={cs['evictions']} entries={cs['entries']}"
              + (f" ttl={cs['ttl_s']}s" if cs["ttl_s"] else ""))
    if ctrl is not None:
        c = telemetry.counters
        print(f"[serve] admission: admit={c['admission_admit']} "
              f"degrade={c['admission_degrade']} shed={c['admission_shed']} "
              f"(queue={c['admission_shed_queue']} "
              f"budget={c['admission_shed_budget']} "
              f"deadline={c['admission_shed_deadline']}) "
              f"shed_queries={c['admission_shed_queries']}")
    if replicas is not None:
        c = telemetry.counters
        per = " ".join(
            f"r{r}:req={c[f'replica{r}_requests']}"
            f"/peak={c[f'replica{r}_queue_peak']}"
            for r in range(n_replicas)
        )
        print(f"[serve] replicas: {n_replicas} shed={c['replica_shed']} {per}")
        replicas.close()
    if head.placement is not None:
        c = telemetry.counters
        print("[serve] shard scan bytes: "
              + " ".join(f"s{s}={c[f'shard{s}_scan_bytes']}"
                         for s in range(head.placement.n_shards)))
    if maint is not None:
        c = telemetry.counters
        print(f"[serve] maintenance: rounds={c['maintenance_rounds']} "
              f"swaps={c['maintenance_swaps']} "
              f"conflicts={c['maintenance_conflicts']} "
              f"retunes={c['maintenance_retunes']} "
              f"errors={c['maintenance_errors']}")
    # per-search engine accounting aggregated over the session (uniform
    # across kinds; DESIGN.md §8/§9) — means per request, plus totals for
    # the batch-cumulative keys (candidates/chunks/reranked are per-query
    # quantities and only meaningful as means)
    means = {key: totals[key] / max(n_req, 1) for key in _AGG_KEYS}
    print("[serve] stats/request mean: "
          + " ".join(f"{key}={means[key]:.1f}" for key in _AGG_KEYS))
    print(f"[serve] stats/session totals: "
          f"bytes_read={totals['bytes_read']} padded_q={totals['padded_q']}")

    if args.telemetry_out:
        telemetry.meta["report"] = {
            "qps": served / query_dt, "served": served, "requests": n_req,
            "writes": writes, **{f"mean_{k}": means[k] for k in _AGG_KEYS},
        }
        telemetry.to_json(args.telemetry_out)
        print(f"[serve] telemetry -> {args.telemetry_out} "
              f"({len(telemetry.events)} events)")


if __name__ == "__main__":
    main()
