"""Replica groups: query fan-out over data-parallel replicas (port of
``repro.dist.replica``, DESIGN.md §15).

Two layers, matching the two places replication happens:

  * **inside a plan**: ``replicated_query_plan`` wraps a per-kind
    function ``(queries) -> (scores, ids)`` in a fan-out over the *query*
    axis: every shard holds a full copy of the index (graph walks are not
    row-shardable) and walks its slice of the batch on its own device;
    the slices are gathered back onto the mesh's first device.
    Per-query independence makes this equal to the unsharded run.
  * **outside a plan**: ``ReplicaSet`` is the serving layer: R replica
    searchers (optionally each pinned to its own sub-mesh via
    ``submeshes``), worker threads draining per-replica queues, with
    per-replica admission (bounded queue depth) and per-replica telemetry
    (requests, queue-wait / execute spans, queue-depth peaks) flowing into
    the shared :mod:`repro_torch.runtime.telemetry` registry.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional, Sequence

import torch

__all__ = ["replicate", "replicated_query_plan", "replicated_walk",
           "submeshes", "ReplicaSet"]


def replicate(obj, device):
    """``obj`` with every tensor it holds on ``device``: tensors, and the
    fields of dataclasses, lists, tuples and dicts, recursively (an index,
    its stores and their constants).  Tensors already there are shared,
    not copied."""
    device = torch.device(device)
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: replicate(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, (list, tuple)):
        return type(obj)(replicate(x, device) for x in obj)
    if isinstance(obj, dict):
        return {key: replicate(v, device) for key, v in obj.items()}
    return obj


def replicated_query_plan(fn, mesh):
    """Fan a query batch out over ``mesh``; the index replicates.

    ``fn`` maps ``queries [Q, d]`` to ``(scores, ids)`` rows that depend
    only on their own query (every walk / scan kind does), running on the
    device its queries lie on.  The wrapper pads Q up to a multiple of the
    mesh size with zero queries, gives shard s the s-th slice on its own
    device, launches every shard before gathering, and reassembles on the
    mesh's first device with the pad rows dropped.
    """
    from repro_torch.dist.sharding import corpus_shards

    _axes, n_shards = corpus_shards(mesh)
    devs = mesh.shard_devices()

    def run(q: torch.Tensor):
        Q = q.shape[0]
        pad = (-Q) % n_shards
        if pad:
            q = torch.nn.functional.pad(q, (0, 0, 0, pad))
        per = q.shape[0] // n_shards
        outs = [fn(q[s * per:(s + 1) * per].to(dev))
                for s, dev in enumerate(devs)]
        s = torch.cat([o[0].to(devs[0]) for o in outs])
        i = torch.cat([o[1].to(devs[0]) for o in outs])
        return s[:Q], i[:Q]

    return run


def replicated_walk(index, walk_of, mesh):
    """The walk ``walk_of(index)`` fanned out over ``mesh`` by
    ``replicated_query_plan``: a copy of ``index`` on each shard device
    that is not its own (``replicate``), each walking its slice of the
    batch with ``walk_of(copy)``.  Returns ``queries -> (scores, ids)``
    gathered onto ``index.device``, where the kind's cut (or re-score)
    then runs at the whole batch."""
    walks = {index.device: walk_of(index)}
    for dev in set(mesh.shard_devices()) - {index.device}:
        walks[dev] = walk_of(replicate(index, dev))
    fan = replicated_query_plan(lambda q: walks[q.device](q), mesh)

    def run(queries):
        s, i = fan(queries)
        return s.to(index.device), i.to(index.device)

    return run


def submeshes(n_groups: int, devices: Optional[Sequence] = None) -> list:
    """Split the host's devices (default: every visible CUDA device) into
    ``n_groups`` disjoint 1-axis meshes, one per replica, so R replicas x
    (n_dev // R)-way sharding covers the host with no device
    oversubscription.  Groups are equal-sized (trailing remainder devices
    are left unused, so replica plans are shape-identical)."""
    from repro_torch.dist.sharding import Mesh, default_devices

    devs = list(devices) if devices is not None else default_devices()
    n_groups = max(1, min(int(n_groups), len(devs)))
    per = len(devs) // n_groups
    return [Mesh(devs[g * per:(g + 1) * per], ("data",))
            for g in range(n_groups)]


class ReplicaSet:
    """R data-parallel serving replicas behind per-replica queues.

    ``make_replica(r)`` builds replica ``r``'s request callable
    (``payload -> result``; a serving loop passes a closure over a Searcher
    that waits for its result on the device).  ``submit`` routes to the
    least-loaded replica (ties to the lowest id), enforcing ``max_queue``
    *per replica* at the door (a full replica sheds rather than queues
    without bound) and returns a ``Future``.  Workers record one telemetry
    request row per served request (``replica{r}/queue_wait`` and
    ``replica{r}/execute`` phases) plus shared counters
    ``replica{r}_requests`` / ``replica{r}_queries`` /
    ``replica{r}_queue_peak`` / ``replica_shed``.

    ``drain()`` blocks until every queued request has executed: the write
    barrier.  A writer drains, applies the mutation, then ``rebuild()``s
    so every replica re-plans against the new manifest epoch before
    traffic resumes.  Replicas on one card share it: each worker thread
    launches on the current stream, and the port's launch counters, tuning
    pins and LUT-cache bypass are safe across threads.
    """

    _STOP = object()

    def __init__(self, make_replica: Callable[[int], Callable], n_replicas: int,
                 *, max_queue: int = 0, telemetry=None):
        if n_replicas <= 0:
            raise ValueError(f"n_replicas must be positive, got {n_replicas}")
        self._make = make_replica
        self.n_replicas = int(n_replicas)
        self.max_queue = int(max_queue)
        self._telemetry = telemetry
        self._queues = [queue.Queue() for _ in range(self.n_replicas)]
        self._depths = [0] * self.n_replicas
        self._lock = threading.Lock()
        self._seq = 0
        self._replicas = [make_replica(r) for r in range(self.n_replicas)]
        self._workers = [
            threading.Thread(target=self._work, args=(r,), daemon=True)
            for r in range(self.n_replicas)
        ]
        for w in self._workers:
            w.start()

    # -- routing -----------------------------------------------------------
    def submit(self, payload, queries: int = 0) -> Optional[Future]:
        """Enqueue on the least-loaded replica; None == shed (replica
        queues full: per-replica admission)."""
        with self._lock:                 # the counters too: many submitters
            r = min(range(self.n_replicas), key=lambda j: (self._depths[j], j))
            if self.max_queue and self._depths[r] >= self.max_queue:
                if self._telemetry is not None:
                    self._telemetry.counters["replica_shed"] += 1
                return None
            self._depths[r] += 1
            depth = self._depths[r]
            self._seq += 1
            seq = self._seq
            if self._telemetry is not None:
                c = self._telemetry.counters
                c[f"replica{r}_requests"] += 1
                c[f"replica{r}_queries"] += int(queries)
                c[f"replica{r}_queue_peak"] = max(c[f"replica{r}_queue_peak"],
                                                  depth)
        fut: Future = Future()
        self._queues[r].put((payload, int(queries), fut, seq,
                             time.perf_counter()))
        return fut

    def _work(self, r: int) -> None:
        q = self._queues[r]
        while True:
            item = q.get()
            if item is self._STOP:
                q.task_done()
                return
            payload, nq, fut, seq, t_enq = item
            t0 = time.perf_counter()
            tr = None
            if self._telemetry is not None:
                tr = self._telemetry.request(seq)
                tr.phase(f"replica{r}/queue_wait", t0 - t_enq)
            try:
                res = self._replicas[r](payload)
                fut.set_result(res)
            except BaseException as e:  # surface on the future, keep serving
                fut.set_exception(e)
            with self._lock:             # workers share the telemetry
                if tr is not None:
                    tr.phase(f"replica{r}/execute", time.perf_counter() - t0)
                    tr.annotate(replica=r, queries=nq, outcome="served")
                    tr.finish()
                self._depths[r] -= 1
            q.task_done()

    # -- lifecycle ---------------------------------------------------------
    def drain(self) -> None:
        """Block until every enqueued request has finished executing."""
        for q in self._queues:
            q.join()

    def rebuild(self) -> None:
        """Write barrier: drain, then re-plan every replica (a writer calls
        this after a mutation bumps the manifest epoch)."""
        self.drain()
        self._replicas = [self._make(r) for r in range(self.n_replicas)]

    def close(self) -> None:
        self.drain()
        for q in self._queues:
            q.put(self._STOP)
        for w in self._workers:
            w.join(timeout=10.0)
