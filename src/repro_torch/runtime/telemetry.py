"""Structured serve telemetry: per-request spans, a shared counter
registry, and the JSON event log a trend gate consumes (port of
``repro.runtime.telemetry``).

One ``Telemetry`` object per serving session.  Three surfaces:

  * **counters** — a plain ``Counter`` shared *by reference* with the
    cache tiers and the admission controller, so every subsystem
    increments into one registry and the final report is one dict, not
    a reconciliation exercise.
  * **request traces** — ``telemetry.request(id)`` yields a
    ``RequestTrace``; phases (``queue_wait`` / ``pad`` / ``execute`` /
    ``rerank`` / ``merge`` / ...) are timed with ``trace.span(name)``
    or recorded directly with ``trace.phase(name, seconds)`` (for
    durations measured elsewhere, e.g. queue wait), annotations carry
    the engine stats; ``finish`` appends one event row.
  * **ad-hoc spans** — ``telemetry.span("maintenance/compact")`` times
    off-request work (the background compactor) into the same log.

Kernel launches return before the card finishes, so a span that times
device work is given that work's CUDA ``device``: it synchronizes the
device's current stream when it opens and before it closes, and the host
clock then measures the work, not its enqueue.

``to_json`` writes ``{meta, counters, summary, events}`` where ``meta``
embeds the runtime-profile stamp — the artifact CI uploads next to the
``BENCH_*.json`` files, carrying the same provenance.
"""

from __future__ import annotations

import collections
import contextlib
import json
import time
from typing import Any, Callable, Optional

import numpy as np
import torch


class RequestTrace:
    """Span accumulator for one request; append-only until ``finish``."""

    def __init__(self, req_id, telemetry: "Telemetry"):
        self.req_id = req_id
        self._t = telemetry
        self.phases: dict[str, float] = {}
        self.fields: dict[str, Any] = {}
        self._done = False

    @contextlib.contextmanager
    def span(self, name: str, device=None):
        """Time the block as phase ``name``; with a CUDA ``device``, the
        device work it enqueued too (see the module docstring)."""
        _sync(device)
        t0 = self._t.clock()
        try:
            yield self
        finally:
            _sync(device)
            self.phase(name, self._t.clock() - t0)

    def phase(self, name: str, seconds: float) -> None:
        self.phases[name] = self.phases.get(name, 0.0) + float(seconds)

    def annotate(self, **fields) -> None:
        self.fields.update(fields)

    def finish(self) -> dict:
        if not self._done:                      # idempotent
            self._done = True
            self._t._finish_request(self)
        return {"type": "request", "id": self.req_id,
                **{f"{k}_s": v for k, v in self.phases.items()},
                **self.fields}


class Telemetry:
    """The session-wide event log + counter registry."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 meta: Optional[dict] = None):
        self.clock = clock
        self.meta = dict(meta or {})
        self.counters: collections.Counter = collections.Counter()
        self.events: list[dict] = []
        self._phase_samples: dict[str, list[float]] = collections.defaultdict(list)

    # -- request path ------------------------------------------------------
    def request(self, req_id) -> RequestTrace:
        return RequestTrace(req_id, self)

    def _finish_request(self, trace: RequestTrace) -> None:
        self.counters["requests"] += 1
        for name, dur in trace.phases.items():
            self._phase_samples[name].append(dur)
        self.events.append({"type": "request", "id": trace.req_id,
                            **{f"{k}_s": v for k, v in trace.phases.items()},
                            **trace.fields})

    # -- ad-hoc (maintenance path) -----------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, device=None, **fields):
        _sync(device)
        t0 = self.clock()
        row = {"type": "span", "name": name, **fields}
        try:
            yield row
        finally:
            _sync(device)
            row["dur_s"] = self.clock() - t0
            self._phase_samples[name].append(row["dur_s"])
            self.events.append(row)

    def event(self, type_: str, **fields) -> None:
        self.events.append({"type": type_, **fields})

    # -- rollups -----------------------------------------------------------
    def percentiles(self, name: str, qs=(50, 95, 99)) -> dict[str, float]:
        xs = self._phase_samples.get(name)
        if not xs:
            return {}
        return {f"p{q}_ms": float(np.percentile(xs, q)) * 1e3 for q in qs}

    def summary(self) -> dict:
        return {
            name: {"count": len(xs), "total_s": float(np.sum(xs)),
                   **self.percentiles(name)}
            for name, xs in sorted(self._phase_samples.items())
        }

    def to_json(self, path) -> dict:
        """Serialize ``{meta, counters, summary, events}``; returns the
        payload (path may be a filesystem path or a file-like object)."""
        payload = {
            "meta": self.meta,
            "counters": dict(self.counters),
            "summary": self.summary(),
            "events": self.events,
        }
        text = json.dumps(payload, indent=2, sort_keys=True, default=_scalar)
        if hasattr(path, "write"):
            path.write(text)
        else:
            with open(path, "w") as f:
                f.write(text)
        return payload


def _sync(device) -> None:
    """Wait for ``device``'s current stream (a CUDA device only)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _scalar(x):
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)
