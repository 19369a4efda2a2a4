"""Background maintenance: compaction and drift-triggered recalibration
off the request path (port of ``repro.runtime.maintenance``, over the
port's ``stream.MutableIndex``).

``MutableIndex.compact()`` blocks its caller for the whole merge build —
in a serving loop that cost lands on request latency.  The
``MaintenanceScheduler`` moves it to a daemon thread using the stream
layer's three-phase protocol:

    1. ``index.compact_snapshot()``   freeze the group under the write
                                      lock (copy-only), release the lock
    2. (off-lock)                     build the merged segment — the
                                      expensive inner-index build +
                                      possible Eq. 1 re-fit — while the
                                      request path keeps serving
    3. ``index.apply_compaction()``   atomic manifest swap under the
                                      lock; concurrent deletes re-applied,
                                      competing swaps detected and dropped

After a successful swap the scheduler also owns the *rerank-store
refresh*: the swap invalidated the stream index's cached merge re-score
store, so ``index.refresh_rerank_store()`` rebuilds it eagerly inside
the same background round (counted as ``rerank_refreshes``) instead of
letting the next query's plan pay for it.

Triggers, checked every ``interval_s``:

  * **structural** — the compactor's own ``should_compact`` (too many
    segments), running the policy's group pick;
  * **drift** — ``stats()["max_drift"]`` beyond the compaction policy's
    ``drift_threshold``: a *full* snapshot-compaction with
    recalibration, repairing the §3.2 data-driven constants the insert
    stream has left behind;

  * **tune** (lowest priority, only with a ``retune_fn``) — a loaded
    index carried a TuneTable measured on a different backend
    (``repro_torch.tune.table.pending_mismatch()``): re-measure on *this*
    backend off the request path, install the fresh table, clear the
    pending one.  Counted as ``maintenance_retunes``; a failing re-tune
    counts ``maintenance_errors`` and leaves dispatch on its current
    (fallback or previously-adopted) configs.

The exact-parity invariant survives the background path: a full
snapshot-compaction with no concurrent writes swaps in a segment
bit-identical to a from-scratch build on ``live_items()``
(tests/test_torch_runtime.py holds it through these hooks).

On the card the thread launches kernels beside the request path: both
use their thread's current stream (the default stream unless a caller
set one), the kernel libraries are built and loaded once under
``kernels/_build``'s lock, and launch counts are taken under a lock of
their own.  Tests wait on ``swapped`` (an ``Event`` set after every
successful swap) or the counters, never on a clock loop.

``run_once`` is the synchronous entry (tests, serve's drain step);
``start``/``stop`` manage the thread.  All outcomes are counted into the
shared telemetry counters and logged as ``maintenance/*`` spans.
"""

from __future__ import annotations

import threading
import traceback
from typing import Optional


class MaintenanceScheduler:
    """Drives background compaction/recalibration for one mutable index."""

    def __init__(
        self,
        index,
        *,
        interval_s: float = 0.25,
        drift_threshold: Optional[float] = None,
        telemetry=None,
        retune_fn=None,
    ):
        if not hasattr(index, "compact_snapshot"):
            raise TypeError(
                f"maintenance needs a mutable (stream) index, got "
                f"{getattr(index, 'kind', type(index).__name__)!r}"
            )
        self.index = index
        self.interval_s = float(interval_s)
        # None -> the index's own compaction policy threshold
        self.drift_threshold = (
            float(drift_threshold) if drift_threshold is not None
            else float(index.policy.drift_threshold)
        )
        self.telemetry = telemetry
        # zero-arg callable returning a fresh TuneTable for this backend
        # (e.g. lambda: repro_torch.tune.autotune(smoke=True)); None disables
        # the re-tune trigger
        self.retune_fn = retune_fn
        #: the traceback of the thread's last failed round (None: none)
        self.last_error: Optional[str] = None
        self._stop = threading.Event()
        #: set after every successful swap (tests and drains wait on it)
        self.swapped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        import collections

        self.counters = (telemetry.counters if telemetry is not None
                         else collections.Counter())

    # -- triggers ----------------------------------------------------------
    def _trigger(self) -> Optional[str]:
        idx = self.index
        if idx.compactor.should_compact(idx.manifest.segments):
            return "segments"
        st = idx.stats()
        if (st["segments"] > 0 and self.drift_threshold > 0
                and st["max_drift"] > self.drift_threshold):
            return "drift"
        if self.retune_fn is not None:
            from repro_torch.tune import table as tunetable

            if tunetable.pending_mismatch() is not None:
                return "tune"
        return None

    # -- low-priority re-tune (saved-index table from a foreign backend) ---
    def _run_retune(self, out: dict) -> None:
        from repro_torch.tune import table as tunetable

        pending = tunetable.pending_mismatch()
        out["pending_hash"] = (pending.table_hash() if pending is not None
                               else None)
        fresh = self.retune_fn()
        if fresh is not None:
            tunetable.install(fresh)
            out["table_hash"] = fresh.table_hash()
            out["swapped"] = True
        tunetable.clear_pending()

    # -- one maintenance round --------------------------------------------
    def run_once(self, force_full: bool = False) -> dict:
        """Check triggers; if one fires, snapshot-compact and swap.

        Returns an outcome record (also appended to telemetry):
        ``{"ran": bool, "trigger": ..., "swapped": bool, ...}``.
        """
        trigger = "forced" if force_full else self._trigger()
        if trigger is None:
            return {"ran": False}
        if trigger == "tune":
            out = {"ran": True, "trigger": "tune", "swapped": False}
            if self.telemetry is not None:
                with self.telemetry.span("maintenance/retune"):
                    self._run_retune(out)
            else:
                self._run_retune(out)
            self.counters["maintenance_rounds"] += 1
            self.counters["maintenance_retunes"] += 1
            if self.telemetry is not None:
                self.telemetry.event("maintenance", **out)
            return out
        full = force_full or trigger == "drift"
        out = {"ran": True, "trigger": trigger, "full": full, "swapped": False}

        def round_():
            pending = self.index.compact_snapshot(full=full)
            if pending is None:
                out["empty"] = True
                return
            out["swapped"] = bool(self.index.apply_compaction(pending))
            out["recalibrated"] = pending.recalibrated
            out["epoch"] = self.index.epoch
            if out["swapped"]:
                # the swap invalidated the merge re-score store; rebuild
                # it here so the cost lands in this background round, not
                # in the next query's plan
                out["rerank_refreshed"] = bool(
                    self.index.refresh_rerank_store())

        if self.telemetry is not None:
            with self.telemetry.span("maintenance/compact", trigger=trigger):
                round_()
        else:
            round_()
        self.counters["maintenance_rounds"] += 1
        if out["swapped"]:
            self.counters["maintenance_swaps"] += 1
            if out.get("rerank_refreshed"):
                self.counters["rerank_refreshes"] += 1
            self.swapped.set()
        elif not out.get("empty"):
            self.counters["maintenance_conflicts"] += 1
        if self.telemetry is not None:
            self.telemetry.event("maintenance", **out)
        return out

    # -- thread lifecycle --------------------------------------------------
    def start(self) -> "MaintenanceScheduler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="repro-maintenance", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.run_once()
            except Exception as e:  # noqa: BLE001 — never kill the server
                self.counters["maintenance_errors"] += 1
                self.last_error = traceback.format_exc()
                if self.telemetry is not None:
                    self.telemetry.event("maintenance_error", error=repr(e),
                                         traceback=self.last_error)

    def stop(self, timeout: float = 10.0) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout)
        self._thread = None

    def __enter__(self) -> "MaintenanceScheduler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
