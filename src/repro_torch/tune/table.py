"""Measured dispatch tables: ``TuneTable`` and the process-wide lookup
point every kernel dispatch consults (port of ``repro.tune.table``).

A ``TuneTable`` maps

    (backend, device_kind, kernel, metric, bits, Q-bucket, N-bucket,
     d-bucket)  ->  TuneConfig(impl, bq, bn, chunk)

and is produced by :mod:`repro_torch.tune.autotuner` on the live device,
where every candidate was held bit-equal to the plain version before it
was timed.  Dispatch precedence is **tuned > fallback rows**: when no entry
matches (or no table is installed, or the table was measured on another
backend), callers use the registered fallback rows (``kernels/ops.py``),
which name the implementation only (a kernel runs at its layout's own
rule), and the miss is counted, never raised.

The JSON form (``TABLE_VERSION`` 1) and ``table_hash`` are the
reference's byte for byte, so a table written by either package reads in
the other with the same hash.  On the card an entry's ``bq`` is the query
rows of one kernel block and ``bn`` the corpus rows one split streams
(``kernels/fused_topk.layout``, ``kernels/adc.adc_layout``); ``chunk``
sizes the plain scan.  A ``cuda`` table gives the fused families
(``fused_topk``, ``packed``, ``fused_adc``) kernel layouts only: an ip / l2
CUDA store always runs its kernel, so a ``scan`` entry for those families
is refused (``ValueError``) when such a table is installed or adopted, as
is a ``bq`` no kernel block holds.

Tables persist as standalone JSON (``to_json`` / ``from_json``, stamped
with the runtime-profile facts of the measuring process) and embedded in
saved indexes (``knn.base.save_state`` attaches the active table;
``registry.load_index`` adopts it).  An adopted table whose stamp does not
match the serving process is *not* installed: it is parked as the
pending-mismatch table (a counter, not a crash) for the maintenance
scheduler's re-tune trigger.

Threads: ``install`` / ``adopt`` rebind one process-wide slot.  ``pinned``
overrides it for the calling thread only, so a Searcher running under its
plan-time snapshot does not change what a maintenance thread sees.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import json
import threading
from typing import Any, Optional

#: dispatch implementations a table entry can choose between
IMPLS = ("fused", "scan")

#: stamp keys two tables/backends must agree on to be interchangeable
STAMP_KEYS = ("backend", "device_kind", "interpret")

TABLE_VERSION = 1

#: kernel families whose CUDA form is a hand-written kernel
FUSED_FAMILIES = ("fused_topk", "packed", "fused_adc")


@dataclasses.dataclass(frozen=True)
class TuneConfig:
    """One chosen kernel configuration.

    impl         "fused" (the kernel) or "scan" (the plain streaming scan)
    bq / bn      query rows a kernel block holds / corpus rows one split
                 streams (None = the layout's own rule)
    chunk        scan chunk rows (None = the caller's chunk)
    measured_us  median time the autotuner measured for this config
    default_us   median time of the default-dispatch config on the same
                 workload (the honest speedup denominator)
    """

    impl: str
    bq: Optional[int] = None
    bn: Optional[int] = None
    chunk: Optional[int] = None
    measured_us: Optional[float] = None
    default_us: Optional[float] = None

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {self.impl!r}")
        for name in ("bq", "bn", "chunk"):
            v = getattr(self, name)
            if v is not None and (not isinstance(v, int) or v <= 0):
                raise ValueError(f"TuneConfig.{name} must be a positive int "
                                 f"or None, got {v!r}")

    def dispatch_dict(self) -> dict[str, Any]:
        """The hash-relevant subset: what the config *does*, not how fast
        it measured."""
        return {"impl": self.impl, "bq": self.bq, "bn": self.bn,
                "chunk": self.chunk}

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "TuneConfig":
        known = {f.name for f in dataclasses.fields(TuneConfig)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown TuneConfig fields: {sorted(unknown)}")
        return TuneConfig(**d)


def bucket(x: int) -> int:
    """Power-of-two shape bucket: the smallest 2**i >= x (min 1)."""
    x = max(1, int(x))
    return 1 << (x - 1).bit_length()


def key_for(backend: str, device_kind: str, kernel: str, metric: str,
            bits: int, q: int, n: int, d: int) -> str:
    """The canonical entry key: backend facts + kernel family + metric +
    storage width + bucketed shape."""
    return (f"{backend}|{device_kind}|{kernel}|{metric}|{bits}"
            f"|q{bucket(q)}|n{bucket(n)}|d{bucket(d)}")


def split_key(key: str) -> tuple[str, str, int, int, int, int]:
    """(kernel, metric, bits, q-bucket, n-bucket, d-bucket) of an entry key
    (the device name may hold any character but the key's last six
    fields do not)."""
    _dev, kernel, metric, bits, q, n, d = key.rsplit("|", 6)
    return kernel, metric, int(bits), int(q[1:]), int(n[1:]), int(d[1:])


def live_stamp() -> dict[str, Any]:
    """The backend facts of *this* process, in TuneTable stamp form."""
    from repro_torch.runtime import profile as rtprofile

    s = rtprofile.stamp()
    return {k: s[k] for k in
            ("profile", "backend", "device_kind", "interpret",
             "torch_version", "seed")}


@dataclasses.dataclass
class TuneTable:
    """A measured dispatch table: stamp (who measured it, where) plus the
    entry mapping.  ``stamp`` must carry the :data:`STAMP_KEYS`."""

    stamp: dict[str, Any]
    entries: dict[str, TuneConfig] = dataclasses.field(default_factory=dict)
    version: int = TABLE_VERSION

    def __post_init__(self):
        missing = [k for k in STAMP_KEYS if k not in self.stamp]
        if missing:
            raise ValueError(f"TuneTable stamp is missing {missing}")

    # -- entry access ------------------------------------------------------
    def _key(self, kernel: str, metric: str, bits: int,
             q: int, n: int, d: int) -> str:
        return key_for(self.stamp["backend"], self.stamp["device_kind"],
                       kernel, metric, bits, q, n, d)

    def put(self, kernel: str, metric: str, bits: int, q: int, n: int,
            d: int, cfg: TuneConfig) -> str:
        key = self._key(kernel, metric, bits, q, n, d)
        self.entries[key] = cfg
        return key

    def get(self, kernel: str, metric: str, bits: int,
            q: int, n: int, d: int) -> Optional[TuneConfig]:
        return self.entries.get(self._key(kernel, metric, bits, q, n, d))

    def matches(self, stamp: Optional[dict] = None) -> bool:
        """Was this table measured on the backend ``stamp`` describes
        (default: the live process, whose facts are worked out once)?"""
        if stamp is None:
            from repro_torch.runtime import profile as rtprofile

            stamp = rtprofile.backend_facts()
        return all(self.stamp.get(k) == stamp.get(k) for k in STAMP_KEYS)

    def check(self) -> "TuneTable":
        """Refuse entries no dispatch of the table's backend can run (see
        the module docstring); returns the table."""
        if self.stamp.get("backend") != "cuda":
            return self
        from repro_torch.tune import space

        for key, cfg in self.entries.items():
            kernel, metric, bits, q, _n, _d = split_key(key)
            if kernel not in FUSED_FAMILIES or metric not in ("ip", "l2"):
                continue
            if cfg.impl != "fused":
                raise ValueError(
                    f"TuneTable entry {key!r} chooses the scan, but an ip / "
                    "l2 CUDA store always runs its kernel: a cuda table "
                    "gives the fused families kernel layouts only")
            allowed = space.block_rows(kernel, bits, q)
            if cfg.bq is not None and cfg.bq not in allowed:
                raise ValueError(
                    f"TuneTable entry {key!r}: bq={cfg.bq} is no block of "
                    f"the {kernel} kernel (one of {allowed})")
        return self

    # -- identity ----------------------------------------------------------
    def table_hash(self) -> str:
        """Stable hash of the dispatch-relevant content (backend facts +
        per-entry choices; measured timings excluded)."""
        doc = {
            "version": self.version,
            "stamp": {k: self.stamp.get(k) for k in STAMP_KEYS},
            "entries": {k: self.entries[k].dispatch_dict()
                        for k in sorted(self.entries)},
        }
        blob = json.dumps(doc, sort_keys=True).encode("utf-8")
        return hashlib.blake2b(blob, digest_size=8).hexdigest()

    # -- (de)serialization -------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        return {
            "version": self.version,
            "stamp": dict(self.stamp),
            "entries": {k: self.entries[k].to_dict()
                        for k in sorted(self.entries)},
        }

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "TuneTable":
        if int(d.get("version", 0)) != TABLE_VERSION:
            raise ValueError(
                f"unsupported TuneTable version {d.get('version')!r} "
                f"(this build reads version {TABLE_VERSION})"
            )
        return TuneTable(
            stamp=dict(d["stamp"]),
            entries={k: TuneConfig.from_dict(v)
                     for k, v in d.get("entries", {}).items()},
            version=TABLE_VERSION,
        )

    def to_json(self, path) -> None:
        doc = json.dumps(self.to_dict(), indent=2, sort_keys=True)
        if hasattr(path, "write"):
            path.write(doc)
            return
        with open(path, "w") as f:
            f.write(doc)

    @staticmethod
    def from_json(path) -> "TuneTable":
        if hasattr(path, "read"):
            return TuneTable.from_dict(json.loads(path.read()))
        with open(path) as f:
            return TuneTable.from_dict(json.load(f))


# --------------------------------------------------------------------------
# the process-wide dispatch point
# --------------------------------------------------------------------------

#: the installed table every dispatch consults (None = fallback rows)
_ACTIVE: Optional[TuneTable] = None
#: a table adopted from a saved index whose stamp did NOT match this
#: process — parked for the maintenance re-tune trigger, never served
_PENDING_MISMATCH: Optional[TuneTable] = None
#: per-thread ``pinned`` overrides (a stack of tables, None included)
_PINS = threading.local()

#: lookup / adoption accounting (tests and reports read these)
COUNTERS: collections.Counter = collections.Counter()

#: kernel family -> the registered fallback row; kernels/ops.py registers
#: these at import time
_FALLBACKS: dict[str, TuneConfig] = {}


def register_fallback(kernel: str, cfg: TuneConfig) -> TuneConfig:
    """Register the fallback row dispatch uses when no entry matches."""
    _FALLBACKS[kernel] = cfg
    return cfg


def fallback(kernel: str) -> TuneConfig:
    """The registered fallback row for a kernel family."""
    try:
        return _FALLBACKS[kernel]
    except KeyError:
        raise KeyError(
            f"no fallback row registered for kernel {kernel!r}; "
            f"registered: {sorted(_FALLBACKS)}"
        ) from None


def fallback_kernels() -> tuple[str, ...]:
    return tuple(sorted(_FALLBACKS))


def install(table: Optional[TuneTable]) -> Optional[TuneTable]:
    """Install ``table`` as the process-wide dispatch table (None clears).
    Raises ``ValueError`` on entries its backend cannot run."""
    global _ACTIVE
    _ACTIVE = None if table is None else table.check()
    return table


def active() -> Optional[TuneTable]:
    """The table this thread's dispatch consults: its innermost ``pinned``
    table, else the installed one."""
    stack = getattr(_PINS, "stack", None)
    return stack[-1] if stack else _ACTIVE


def active_hash() -> Optional[str]:
    """The active table's dispatch hash (None = fallback rows only): the
    value ``runtime.profile.stamp()`` reports."""
    t = active()
    return t.table_hash() if t is not None else None


def clear() -> None:
    """Forget the installed and pending tables (tests)."""
    global _ACTIVE, _PENDING_MISMATCH
    _ACTIVE = None
    _PENDING_MISMATCH = None


@contextlib.contextmanager
def pinned(table: Optional[TuneTable]):
    """Make ``table`` (which may be None) the active table for this thread
    while the block runs.

    The Searcher's plan-time resolution: a plan snapshots the active table
    at construction and runs every bucket under ``pinned(snapshot)``, so a
    table installed *after* plan time cannot change a planned Searcher.
    """
    stack = getattr(_PINS, "stack", None)
    if stack is None:
        stack = _PINS.stack = []
    stack.append(table)
    try:
        yield table
    finally:
        stack.pop()


def snapshot_for_plan() -> Optional[TuneTable]:
    """The table a new plan should freeze: the active table if it was
    measured on this backend, else None (counted, never raised)."""
    t = active()
    if t is None:
        return None
    if not t.matches():
        COUNTERS["tune_stamp_mismatch"] += 1
        return None
    return t


def lookup(kernel: str, metric: str, bits: int, q: int, n: int,
           d: int) -> Optional[TuneConfig]:
    """The dispatch query: the active table's entry for this workload
    bucket, or None (use the fallback row).  Misses and stamp mismatches
    are counted; a lookup never raises."""
    t = active()
    if t is None:
        return None
    if not t.matches():
        COUNTERS["tune_stamp_mismatch"] += 1
        return None
    cfg = t.get(kernel, metric, bits, q, n, d)
    COUNTERS["tune_lookup_hit" if cfg is not None else
             "tune_lookup_miss"] += 1
    return cfg


# -- adoption (saved-index / JSON tables entering a serving process) -------

def adopt(table: TuneTable) -> bool:
    """Install ``table`` if it was measured on this backend; else park it as
    the pending-mismatch table (a counter, not a crash).  Either way a
    table with entries its backend cannot run raises ``ValueError``."""
    global _PENDING_MISMATCH
    table.check()
    if table.matches():
        install(table)
        COUNTERS["tune_adopted"] += 1
        return True
    _PENDING_MISMATCH = table
    COUNTERS["tune_adopt_mismatch"] += 1
    return False


def adopt_from_meta(meta: dict) -> Optional[bool]:
    """Adopt the table embedded in a saved index's meta record (the
    ``"tune"`` key ``knn.base.save_state`` writes).  None when the record
    carries no table."""
    doc = meta.get("tune")
    if doc is None:
        return None
    return adopt(TuneTable.from_dict(doc))


def pending_mismatch() -> Optional[TuneTable]:
    """The adopted-but-mismatched table awaiting a re-tune (or None)."""
    return _PENDING_MISMATCH


def clear_pending() -> None:
    global _PENDING_MISMATCH
    _PENDING_MISMATCH = None
