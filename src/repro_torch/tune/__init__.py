"""Kernel autotuning: measured dispatch tables in place of fixed launch
layouts (port of ``repro.tune``).

    table      TuneConfig / TuneTable, the process-wide lookup point every
               kernel dispatch consults, the fallback-row registry,
               adoption of persisted tables (import-light: safe from
               engine / kernels / knn without cycles)
    space      per-family candidate layouts + roofline pruning
    autotuner  the measured search itself (imports the engine: load lazily)

CLI: ``python -m repro_torch.tune --smoke --out TUNE.json``.
"""

from repro_torch.tune.table import (  # noqa: F401
    COUNTERS,
    TuneConfig,
    TuneTable,
    active,
    active_hash,
    adopt,
    adopt_from_meta,
    clear,
    clear_pending,
    fallback,
    install,
    lookup,
    pending_mismatch,
    pinned,
    register_fallback,
    snapshot_for_plan,
)


def autotune(*args, **kwargs):
    """Lazy forward to :func:`repro_torch.tune.autotuner.autotune` (that
    module imports the engine: an eager import here would cycle)."""
    from repro_torch.tune.autotuner import autotune as _autotune

    return _autotune(*args, **kwargs)
