"""Per-layer metrics: one small reader a metric, ``read(ctx)`` returning a
number, or None where it finds nothing to read (the harness then leaves
the metric out of the line).

The reader of metric ``a.b`` is ``metrics/a.b.py`` if there is one, else
``metrics/a.py``: the part after the dot names the cells' class
(``.online``, ``.batch``) where one quantity moves different end-to-end
metrics.  ``ctx`` holds:

    config   the configuration's file
    window   the measured window (``harness.run_window``): per request its
             ``size``, ``latency_s``, ``host_call_s`` and, in an open loop,
             ``send_lag_s``; ``window_s``, ``peak_bytes``, ``loop``
    trace    the reduced device trace (``trace.reduce``), or None
    memory   ``index_bytes``: what the built index holds on the device
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def reader(name: str):
    """The ``read`` function of per-layer metric ``name``."""
    for stem in dict.fromkeys((name, name.split(".")[0])):
        path = HERE / f"{stem}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(
                "lpqbench_metric_" + stem.replace(".", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise KeyError(f"no reader for per-layer metric {name!r} under {HERE}")
