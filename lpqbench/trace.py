"""The device trace of a ``--trace 1`` run and its reduction.

``torch.profiler`` records the card's activity (CUPTI) over the window:
kernels, copies and fills, whoever launched them (the port's ctypes
kernels too).  Two marker kernels (``torch.cuda._sleep``, named
``spin_kernel``) launched on an idle stream at the window's opening and
closing tie the trace's clock to the host's ``perf_counter``, so device
intervals can be cut to the window and idle gaps labelled by the harness
span that was open.  Nothing is written to disk.
"""

from __future__ import annotations

import re
from typing import Optional

import torch

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"


class DeviceTrace:
    """Start before the window, ``mark`` at its opening and closing (with
    the stream idle), ``stop`` after; ``events`` are then in host seconds."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._marks: list[float] = []

    def start(self) -> None:
        self._prof.start()

    def mark(self, host_t: float) -> None:
        """Launch a marker at host time ``host_t`` (the stream is idle)."""
        torch.cuda._sleep(1)
        self._marks.append(host_t)

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._prof.stop()

    def events(self) -> list[tuple[str, str, float, float]]:
        """(name, activity, start, end) of every device op, host seconds."""
        raw = []
        for e in self._prof.profiler.kineto_results.events():
            if "CUDA" not in str(e.device_type()):
                continue
            act = _activity(e)
            if act not in DEVICE_ACTIVITIES:
                continue
            start = e.start_ns()
            raw.append((e.name(), act, start, start + e.duration_ns()))
        marks = sorted(s for name, act, s, _ in raw
                       if act == "kernel" and MARKER in name)
        if len(marks) != len(self._marks) or not marks:
            raise RuntimeError(
                f"trace: {len(marks)} marker kernels found, "
                f"{len(self._marks)} launched")
        base_ns, base_host = marks[0], self._marks[0]
        return [(n, a, base_host + (s - base_ns) * 1e-9,
                 base_host + (e - base_ns) * 1e-9)
                for n, a, s, e in raw if MARKER not in n]


def _activity(e) -> str:
    """A device event's kind: the event's own where the profiler names it
    (``activity_type``, not in every release), else from its name."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type())
    name = e.name()
    return ("gpu_memcpy" if name.startswith("Memcpy") else
            "gpu_memset" if name.startswith("Memset") else "kernel")


def short_name(name: str) -> str:
    """A kernel's name without its return type, template and arguments."""
    name = re.sub(r"^void\s+", "", name)
    for cut in ("<", "("):
        i = name.find(cut)
        if i > 0:
            name = name[:i]
    return name[:120]


def union(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """Merged intervals, cut to [lo, hi]."""
    out: list[list[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle intervals of [lo, hi] between merged busy intervals."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def label_at(spans, t: float) -> str:
    """The harness span open at host time ``t`` (spans sorted by start)."""
    lo, hi = 0, len(spans)
    while lo < hi:                         # last span starting at or before t
        mid = (lo + hi) // 2
        if spans[mid][1] <= t:
            lo = mid + 1
        else:
            hi = mid
    if lo and spans[lo - 1][1] <= t < spans[lo - 1][2]:
        return spans[lo - 1][0]
    return "harness"


def reduce(events, spans, lo: float, hi: float,
           top: int = 10) -> Optional[dict]:
    """Busy seconds, kernel count, the top device ops by time and the
    longest idle gaps (labelled) over the window [lo, hi]; None where the
    trace holds no device op in it."""
    inside = [(n, a, s, e) for n, a, s, e in events if e > lo and s < hi]
    if not inside:
        return None
    busy = union([(s, e) for _, _, s, e in inside], lo, hi)
    busy_s = sum(e - s for s, e in busy)
    by_name: dict[str, float] = {}
    for n, _, s, e in inside:
        key = short_name(n)
        by_name[key] = by_name.get(key, 0.0) + (min(e, hi) - max(s, lo))
    idle = sorted(gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:top]
    spans = sorted(spans, key=lambda sp: sp[1])
    return {
        "busy_s": busy_s,
        "window_s": hi - lo,
        "kernels": sum(1 for _, a, _, _ in inside if a == "kernel"),
        "device_ops": sorted(([n, t] for n, t in by_name.items()),
                             key=lambda x: -x[1])[:top],
        "idle_gaps": [[label_at(spans, (s + e) / 2), e - s] for s, e in idle],
    }
