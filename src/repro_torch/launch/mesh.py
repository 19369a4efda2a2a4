"""Mesh construction (port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
device.  A mesh is the port's in-process ``dist.Mesh`` over
``dist.sharding.default_devices()``: every visible card, or the applied
CPU profile's host devices (``cpu-mesh4``: four).
"""

from __future__ import annotations

import math

from repro_torch.dist.sharding import default_devices, make_mesh


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 devices a pod; 2 pods = 512 devices multi-pod.  Raises
    where the host has fewer, as the reference does."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    devices = default_devices()[:n]
    if len(devices) < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, have {len(devices)} — a "
            "production mesh needs that many cards in one process"
        )
    return make_mesh(shape, axes, devices=devices)


def make_host_mesh(model_parallel: int = 1):
    """Small ("data", "model") mesh over whatever devices exist: tests and
    local runs.  The model axis is the largest size up to
    ``model_parallel`` that divides the device count."""
    devices = default_devices()
    n = len(devices)
    mp = min(model_parallel, n)
    while n % mp:
        mp -= 1
    return make_mesh((n // mp, mp), ("data", "model"), devices=devices)
