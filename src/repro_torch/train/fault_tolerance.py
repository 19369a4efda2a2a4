"""Fault tolerance beyond checkpoint / restart (port of
``repro.train.fault_tolerance``): crash-resilient execution and elastic
re-meshing when the device pool changes size.

The failure model: (a) preemption (SIGTERM, handled in
``train_loop.PreemptionGuard``), (b) hard node loss mid-step (the step
raises: handled here by restore-and-retry), (c) degraded-but-alive
stragglers (the watchdog in ``train_loop``), and (d) resume on a
*different* device count: ``elastic_remesh`` builds a ("data", "model")
mesh over the live devices and places checkpointed host arrays on it
(checkpoints are layout-agnostic numpy).

The port's mesh is in-process (``dist.sharding``): a sharded plan cuts a
leaf's shard blocks from the whole tensor when it runs, so a placed leaf
is one tensor on the mesh's first device, and its spec, the same
``spec_fn`` rule the reference applies, is checked against the mesh.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np

from repro_torch.device import to_tensor
from repro_torch.dist import sharding as SH


def run_with_retries(
    fn: Callable[[], Any],
    restore: Callable[[], None],
    max_failures: int = 3,
    backoff_s: float = 1.0,
):
    """Execute ``fn``; on failure call ``restore`` and retry.

    ``fn`` is expected to be a resumable closure (e.g. a train() call that
    restores from its own checkpoint dir), so a retry continues from the
    last checkpoint rather than from scratch.
    """
    failures = 0
    while True:
        try:
            return fn()
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 (any device / runtime fault)
            failures += 1
            if failures > max_failures:
                raise
            print(f"[ft] failure {failures}/{max_failures}: {e!r}; restoring")
            restore()
            time.sleep(backoff_s * failures)


def best_mesh_shape(n_devices: int, model_parallel: int) -> tuple[int, int]:
    """(data, model) factorization for an arbitrary live device count.

    Shrinks model parallelism if the pool no longer supports the requested
    width: elasticity means the job keeps running at reduced size.
    """
    mp = min(model_parallel, n_devices)
    while n_devices % mp:
        mp -= 1
    return n_devices // mp, mp


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _specs(host_state: Any, spec_fn: Callable, mesh) -> Any:
    """The state's spec tree: ``Named(mesh, spec_fn(leaf))`` a leaf, each
    spec no longer than the leaf's rank, over axes the mesh has."""
    def one(leaf):
        spec = SH.P(*spec_fn(leaf))
        if len(spec) > leaf.ndim:
            raise ValueError(f"spec {spec} does not fit a leaf of shape "
                             f"{tuple(leaf.shape)}")
        for entry in spec:
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                if axis is not None and axis not in mesh.axis_names:
                    raise ValueError(f"spec {spec} names axis {axis!r}; the "
                                     f"mesh has {mesh.axis_names}")
        return SH.Named(mesh, spec)

    return _map(one, host_state)


def elastic_remesh(
    host_state: Any,
    spec_fn: Callable[[Any], SH.P],
    model_parallel: int = 1,
    devices=None,
):
    """Build a mesh from the live device pool and place host state on it.

    host_state: a numpy nest (e.g. from ``checkpoint.restore_latest`` with
    a numpy template).  spec_fn: leaf -> ``P`` (the same logical rules
    used at launch).  devices: default every visible CUDA device
    (``dist.sharding.default_devices``).  Returns (mesh, the nest of
    tensors on the mesh's first device).
    """
    devices = list(devices) if devices is not None else (
        SH.default_devices())
    dp, mp = best_mesh_shape(len(devices), model_parallel)
    mesh = SH.make_mesh((dp, mp), ("data", "model"), devices)
    _specs(host_state, spec_fn, mesh)
    first = mesh.shard_devices()[0]
    return mesh, _map(lambda leaf: to_tensor(leaf, device=first).reshape(
        np.shape(leaf)), host_state)
