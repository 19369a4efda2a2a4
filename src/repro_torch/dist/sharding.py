"""Meshes and sharding rules (port of ``repro.dist.sharding``).

The mesh is in-process, as the reference's is: ``Mesh`` holds one
``torch.device`` a shard, in a numpy object array shaped like the mesh,
and a sharded plan launches each shard's work on its own device and
gathers the k-sized candidate lists onto the mesh's first device
(DESIGN.md §15).  A mesh may name one device more than once
(``make_mesh((4,), ("data",), ["cuda:0"] * 4)``): its shards then run one
after another on that device, with the same ids and scores as on four
cards.  There is no collective and no other process: ``shard_map`` has no
counterpart, and a sharded plan is a loop over the shards.  The flat and
pq kinds' row-sharded plans share their body here (``rows_placement``,
``row_blocks``, ``run_row_shards``).

One convention everywhere: the production mesh is ("data", "model"),
optionally prefixed by a "pod" axis, and every rule here degrades
gracefully: a dimension is only sharded when its size divides the axis
size, otherwise that dimension is replicated (``_spec_tree``).

The LM, recsys and GNN rules are spec functions: they map a nested dict
(or list) of shapes, or of anything with a ``.shape``, to the same nest of
``P`` specs, each wrapped in a ``Named`` (mesh, spec) pair.  Nothing here
moves a tensor; applying the specs to real parameters waits for the
port's models (ROADMAP queue A16).

Layout summary (DESIGN.md §4 records the serving side):
  * LM params: megatron-style: embed table vocab-sharded over "model";
    attention/MLP in-projections column-sharded, out-projections
    row-sharded over "model"; norms replicated.
  * ZeRO: gradient/optimizer accumulators additionally take "data" on
    their first replicated dimension (``lm_zero_spec``).
  * KV caches: batch-sharded over the data axes.
  * Recsys: big embedding tables row-sharded over ("data", "model")
    (DLRM hybrid parallelism); towers replicated.
  * GNN: edge lists sharded over the whole mesh; SchNet params replicated.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import numpy as np
import torch

__all__ = [
    "Mesh",
    "Named",
    "P",
    "make_mesh",
    "named",
    "replicated",
    "dp_axes",
    "corpus_shards",
    "sentinel_gids",
    "lm_params_sharding",
    "lm_opt_sharding",
    "lm_grad_specs",
    "lm_zero_spec",
    "lm_cache_spec",
    "recsys_params_sharding",
    "recsys_opt_sharding",
    "gnn_params_sharding",
    "gnn_edge_sharding",
]


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------

class Mesh:
    """An in-process device mesh: ``devices`` (a numpy object array of
    ``torch.device`` shaped like the mesh), ``axis_names`` and ``shape``
    (axis name -> size).  Every device is of one type, as in JAX."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(
                f"a mesh of shape {arr.shape} needs {arr.ndim} axis names, "
                f"got {axis_names!r}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        flat = [torch.device(d) for d in arr.flat]
        # "cuda" names the current card: pin it, so shard devices compare
        # equal to the devices tensors report
        flat = [torch.device("cuda", torch.cuda.current_device())
                if d.type == "cuda" and d.index is None else d for d in flat]
        types = {d.type for d in flat}
        if len(types) != 1:
            raise ValueError(
                f"a mesh holds devices of one type, got {sorted(types)}")
        out = np.empty(arr.shape, dtype=object)
        for i, d in enumerate(flat):
            out.flat[i] = d
        self.devices = out
        self.axis_names = axis_names

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def shard_devices(self) -> list[torch.device]:
        """The device of each shard, in shard order (row-major over the
        axes, as ``shard_map`` numbers them)."""
        return list(self.devices.flat)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def default_devices() -> list[torch.device]:
    """Every visible CUDA device (``device.resolve_device(None)``'s rule:
    raising where there is none, or the CPU where an applied runtime
    profile asks for it)."""
    from repro_torch.device import resolve_device

    dev = resolve_device(None)
    if dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices=None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (default: every visible CUDA
    device, raising where there is none unless a runtime profile asks for
    the CPU).  A device may appear more than once: ``["cuda:0"] * 4`` and
    ``["cpu"] * 4`` are legal four-shard meshes."""
    shape = tuple(int(s) for s in shape)
    devices = (default_devices() if devices is None
               else [torch.device(d) for d in devices])
    if math.prod(shape) != len(devices):
        raise ValueError(
            f"a mesh of shape {shape} needs {math.prod(shape)} devices, got "
            f"{len(devices)}")
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    return Mesh(arr.reshape(shape), axis_names)


class P(tuple):
    """A partition spec: one entry a dimension, each None (replicated), an
    axis name or a tuple of axis names (a 1-tuple reads as its name, as
    ``PartitionSpec`` normalizes it)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Named:
    """A spec over a mesh (``NamedSharding``'s counterpart)."""

    mesh: Any
    spec: P


# --------------------------------------------------------------------------
# generic helpers
# --------------------------------------------------------------------------

def named(mesh, spec: P) -> Named:
    return Named(mesh, spec)


def _is_shape(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(v, int) for v in x)


def _tree_map_with_path(fn: Callable, tree, path=()):
    """Map ``fn(path_str, leaf)`` over a nest of dicts / lists / tuples
    whose leaves are shape tuples or objects with a ``.shape``; paths
    join dict keys and sequence indices with "/" (the reference's
    ``_path_str``)."""
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_shape(tree):
        return type(tree)(_tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _leaf_shape(x) -> tuple[int, ...]:
    return tuple(x) if _is_shape(x) else tuple(getattr(x, "shape", ()))


def replicated(mesh, tree: Any):
    """Fully replicated spec for every leaf of ``tree``."""
    return _tree_map_with_path(lambda _p, _x: Named(mesh, P()), tree)


def dp_axes(mesh) -> tuple[str, ...]:
    """The mesh axes the global batch is sharded over."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def corpus_shards(mesh) -> tuple[tuple[str, ...], int]:
    """Row-sharding rule for serving corpora (DESIGN.md §4/§9).

    A corpus ``CodeStore`` shards its rows over *every* mesh axis (queries
    are replicated, so there is no reason to leave devices idle), and the
    Searcher's plan merges shard-local top-k with one k-sized cross-shard
    pass.  Returns (axes, n_shards).
    """
    return tuple(mesh.axis_names), int(mesh.devices.size)


def sentinel_gids(gids: torch.Tensor, valid: torch.Tensor, *, shard,
                  local_rows, n_total: int, padded_rows: int
                  ) -> torch.Tensor:
    """Replace invalid slots' gids with globally unique pad sentinels.

    A shard's pad rows keep an arithmetic gid ``shard*rows_per + lrow``
    that, for ``lrow >= rows_per``, lands inside the NEXT shard's id
    range.  Here every invalid slot instead gets

        ``n_total + shard * padded_rows + local_row``

    which is (a) ``>= n_total``, so it can never name a real row, and (b)
    unique across shards (each shard owns a disjoint ``padded_rows``-wide
    band).  Callers still NEG-mask the scores and map sentinels to ``-1``
    at the plan boundary; the sentinel is the belt under that.

    ``shard`` and ``local_rows`` broadcast against ``gids`` (int32).
    """
    dev = gids.device
    shard = torch.as_tensor(shard, dtype=torch.int32, device=dev)
    local_rows = torch.as_tensor(local_rows, dtype=torch.int32, device=dev)
    sent = int(n_total) + shard * int(padded_rows) + local_rows
    return torch.where(valid, gids.to(torch.int32), sent.to(torch.int32))


# --------------------------------------------------------------------------
# row-sharded plans: the body the flat and pq kinds' mesh plans share
# --------------------------------------------------------------------------

def rows_placement(placement, n: int, n_shards: int, who: str):
    """The ``rows`` placement a row-sharded plan over ``n`` rows scans: the
    given one, checked against the mesh and ``n``, or
    ``Placement.rows(n, n_shards)``."""
    from repro_torch.dist.placement import Placement

    if placement is None:
        return Placement.rows(n, n_shards)
    if placement.n_shards != n_shards:
        raise ValueError(
            f"placement covers {placement.n_shards} shards but the mesh has "
            f"{n_shards}"
        )
    if placement.kind != "rows":
        raise ValueError(
            f"{who} shards contiguous row blocks; got a {placement.kind!r} "
            "placement"
        )
    if placement.n_rows != n:
        raise ValueError(
            f"placement covers {placement.n_rows} rows but the store holds "
            f"{n}"
        )
    return placement


def row_blocks(placement, mesh) -> list[tuple[int, int, torch.device]]:
    """A ``rows`` placement's blocks in unit (= id) order: unit u's rows
    ``[lo, hi)`` (hi == lo for an empty one) and the device of the shard
    that owns it."""
    devs = mesh.shard_devices()
    bounds = np.cumsum((0, *placement.unit_sizes)).tolist()
    return [(bounds[u], bounds[u + 1], devs[shard])
            for u, shard in enumerate(placement.assign)]


def run_row_shards(shards, scan, Q: int, k_local: int, k: int, n: int,
                   offsets=0):
    """The request body of a row-sharded plan.  ``shards`` holds one
    ``(payload, device)`` a block of ``row_blocks``, payload None for an
    empty block; ``scan(payload, device)`` returns a block's (scores, ids,
    stats) at ``k_local``.  Every block is launched before the merge; an
    empty one contributes ``(NEG, -1)``.  The lists merge in block order
    (rebased by ``offsets``), ids >= n become -1, and the result is padded
    to [Q, k].  Returns (scores, ids, the blocks' summed ``chunks`` /
    ``bytes_read`` and whether any was ``tuned``)."""
    from repro_torch import engine
    from repro_torch.kernels.ref import NEG

    parts_s, parts_i = [], []
    agg = {"chunks": 0, "bytes_read": 0, "tuned": False}
    for payload, dev in shards:
        if payload is None:
            parts_s.append(torch.full((Q, k_local), NEG, dtype=torch.float32,
                                      device=dev))
            parts_i.append(torch.full((Q, k_local), -1, dtype=torch.int32,
                                      device=dev))
            continue
        s, i, st = scan(payload, dev)
        parts_s.append(s)
        parts_i.append(i)
        agg["chunks"] += st["chunks"]
        agg["bytes_read"] += st["bytes_read"]
        agg["tuned"] = agg["tuned"] or st["tuned"]
    k_merge = min(k, n)
    s, i = engine.distributed_topk(parts_s, parts_i, k_merge, offsets)
    i = torch.where(i >= n, -1, i)           # nothing >= n leaves the plan
    if k_merge < k:                          # uniform [Q, k] contract
        s = torch.nn.functional.pad(s, (0, k - k_merge), value=NEG)
        i = torch.nn.functional.pad(i, (0, k - k_merge), value=-1)
    return s, i, agg


def _axes_size(mesh, axes: str | tuple[str, ...]) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.shape[a] for a in axes)


def _divisible(shape: tuple[int, ...], dim: int, mesh, axes) -> bool:
    return dim < len(shape) and shape[dim] % max(_axes_size(mesh, axes), 1) == 0


def _spec_tree(mesh, tree: Any, rule) -> Any:
    """Nest of ``Named`` from ``rule(path_str, shape) -> P``, replicating
    each dimension whose size the rule's axes do not divide."""

    def leaf(path, x):
        shape = _leaf_shape(x)
        spec = rule(path, shape)
        fixed = [entry if entry is not None
                 and _divisible(shape, dim, mesh, entry) else None
                 for dim, entry in enumerate(spec)]
        return Named(mesh, P(*fixed))

    return _tree_map_with_path(leaf, tree)


# --------------------------------------------------------------------------
# LM rules (megatron-style tensor parallelism over "model")
# --------------------------------------------------------------------------

# param-name suffixes whose *last* dim is column-sharded ("model")
_COL_KEYS = ("gate", "up", "wq", "wk", "wv", "w_gate", "router")
# suffixes whose *first matrix* dim is row-sharded (outputs get reduced)
_ROW_KEYS = ("down", "wo", "w_down")


def _lm_rule(path: str, shape: tuple[int, ...]) -> P:
    nd = len(shape)
    if nd <= 1:
        return P()                                     # norms, biases, scalars
    pad = [None] * (nd - 2)                            # leading vmapped block dims
    last2 = P(*pad, None, None)
    if "embed" in path and "table" in path:
        return P(*([None] * (nd - 2)), "model", None)  # vocab-sharded
    for key in _ROW_KEYS:
        if f"/{key}/" in path or path.endswith(f"/{key}/w"):
            return P(*pad, "model", None)
    for key in _COL_KEYS:
        if f"/{key}/" in path:
            return P(*pad, None, "model")
    return last2


def lm_params_sharding(mesh, aparams: Any):
    """Spec nest mirroring an LM parameter-shape nest."""
    return _spec_tree(mesh, aparams, _lm_rule)


def lm_opt_sharding(mesh, aopt: Any):
    """Optimizer state: mu/nu mirror the param layout; counters replicate."""
    return _spec_tree(mesh, aopt, _lm_rule)


def lm_zero_spec(path: str, leaf) -> P:
    """ZeRO accumulator spec: the param's "model" layout plus "data" on the
    first still-replicated dimension, so grad/optimizer accumulators live
    as 1/(data*model) slices instead of data-replicated copies."""
    if _is_shape(leaf):
        shape = tuple(leaf)
    else:
        shape = tuple(getattr(leaf, "shape",
                              (1,) * getattr(leaf, "ndim", 0)))
    base = list(_lm_rule(path, shape))
    base += [None] * (len(shape) - len(base))
    for dim, entry in enumerate(base):
        if entry is None:
            base[dim] = "data"
            break
    return P(*base)


def lm_grad_specs(aparams: Any):
    """``P`` nest (no mesh) for gradient accumulators, ZeRO layout."""
    return _tree_map_with_path(lm_zero_spec, aparams)


def lm_cache_spec(mesh, batch: int) -> Named:
    """KV cache [n_blocks, block_layers, B, S, Hkv, hd]: batch-sharded over
    the data axes when divisible, replicated otherwise (tiny decode B)."""
    dp = dp_axes(mesh)
    if dp and batch % _axes_size(mesh, dp) == 0:
        return Named(mesh, P(None, None, dp, None, None, None))
    return Named(mesh, P())


# --------------------------------------------------------------------------
# Recsys rules (DLRM hybrid parallelism)
# --------------------------------------------------------------------------

_TABLE_MIN_ROWS = 4096  # below this, tables replicate (the dry-run's pad rule)


def _recsys_rule_for(mesh):
    shards = (_axes_size(mesh, dp_axes(mesh) + ("model",))
              if "model" in mesh.axis_names else 1)

    def rule(path: str, shape: tuple[int, ...]) -> P:
        table_axes = tuple(a for a in ("data", "model") if a in mesh.axis_names)
        if (
            ("tables" in path or "codes" in path)
            and len(shape) == 2
            and shape[0] >= max(shards, _TABLE_MIN_ROWS)
        ):
            return P(table_axes, None)   # row-sharded embedding table
        return P(*([None] * len(shape)))  # towers/interactions replicate

    return rule


def recsys_params_sharding(mesh, aparams: Any):
    return _spec_tree(mesh, aparams, _recsys_rule_for(mesh))


def recsys_opt_sharding(mesh, aopt: Any):
    return _spec_tree(mesh, aopt, _recsys_rule_for(mesh))


# --------------------------------------------------------------------------
# GNN rules
# --------------------------------------------------------------------------

def gnn_params_sharding(mesh, aparams: Any):
    """SchNet is tiny: replicate everything."""
    return replicated(mesh, aparams)


def gnn_edge_sharding(mesh) -> Named:
    """Edge lists are padded to the full mesh size and sharded over it."""
    return Named(mesh, P(tuple(mesh.axis_names)))
