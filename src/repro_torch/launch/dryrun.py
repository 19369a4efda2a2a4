"""Multi-pod dry run over the meta device (port of ``repro.launch.dryrun``).

The reference lowers and compiles every (architecture x input shape x
mesh) cell on 256 and 512 host devices and records XLA's
``memory_analysis``, ``cost_analysis`` and the partitioned HLO's
collectives.  Here each cell is built on a mesh of meta devices
(``[torch.device("meta")] * 256``, or 512 with the "pod" axis first) and
its step runs once on the meta device: every tensor has a shape and a
dtype and no storage, so nothing is allocated and no card is touched.
This is the one entry point of the port that runs neither on the card nor
on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.dryrun                  # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch lpq-ann --variant int8

Each builder returns ``(fn, args, in_specs, out_specs)``: the step, its
arguments as meta tensors of the reference's shapes and dtypes (the
parameters from ``abstract_params`` / ``init_params(..., device="meta")``,
AdamW state from ``adamw_init`` on them), and the ``dist.sharding`` spec
nests of the arguments and of the outputs.  The reference's
``ShapeDtypeStruct`` carries its sharding; a meta tensor has no place for
one, so the specs travel beside it.  A spec that is one ``Named`` covers
every leaf below it.

A record keeps the reference's keys ``arch``, ``shape``, ``variant``,
``mesh`` and ``n_devices``, and fills these:

  * ``compile_seconds``: the seconds to build the cell and run its step
    once on the meta device (there is no compilation);
  * ``flops``: the step's FLOPs over the global batch by
    ``torch.utils.flop_counter.FlopCounterMode``'s table (``MetaRun``;
    the tests hold it equal to ``FlopCounterMode``'s count of the same
    step on CPU tensors).  It counts matrix products (``mm``, ``bmm``,
    ``addmm``, ...) and convolutions only, where XLA's ``cost_analysis``
    also counts elementwise work;
  * ``memory_analysis``: ``argument_size_in_bytes`` and
    ``output_size_in_bytes`` per shard, each leaf's bytes over the shards
    of its spec (the product of the mesh axes it names, a ceiling a
    dimension), and ``alias_size_in_bytes``, the per-shard bytes of the
    donated arguments (the reference's donate table: a train step donates
    its parameters and optimizer state, a decode step its cache).  A
    Python int argument counts as an int32 scalar.

What the port cannot fill without XLA is absent (not written as 0):
``bytes_accessed``, ``collectives`` (there is no partitioned HLO; one
process runs the global step), ``temp_size_in_bytes`` and
``generated_code_size_in_bytes``.  ``collective_bytes`` is the
reference's HLO parser, kept so a reference HLO dump can be read.

The outputs' specs follow the reference's ``out_shardings`` where it gives
them (prefill: the caches batch-sharded); elsewhere XLA chooses, and the
port states its choice: a train step's parameters and state keep their
input layout (they are donated), its metrics replicate; a decode step's
logits and a serve step's probabilities shard over the batch axes where
the batch divides them, and its cache keeps its input layout; retrieval
results replicate.

The host reads each cell reaches take a path that uses shapes alone on a
meta tensor, and nothing changes on a CPU or CUDA tensor:

  * ``models/flash.py`` ``_Layout``: the tile skip reads the query
    positions' bounds on the host.  ``transformer.forward`` makes its
    positions (``torch.arange(S)``) on the host where the model runs on
    the meta device, and ``attention.blockwise_attention`` /
    ``flash.flash_attention`` keep them there (``flash.positions``), so
    the live tiles, and the FLOPs counted, are the card's;
  * ``models/recsys/retrieval.py`` ``top_k``: returns its [Q, k] float32
    scores and int32 columns without its two host waits (a NaN test and
    ``torch.nonzero``);
  * the wrappers of B1 and B6-B8 (``kernels/quantize.py``, ``qmip.py``,
    ``ql2.py``, ``packed.py``; ``kernels.ref.PLAIN``): a meta tensor runs
    the plain version, as a CPU tensor does (the int8 retrieval cells
    reach B1 and B6; no cell reaches B2-B5);
  * a decode step's ``cur_len`` is the Python int S - 1 (the last slot of
    the S-long cache): ``transformer.decode_step`` checks it against the
    cache on the host, and a meta scalar holds no value.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import time
import traceback
from typing import Any, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import cells, get
from repro_torch.dist import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as TF
from repro_torch.train import optimizer as OPT

META = torch.device("meta")


# --------------------------------------------------------------------------
# collective-byte accounting from a partitioned HLO (the reference's parser)
# --------------------------------------------------------------------------

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_SHAPE_RE = re.compile(r"\b([a-z]+[0-9]+)\[([0-9,]*)\]")
_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    for prefix, size in _DTYPE_BYTES.items():
        if dtype.startswith(prefix):
            return n * size
    return n * 4


def collective_bytes(hlo_text: str) -> dict:
    """Sum output bytes of every collective op in the partitioned module."""
    out = {k: 0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        stripped = line.strip()
        for coll in _COLLECTIVES:
            # result shapes appear between "=" and "<coll>(" on the
            # defining line:  %name = f32[..]{..} all-reduce(...)
            marker = f" {coll}("
            alt = f" {coll}-start("
            pos = stripped.find(marker)
            if pos < 0:
                pos = stripped.find(alt)
            eq = stripped.find(" = ")
            if pos > 0 and 0 < eq < pos:
                lhs = stripped[eq:pos]
                total = sum(
                    _shape_bytes(dt, dims) for dt, dims in _SHAPE_RE.findall(lhs)
                )
                out[coll] += total
                counts[coll] += 1
                break
    return {"bytes": out, "counts": counts, "total_bytes": sum(out.values())}


# --------------------------------------------------------------------------
# meshes, meta tensors and per-shard bytes
# --------------------------------------------------------------------------

class Cell(NamedTuple):
    """A built cell: the step, its arguments, their specs and the specs
    of its outputs."""

    fn: Any
    args: tuple
    in_specs: tuple
    out_specs: Any


def meta_mesh(multi_pod: bool = False):
    """The production mesh over meta devices: 16x16 ("data", "model"), or
    2x16x16 with "pod" first."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return SH.make_mesh(shape, axes, devices=[META] * math.prod(shape))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _pad_to(n: int, m: int) -> int:
    """Round n up to a multiple of m (shard-boundary padding — standard
    practice for vocabularies / tables / edge lists on SPMD meshes)."""
    return ((n + m - 1) // m) * m


def _shards(mesh, entry) -> int:
    if entry is None:
        return 1
    axes = (entry,) if isinstance(entry, str) else entry
    return math.prod(mesh.shape[a] for a in axes)


def shard_bytes(x, spec) -> int:
    """One leaf's bytes on one shard under ``spec`` (a ``Named``; None
    replicates): each dimension cut into its axes' shard count, rounded
    up."""
    if isinstance(x, int):
        return 4
    if spec is None:
        return x.numel() * x.element_size()
    n = x.element_size()
    entries = tuple(spec.spec) + (None,) * (x.dim() - len(spec.spec))
    for dim, entry in zip(x.shape, entries):
        n *= -(-dim // _shards(spec.mesh, entry))
    return n


def _children(tree):
    if isinstance(tree, dict):
        return list(tree.items())
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def tree_bytes(tree, specs) -> int:
    """Per-shard bytes of every tensor (and int) leaf of ``tree``, paired
    with ``specs``: a nest of the same structure, or one ``Named`` (or
    None) for everything below."""
    if torch.is_tensor(tree) or isinstance(tree, int):
        return shard_bytes(tree, specs)
    kids = _children(tree)
    if kids is None:
        return 0
    total = 0
    for key, sub in kids:
        if isinstance(specs, SH.Named) or specs is None:
            total += tree_bytes(sub, specs)
        else:
            total += tree_bytes(sub, specs[key])
    return total


# --------------------------------------------------------------------------
# cell builders
# --------------------------------------------------------------------------

def build_lm_cell(arch_id: str, shape_name: str, mesh,
                  variant: str = "baseline") -> Cell:
    mod = get(arch_id)
    cfg: TF.LMConfig = mod.config()
    spec = mod.SHAPES[shape_name]
    B, S = spec["global_batch"], spec["seq_len"]
    dp = SH.dp_axes(mesh)
    rep = SH.named(mesh, SH.P())
    batch_spec = SH.named(mesh, SH.P(dp, None))

    params = TF.abstract_params(cfg)
    p_shard = SH.lm_params_sharding(mesh, params)

    if spec["kind"] == "train":
        opt_cfg = OPT.OptConfig(
            schedule=getattr(mod, "OPTIMIZER_SCHEDULE", "cosine"),
            total_steps=10000)
        opt = OPT.adamw_init(params)
        o_shard = SH.lm_opt_sharding(mesh, opt)
        batch = {"tokens": _meta((B, S), torch.int32),
                 "targets": _meta((B, S), torch.int32),
                 "mask": _meta((B, S), torch.float32)}
        # grad accumulation keeps the [B_micro, S, vocab] logits inside the
        # 16 GB/chip envelope at 256k vocab (the reference's comment)
        micro = getattr(mod, "TRAIN_MICROBATCHES", 4)
        fn = ST.make_lm_train_step(cfg, opt_cfg, microbatches=micro,
                                   batch_axes=dp,
                                   grad_specs=SH.lm_grad_specs(params))
        return Cell(fn, (params, opt, batch), (p_shard, o_shard, batch_spec),
                    (p_shard, o_shard, rep))

    c_shard = SH.lm_cache_spec(mesh, B)
    if spec["kind"] == "prefill":
        tokens = _meta((B, S), torch.int32)
        return Cell(ST.make_lm_prefill(cfg), (params, tokens),
                    (p_shard, batch_spec), (rep, (c_shard, c_shard)))

    # decode: one new token against an S-long cache (block-major layout)
    cache_shape = TF.cache_shape(cfg, B, S)
    tok_spec = batch_spec if B > 1 else SH.named(mesh, SH.P(None, None))
    token = _meta((B, 1), torch.int32)
    cur_len = S - 1
    logit_spec = tok_spec
    if variant == "int8kv":
        # the paper-quantized cache: int8 codes + per (block, sub, Hkv, hd)
        # scales, 2x less memory than the bf16 baseline cache
        from repro_torch.quantized.qkv_cache import QuantizedCache

        sshape = (cfg.n_blocks, cfg.block_layers, cfg.n_kv, cfg.head_dim)
        qcache = QuantizedCache(
            k_codes=_meta(cache_shape, torch.int8),
            v_codes=_meta(cache_shape, torch.int8),
            k_scale=_meta(sshape, torch.float32),
            v_scale=_meta(sshape, torch.float32))
        q_spec = {"k_codes": c_shard, "v_codes": c_shard, "k_scale": rep,
                  "v_scale": rep}
        return Cell(ST.make_lm_decode_q8(cfg),
                    (params, qcache, token, cur_len),
                    (p_shard, q_spec, tok_spec, rep), (logit_spec, q_spec))

    caches = (_meta(cache_shape, cfg.tdtype), _meta(cache_shape, cfg.tdtype))
    return Cell(ST.make_lm_decode(cfg), (params, caches, token, cur_len),
                (p_shard, (c_shard, c_shard), tok_spec, rep),
                (logit_spec, (c_shard, c_shard)))


def build_recsys_cell(arch_id: str, shape_name: str, mesh,
                      variant: str = "fp32") -> Cell:
    from repro_torch.models.recsys import models as RM

    mod = get(arch_id)
    cfg: RM.RecsysConfig = mod.config()
    spec = mod.SHAPES[shape_name]
    dp = SH.dp_axes(mesh)
    rep = SH.named(mesh, SH.P())
    table_shards = mesh.shape.get("data", 1) * mesh.shape["model"]

    # pad sharded tables to the shard boundary (replicated small tables keep
    # their exact size: recsys_params_sharding's threshold)
    padded_vocabs = tuple(
        _pad_to(v, table_shards) if v >= max(table_shards, 4096) else v
        for v in cfg.vocab_sizes
    )
    cfg = dataclasses.replace(cfg, vocab_sizes=padded_vocabs)

    if spec["kind"] == "retrieval":
        d = cfg.embed_dim
        N = _pad_to(spec["n_candidates"], table_shards)
        Q = spec["batch"]
        cand_shard = SH.named(mesh, SH.P(("data", "model"), None))
        q_in = _meta((Q, d), torch.float32)
        if variant == "int8":
            cand = _meta((N, d), torch.int8)
            consts = tuple(_meta((d,), torch.float32) for _ in range(3))
            return Cell(ST.make_retrieval(True), (q_in, cand, *consts),
                        (rep, cand_shard, rep, rep, rep), rep)
        cand = _meta((N, d), torch.float32)
        return Cell(ST.make_retrieval(False), (q_in, cand),
                    (rep, cand_shard), rep)

    params = RM.abstract_params(cfg)
    if variant == "int8" and spec["kind"] == "serve":
        # paper-quantized serving tables: int8 codes + per-dim constants;
        # gathered rows cross memory and the mesh at 1/4 the bytes
        params = dict(params)
        params["tables"] = {
            name: {"codes": _meta(tp["table"].shape, torch.int8),
                   "scale": _meta(tp["table"].shape[1:], torch.float32),
                   "zero": _meta(tp["table"].shape[1:], torch.float32)}
            for name, tp in params["tables"].items()}
    p_shard = SH.recsys_params_sharding(mesh, params)

    B = spec["batch"]
    rows = SH.named(mesh, SH.P(dp, None))
    batch = {"dense": _meta((B, cfg.n_dense), torch.float32),
             "sparse": _meta((B, cfg.n_sparse), torch.int32),
             "label": _meta((B,), torch.float32)}
    b_spec = {"dense": rows, "sparse": rows,
              "label": SH.named(mesh, SH.P(dp))}
    if cfg.seq_len:
        batch["hist_ids"] = _meta((B, cfg.seq_len), torch.int32)
        batch["hist_mask"] = _meta((B, cfg.seq_len), torch.float32)
        b_spec["hist_ids"] = b_spec["hist_mask"] = rows

    if spec["kind"] == "train":
        opt_cfg = OPT.OptConfig()
        opt = OPT.adamw_init(params)
        o_shard = SH.recsys_opt_sharding(mesh, opt)
        return Cell(ST.make_recsys_train_step(cfg, opt_cfg),
                    (params, opt, batch), (p_shard, o_shard, b_spec),
                    (p_shard, o_shard, rep))

    return Cell(ST.make_recsys_serve(cfg), (params, batch), (p_shard, b_spec),
                b_spec["label"])


def build_gnn_cell(arch_id: str, shape_name: str, mesh) -> Cell:
    from repro_torch.models.gnn import schnet as S

    mod = get(arch_id)
    spec = mod.SHAPES[shape_name]
    cfg: S.SchNetConfig = mod.config(shape_name)
    opt_cfg = OPT.OptConfig()
    rep = SH.named(mesh, SH.P())
    e_shard = SH.gnn_edge_sharding(mesh)

    params = S.init_params(torch.Generator(), cfg, device=META)
    p_shard = SH.gnn_params_sharding(mesh, params)
    opt = OPT.adamw_init(params)
    o_shard = SH.replicated(mesh, opt)

    n_mesh = mesh.size
    if spec["kind"] == "molecule":
        n_nodes = spec["batch"] * spec["n_nodes"]
        n_edges = _pad_to(spec["batch"] * spec["n_edges"], n_mesh)
        batch = {"z": _meta((n_nodes,), torch.int32),
                 "positions": _meta((n_nodes, 3), torch.float32),
                 "senders": _meta((n_edges,), torch.int32),
                 "receivers": _meta((n_edges,), torch.int32),
                 "edge_mask": _meta((n_edges,), torch.bool),
                 "graph_ids": _meta((n_nodes,), torch.int32),
                 "labels": _meta((spec["batch"],), torch.float32)}
        fn = ST.make_gnn_train_step(cfg, "molecule", opt_cfg, n_nodes=n_nodes,
                                    n_graphs=spec["batch"])
    else:
        if spec["kind"] == "minibatch":
            n_nodes, n_edges = spec["pad_nodes"], spec["pad_edges"]
        else:
            n_nodes, n_edges = spec["n_nodes"], spec["n_edges"]
        n_edges = _pad_to(n_edges, n_mesh)   # edge lists pad to the mesh size
        batch = {"node_feat": _meta((n_nodes, spec["d_feat"]), torch.float32),
                 "senders": _meta((n_edges,), torch.int32),
                 "receivers": _meta((n_edges,), torch.int32),
                 "edge_mask": _meta((n_edges,), torch.bool),
                 "labels": _meta((n_nodes,), torch.int32)}
        fn = ST.make_gnn_train_step(cfg, spec["kind"], opt_cfg,
                                    n_nodes=n_nodes)
    b_spec = {k: e_shard if k in ("senders", "receivers", "edge_mask")
              else rep for k in batch}
    return Cell(fn, (params, opt, batch), (p_shard, o_shard, b_spec),
                (p_shard, o_shard, rep))


_ANN = {"product60m": dict(n=60_000_000, d=256),
        "sift1m": dict(n=1_000_000, d=128),
        "glove100": dict(n=1_183_514, d=100)}


def build_ann_cell(shape_name: str, mesh, variant: str = "baseline") -> Cell:
    """The paper's own system at FULL scale: PRODUCT60M (60M x 256) /
    SIFT1M / Glove100 exhaustive quantized MIP search, corpus row-sharded
    over the production mesh, 1000-query batch (the paper's test-set
    size), k=100 (the paper's §5.1 fixed k).  ``naive`` is the unsharded
    ``make_retrieval`` arm, ``fp32`` the sharded fp32 one, anything else
    the sharded int8 arm.  The reference's ``shard_idx`` argument feeds
    its ``shard_map``; the port's sharded step loops over the mesh and
    takes none."""
    spec = _ANN[shape_name]
    n_shards = mesh.shape.get("data", 1) * mesh.shape["model"]
    N = _pad_to(spec["n"], n_shards)
    d = spec["d"]
    Q = 1000
    rep = SH.named(mesh, SH.P())
    cand_shard = SH.named(mesh, SH.P(("data", "model"), None))
    q_in = _meta((Q, d), torch.float32)
    n_local = N // n_shards
    # each shard's block runs on its own (meta) device: a mesh of the
    # table's shard count, as the reference's shard_map over its axes
    shard_mesh = SH.make_mesh((n_shards,), ("shard",),
                              devices=[META] * n_shards)
    if variant == "fp32":
        cand = _meta((N, d), torch.float32)
        fn = ST.make_retrieval_sharded(shard_mesh, n_local, k=100,
                                       quantized=False)
        return Cell(fn, (q_in, cand), (rep, cand_shard), rep)
    cand = _meta((N, d), torch.int8)
    consts = tuple(_meta((d,), torch.float32) for _ in range(3))
    specs = (rep, cand_shard, rep, rep, rep)
    if variant == "naive":
        # the plain formulation kept as the measured regression arm
        return Cell(ST.make_retrieval(True, k=100), (q_in, cand, *consts),
                    specs, rep)
    fn = ST.make_retrieval_sharded(shard_mesh, n_local, k=100, quantized=True)
    return Cell(fn, (q_in, cand, *consts), specs, rep)


def build_cell(arch_id: str, shape_name: str, mesh,
               variant: str = "baseline") -> Cell:
    family = get(arch_id).FAMILY
    if family == "ann":
        return build_ann_cell(shape_name, mesh, variant=variant)
    if family == "lm":
        return build_lm_cell(arch_id, shape_name, mesh, variant=variant)
    if family == "recsys":
        v = "int8" if variant == "int8" else "fp32"
        return build_recsys_cell(arch_id, shape_name, mesh, variant=v)
    if family == "gnn":
        return build_gnn_cell(arch_id, shape_name, mesh)
    raise ValueError(family)


# --------------------------------------------------------------------------
# run + record
# --------------------------------------------------------------------------

#: production aliasing (the reference's): train steps donate (params, opt);
#: decode donates the KV cache
DONATE = {"train": (0, 1), "full_graph": (0, 1), "minibatch": (0, 1),
          "molecule": (0, 1), "decode": (1,)}


class _Uncached(Exception):
    pass


def _sig(x):
    """A hashable stand-in for one argument of an op: a meta tensor's
    shape, strides, dtype and offset; a scalar with its type."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _Uncached
        return (tuple(x.shape), x.stride(), x.dtype, x.storage_offset())
    if isinstance(x, (list, tuple)):
        return tuple(_sig(v) for v in x)
    return (type(x), x)


class MetaRun(TorchDispatchMode):
    """Runs a step on the meta device and counts its FLOPs.

    The count is ``FlopCounterMode``'s: each op in its table
    (``torch.utils.flop_counter.flop_registry``, matrix products and
    convolutions) adds that table's formula of its shapes.  An op that
    writes nothing and returns no view is given, on a second call with the
    same metadata (shapes, strides, dtypes, scalars), fresh meta tensors of
    the first call's output metadata: PyTorch's meta kernels for pointwise
    ops are Python and cost 0.1-0.7 ms a call, and the flash tile loops
    repeat a few shapes hundreds of thousands of times.  Views and
    in-place ops always run (their C++ kernels are cheap)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self._memo: dict = {}
        self._pure: dict = {}

    def _key(self, func, args, kwargs):
        pure = self._pure.get(func)
        if pure is None:
            schema = func._schema
            pure = self._pure[func] = not schema.is_mutable and all(
                r.alias_info is None for r in schema.returns)
        if not pure:
            return None
        try:
            key = (func, _sig(args), _sig(tuple(sorted(kwargs.items()))))
            hash(key)
        except (_Uncached, TypeError):
            return None
        return key

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = self._key(func, args, kwargs)
        hit = None if key is None else self._memo.get(key)
        if hit is None:
            out = func(*args, **kwargs)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            if key is not None and all(
                    isinstance(o, torch.Tensor) and o.device.type == "meta"
                    for o in outs):
                self._memo[key] = (isinstance(out, (tuple, list)), [
                    (tuple(o.shape), o.stride(), o.dtype) for o in outs])
        else:
            many, metas = hit
            outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                        device=META)
                    for shape, stride, dtype in metas]
            out = tuple(outs) if many else outs[0]
        count = flop_registry.get(func.overloadpacket)
        if count is not None:
            self.flops += int(count(*args, **kwargs, out_val=out))
        return out


def count_flops(fn, args) -> tuple[int, Any]:
    """(matrix-product FLOPs, outputs) of one call of ``fn(*args)`` on the
    meta device (``MetaRun``)."""
    with MetaRun() as run:
        out = fn(*args)
    return run.flops, out


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             variant: str = "baseline") -> dict:
    t0 = time.perf_counter()
    mesh = meta_mesh(multi_pod)
    cell = build_cell(arch_id, shape_name, mesh, variant)
    flops, out = count_flops(cell.fn, cell.args)
    seconds = time.perf_counter() - t0
    kind = get(arch_id).SHAPES[shape_name].get("kind", "")
    donate = DONATE.get(kind, ())
    return {
        "arch": arch_id,
        "shape": shape_name,
        "variant": variant,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": mesh.size,
        "compile_seconds": round(seconds, 3),
        "flops": float(flops),
        "memory_analysis": {
            "argument_size_in_bytes": tree_bytes(cell.args, cell.in_specs),
            "output_size_in_bytes": tree_bytes(out, cell.out_specs),
            "alias_size_in_bytes": sum(
                tree_bytes(cell.args[i], cell.in_specs[i]) for i in donate),
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", choices=["no", "yes", "both"], default="both")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    pods = {"no": [False], "yes": [True], "both": [False, True]}[args.multi_pod]

    todo = []
    pool = list(cells())
    if args.arch == "lpq-ann":
        pool = [("lpq-ann", s, None) for s in get("lpq-ann").SHAPES]
    for arch_id, shape, skip in pool:
        if args.arch and arch_id != args.arch:
            continue
        if args.shape and shape != args.shape:
            continue
        todo.append((arch_id, shape, skip))

    n_ok = n_skip = n_fail = 0
    t0 = time.perf_counter()
    for arch_id, shape, skip in todo:
        for mp in pods:
            tag = f"{arch_id}__{shape}__{'multipod' if mp else 'pod'}"
            if args.variant != "baseline":
                tag += f"__{args.variant}"
            path = os.path.join(args.out, tag + ".json")
            if args.skip_existing and os.path.exists(path):
                print(f"[dryrun] SKIP (exists) {tag}")
                continue
            if skip:
                with open(path, "w") as f:
                    json.dump({"arch": arch_id, "shape": shape,
                               "mesh": "2x16x16" if mp else "16x16",
                               "skipped": skip}, f, indent=2)
                print(f"[dryrun] SKIP {tag}: {skip}")
                n_skip += 1
                continue
            try:
                rec = run_cell(arch_id, shape, mp, args.variant)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2)
                mem = rec["memory_analysis"]
                print(
                    f"[dryrun] OK {tag}: {rec['compile_seconds']}s, "
                    f"flops={rec['flops']:.3e}, "
                    f"args={mem['argument_size_in_bytes']:.3e}B/shard"
                )
                n_ok += 1
            except Exception as e:  # noqa: BLE001
                n_fail += 1
                print(f"[dryrun] FAIL {tag}: {e}")
                traceback.print_exc()
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_fail} failed "
          f"({time.perf_counter() - t0:.1f} s on the host)")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
