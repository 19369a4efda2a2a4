"""Step-function builders (port of ``repro.launch.steps``: the LM, recsys
and GNN train steps; LM prefill and decode, fp and int8 KV cache;
retrieval; recsys serving).  Each returns a function of tensors with its
configuration closed over.  A train step is ``step(params, opt_state,
batch) -> (params, opt_state, {"loss", "grad_norm", "lr"})``: gradients
by autograd, then ``train.optimizer.adamw_update``.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from repro_torch.core.quant import QuantParams
from repro_torch.models import transformer as TF
from repro_torch.models.gnn import schnet as S
from repro_torch.models.recsys import models as RM
from repro_torch.models.recsys import retrieval as RT
from repro_torch.quantized import qkv_cache as QC
from repro_torch.train import optimizer as OPT
from repro_torch.train.train_loop import make_train_step


# --------------------------------------------------------------------------
# LM
# --------------------------------------------------------------------------

def make_lm_train_step(
    cfg: TF.LMConfig,
    opt_cfg: OPT.OptConfig,
    microbatches: int = 1,
    batch_axes: tuple[str, ...] | None = None,
    grad_specs=None,
) -> Callable:
    """Train step with in-step gradient accumulation
    (``train.make_train_step`` on ``transformer.lm_loss``).

    microbatches > 1 runs the batch's slices one after another, so the
    [B_micro, S, vocab] logits (the activation-memory hot spot at a 256k
    vocabulary) never exceed one microbatch; the gradients accumulate in
    float32.

    ``batch_axes`` and ``grad_specs`` are the reference's layout hints for
    GSPMD (keep the microbatch slices sharded over the batch axes, keep
    the float32 accumulators in the ZeRO layout).  One process holds the
    whole step on one device, so they are accepted and do nothing.
    """
    del batch_axes, grad_specs
    return make_train_step(partial(TF.lm_loss, cfg=cfg), opt_cfg,
                           microbatches)


def make_lm_prefill(cfg: TF.LMConfig) -> Callable:
    """``step(params, tokens)`` -> (last-position logits, kv caches)."""
    def step(params, tokens):
        return TF.prefill(params, tokens, cfg)

    return step


def make_lm_decode(cfg: TF.LMConfig) -> Callable:
    """``step(params, caches, token, cur_len)`` -> (logits, caches), the
    fp caches updated in place."""
    def step(params, caches, token, cur_len):
        return TF.decode_step(params, caches, token, cur_len, cfg)

    return step


def make_lm_decode_q8(cfg: TF.LMConfig) -> Callable:
    """Paper-quantized int8-KV decode (the beyond-baseline arm):
    ``step(params, qcache, token, cur_len)`` -> (logits, qcache)."""

    def step(params, qcache, token, cur_len):
        return QC.decode_step_q8(params, qcache, token, cur_len, cfg)

    return step


# --------------------------------------------------------------------------
# RecSys
# --------------------------------------------------------------------------

def make_recsys_train_step(cfg: RM.RecsysConfig,
                           opt_cfg: OPT.OptConfig) -> Callable:
    """One AdamW step on ``models.recsys.models.bce_loss``'s gradient."""
    return make_train_step(partial(RM.bce_loss, cfg=cfg), opt_cfg)


def make_recsys_serve(cfg: RM.RecsysConfig) -> Callable:
    """``step(params, batch)``: the CTR probabilities [B] of ``cfg``'s
    architecture (``models.recsys.models.serve``)."""
    def step(params, batch):
        return RM.serve(params, batch, cfg)

    return step


def make_retrieval(quantized: bool, k: int = 100) -> Callable:
    """1-query x n_candidates MIP scoring (the paper's search problem).

    Quantized: ``step(query_emb, cand_codes, lo, hi, zero)`` over int8
    candidate codes with abs-max Eq. 1 constants (B1 then B6 on the GPU);
    else ``step(query_emb, cand_table)`` in fp32.  The reference's
    ``use_pallas`` switch (TPU kernel or XLA dot) has no counterpart.
    """
    if quantized:
        def step(query_emb, cand_codes, lo, hi, zero):
            params = QuantParams(lo=lo, hi=hi, zero=zero, bits=8,
                                 scheme="absmax")
            return RT.retrieve_quantized(query_emb, cand_codes, params, k=k)

        return step

    def step(query_emb, cand_table):
        return RT.retrieve_fp32(query_emb, cand_table, k=k)

    return step


def make_retrieval_sharded(mesh, n_local: int, k: int = 100,
                           quantized: bool = True) -> Callable:
    """Distributed exhaustive MIP search: shard-local scoring and a local
    top-k on each shard's device, then one k-sized merge
    (``engine.distributed_topk``), O(Q * (N_loc + k)) working set a shard
    and O(shards * Q * k) gathered, never the full [Q, N] matrix.

    The candidate table is row-sharded in blocks of ``n_local`` (shard s
    owns rows ``[s * n_local, (s + 1) * n_local)``, a view of the table
    where the shard's device is the table's).  Quantized:
    ``step(query_emb, cand_codes, lo, hi, zero)``: each shard encodes the
    queries (B1 on the card) and scores its block (B6); else
    ``step(query_emb, cand_table)`` in fp32.  Block order is id order and
    each local top-k breaks ties to its lowest column, so the result
    equals ``make_retrieval``'s bit for bit.  The local top-k
    (``models.recsys.retrieval.top_k``) waits on the host twice, so shards
    on distinct cards would not overlap there.  (The reference also takes
    ``shard_idx``, which its ``shard_map`` needs; a loop over the mesh
    does not.)  The serving path shards through
    ``index.searcher(k, params, shards=mesh)`` instead.
    """
    from repro_torch import engine

    devs = mesh.shard_devices()
    offsets = [s * int(n_local) for s in range(len(devs))]

    def shards(table):
        if table.shape[0] != len(devs) * n_local:
            raise ValueError(
                f"the table holds {table.shape[0]} rows, not {len(devs)} "
                f"shards x n_local={n_local}")
        return [table[o:o + n_local].to(d) for o, d in zip(offsets, devs)]

    def merge(parts):
        return engine.distributed_topk([p[0] for p in parts],
                                       [p[1] for p in parts], k, offsets)

    if quantized:
        def step(query_emb, cand_codes, lo, hi, zero):
            parts = []
            for block, dev in zip(shards(cand_codes), devs):
                params = QuantParams(lo=lo.to(dev), hi=hi.to(dev),
                                     zero=zero.to(dev), bits=8,
                                     scheme="absmax")
                parts.append(RT.retrieve_quantized(query_emb.to(dev), block,
                                                   params, k=k))
            return merge(parts)

        return step

    def step(query_emb, cand_table):
        return merge([RT.retrieve_fp32(query_emb.to(dev), block, k=k)
                      for block, dev in zip(shards(cand_table), devs)])

    return step


# --------------------------------------------------------------------------
# GNN (SchNet)
# --------------------------------------------------------------------------

def _schnet_molecule_loss(params, batch, cfg: S.SchNetConfig, n_nodes: int,
                          n_graphs: int):
    out = S.forward(
        params, cfg,
        senders=batch["senders"], receivers=batch["receivers"],
        edge_mask=batch["edge_mask"], n_nodes=n_nodes,
        z=batch["z"], positions=batch["positions"],
    )[:, 0]
    energies = S._segment_sum(out, batch["graph_ids"], n_graphs)
    return torch.mean((energies - batch["labels"]) ** 2)


def _schnet_node_loss(params, batch, cfg: S.SchNetConfig, n_nodes: int):
    logits = S.forward(
        params, cfg,
        senders=batch["senders"], receivers=batch["receivers"],
        edge_mask=batch["edge_mask"], n_nodes=n_nodes,
        node_feat=batch["node_feat"],
    )
    return S._node_nll(logits, batch["labels"])


def make_gnn_train_step(
    cfg: S.SchNetConfig,
    kind: str,
    opt_cfg: OPT.OptConfig,
    n_nodes: int,
    n_graphs: int = 0,
) -> Callable:
    """SchNet's train step: ``kind`` "molecule" regresses per-molecule
    energies (batch: senders, receivers, edge_mask, z, positions,
    graph_ids, labels), any other kind classifies nodes (batch: senders,
    receivers, edge_mask, node_feat, labels)."""
    if kind == "molecule":
        loss = partial(
            _schnet_molecule_loss, cfg=cfg, n_nodes=n_nodes, n_graphs=n_graphs
        )
    else:
        loss = partial(_schnet_node_loss, cfg=cfg, n_nodes=n_nodes)
    return make_train_step(lambda p, b: (loss(p, b), {}), opt_cfg)
