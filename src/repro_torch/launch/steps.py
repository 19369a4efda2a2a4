"""Step-function builders (port of ``repro.launch.steps``: LM prefill and
decode, fp and int8 KV cache; retrieval; recsys serving).  Each returns a
function of tensors with its configuration closed over.  The GNN steps
and every training step come with later slices (ROADMAP queue A).
"""

from __future__ import annotations

from typing import Callable

from repro_torch.core.quant import QuantParams
from repro_torch.models import transformer as TF
from repro_torch.models.recsys import models as RM
from repro_torch.models.recsys import retrieval as RT
from repro_torch.quantized import qkv_cache as QC


# --------------------------------------------------------------------------
# LM
# --------------------------------------------------------------------------

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
