"""Sparse embedding substrate for the recsys family (port of
``repro.models.recsys.embedding``).

Lookups are gathers (``index_select``); ragged bags reduce with
``index_add_`` (the reference's ``segment_sum``).  Random tables come from
an explicit ``torch.Generator`` in place of a ``jax.random`` key: the two
draw different numbers from one seed, so tests hand both packages the same
numpy tables.

The paper's technique lands here as :class:`QuantizedTable`: int8 codes +
per-dim Eq. 1 constants.  int8 cuts table memory 4x against fp32, and
retrieval scores int8 candidate tables with the B6 kernel
(``kernels.qmip``, ``models/recsys/retrieval.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core import quant as Qz
from repro_torch.device import resolve_device


def table_init(generator: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32, device=None):
    """{'table': [vocab, dim]} drawn N(0, 1) * dim^-1/2 from ``generator``,
    which must live on ``device`` (``None``: the GPU)."""
    dev = resolve_device(device)
    table = torch.randn((vocab, dim), generator=generator, dtype=dtype,
                        device=dev)
    return {"table": table * (dim ** -0.5)}


def multi_table_init(generator: torch.Generator, vocab_sizes: Sequence[int],
                     dim: int, dtype=torch.float32, device=None):
    """One table per field, drawn one after another from ``generator``."""
    return {f"t{i}": table_init(generator, v, dim, dtype, device)
            for i, v in enumerate(vocab_sizes)}


def lookup(table_params, ids: torch.Tensor) -> torch.Tensor:
    """Gather: ids [...] -> [..., dim].

    Dispatches on table format: dense {'table': f32 [V, d]} or the
    paper-quantized {'codes': int8 [V, d], 'scale': [d], 'zero': [d]}
    (the int8 gather moves 4x fewer bytes, dequantized after it).
    """
    if "codes" in table_params:
        rows = _take(table_params["codes"], ids)
        return (rows.to(torch.float32) * table_params["scale"]
                + table_params["zero"])
    return _take(table_params["table"], ids)


def _take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    ids = torch.as_tensor(ids, device=table.device)
    flat = table.index_select(0, ids.reshape(-1).to(torch.int64))
    return flat.reshape(*ids.shape, table.shape[1])


def multi_lookup(tables, sparse_ids: torch.Tensor) -> torch.Tensor:
    """sparse_ids [B, F] over F per-field tables -> [B, F, dim]."""
    cols = [lookup(tables[f"t{f}"], sparse_ids[:, f])
            for f in range(sparse_ids.shape[1])]
    return torch.stack(cols, dim=1)


def quantize_tables(tables, bits: int = 8):
    """Convert every dense per-field table to the int8 format (paper Eq. 1,
    abs-max constants): the serving-time compression step."""
    out = {}
    for name, tp in tables.items():
        table = tp["table"]
        p = Qz.learn_params(table, bits=bits, scheme=Qz.Scheme.ABSMAX)
        out[name] = {
            "codes": Qz.quantize(table, p),
            "scale": p.scale.to(torch.float32),
            "zero": p.zero.to(torch.float32),
        }
    return out


def embedding_bag(
    table_params,
    flat_ids: torch.Tensor,       # [T] gathered ids of all bags
    segment_ids: torch.Tensor,    # [T] bag index per id
    n_bags: int,
    weights: Optional[torch.Tensor] = None,
    combiner: str = "sum",
) -> torch.Tensor:
    """Ragged EmbeddingBag: gather + segment-reduce. Returns [n_bags, dim]."""
    table = table_params["table"]
    rows = _take(table, flat_ids)                          # [T, dim]
    if weights is not None:
        rows = rows * weights[:, None]
    seg = torch.as_tensor(segment_ids, device=table.device).to(torch.int64)
    summed = torch.zeros((n_bags, table.shape[1]), dtype=rows.dtype,
                         device=table.device).index_add_(0, seg, rows)
    if combiner == "sum":
        return summed
    counts = torch.zeros(n_bags, dtype=rows.dtype, device=table.device)
    counts.index_add_(0, seg, torch.ones_like(seg, dtype=rows.dtype))
    if combiner == "mean":
        return summed / torch.clamp_min(counts[:, None], 1.0)
    raise ValueError(combiner)


# --------------------------------------------------------------------------
# Quantized tables — the paper applied to embedding storage
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuantizedTable:
    codes: torch.Tensor               # [vocab, dim] int8
    params: Qz.QuantParams

    @staticmethod
    def from_dense(table: torch.Tensor, bits: int = 8,
                   scheme=Qz.Scheme.ABSMAX,
                   sigmas: float = 1.0) -> "QuantizedTable":
        """Eq. 1 constants learned on ``table`` and its codes, through the
        plain ``core.quant.quantize`` as the reference's does."""
        p = Qz.learn_params(table, bits=bits, scheme=scheme, sigmas=sigmas)
        return QuantizedTable(codes=Qz.quantize(table, p), params=p)

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """Dequantizing gather: int8 rows -> f32 embeddings."""
        return Qz.dequantize(_take(self.codes, ids), self.params)

    def lookup_codes(self, ids: torch.Tensor) -> torch.Tensor:
        """Integer-domain gather (for quantized scoring paths)."""
        return _take(self.codes, ids)

    def memory_bytes(self) -> int:
        return int(self.codes.numel()) + 3 * int(self.codes.shape[1]) * 4
