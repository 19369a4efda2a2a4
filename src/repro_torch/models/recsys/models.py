"""Recsys architecture configuration (port of the ``RecsysConfig`` part of
``repro.models.recsys.models``).  ``init_params``, ``loss`` and ``serve``
for the four kinds come with training (ROADMAP A16)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str                          # autoint | dlrm | dien | dcnv2
    n_dense: int
    vocab_sizes: tuple[int, ...]
    embed_dim: int
    # autoint
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    # dlrm
    bot_mlp: tuple[int, ...] = ()
    top_mlp: tuple[int, ...] = ()
    # dien
    seq_len: int = 0
    gru_dim: int = 0
    mlp: tuple[int, ...] = ()
    # dcn-v2
    n_cross_layers: int = 0
    dtype: str = "float32"

    @property
    def tdtype(self) -> torch.dtype:
        """The torch dtype named by ``dtype`` (the reference's ``jdtype``)."""
        return getattr(torch, self.dtype)

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    def param_count(self) -> int:
        counts = sum(v * self.embed_dim for v in self.vocab_sizes)
        return counts  # tables dominate; MLPs counted at init if needed
