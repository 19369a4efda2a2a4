"""Recall@k, the paper's §5.3 quality metric (port of
``repro.core.preserve.recall_at_k``)."""

from __future__ import annotations

import torch


def recall_at_k(exact_ids: torch.Tensor, approx_ids: torch.Tensor) -> float:
    """|S_E ∩ S_A| / |S_E| averaged over queries; both [Q, k] int ids."""
    exact_ids = torch.as_tensor(exact_ids)
    approx_ids = torch.as_tensor(approx_ids).to(exact_ids.device)
    hits = (exact_ids[:, :, None] == approx_ids[:, None, :]).any(-1)
    return float(torch.mean(hits.sum(-1).to(torch.float64)
                            / exact_ids.shape[1]))
