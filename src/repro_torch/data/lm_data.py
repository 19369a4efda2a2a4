"""Synthetic LM token pipeline (port of ``repro.data.lm_data``):
deterministic and infinite.

A batch is {tokens, targets, mask}: tokens [B, S] int32, targets the
tokens shifted by one, mask float32 ones.  Draws come from a
``torch.Generator``; the reference's ``jax.random`` streams cannot be
reproduced, so parity tests carry its tokens across as numpy arrays.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


def lm_batch(generator: torch.Generator, batch: int, seq_len: int,
             vocab: int, device=None) -> dict[str, torch.Tensor]:
    """One causal-LM batch: tokens + next-token targets + loss mask, on
    ``device`` (``None``: the GPU; ``generator`` must live there)."""
    dev = resolve_device(device)
    toks = torch.randint(0, vocab, (batch, seq_len + 1), generator=generator,
                         dtype=torch.int32, device=dev)
    return {
        "tokens": toks[:, :-1],
        "targets": toks[:, 1:],
        "mask": torch.ones((batch, seq_len), dtype=torch.float32, device=dev),
    }


def step_seed(seed: int, step: int) -> int:
    """The generator seed of batch ``step`` in stream ``seed``."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0])


def batch_iterator(batch: int, seq_len: int, vocab: int, seed: int = 0,
                   start_step: int = 0,
                   device=None) -> Iterator[dict[str, torch.Tensor]]:
    """Infinite deterministic batch stream.

    Batch ``step`` is a pure function of (seed, step) (``step_seed``), so
    ``start_step`` resumes a stream after a checkpoint restore without
    replaying or skipping data.
    """
    dev = resolve_device(device)
    step = start_step
    while True:
        g = torch.Generator(device=dev).manual_seed(step_seed(seed, step))
        yield lm_batch(g, batch, seq_len, vocab, device=dev)
        step += 1
