"""Frozen data generators, in plain PyTorch on the device.

A configuration names its generator (``data.generator``): the module
``lpqbench/data/<generator>.py``, whose ``sampler(params, d, g, dev)``
returns ``draw(g, rows) -> [rows, d] float32``.  Corpus and query pool are
drawn in fixed slabs of ``SLAB`` rows from generators seeded from the run's
``--seed`` and a stream name, so the reference can draw the corpus again,
slab for slab, and get the same bits.
"""

from __future__ import annotations

import importlib
import zlib

import numpy as np
import torch

#: rows a draw; the corpus and its redraw by the reference use the same
SLAB = 1 << 20


def derive_seed(seed: int, stream: str) -> int:
    """A 64-bit seed for one named stream of a run (any whole ``seed``)."""
    entropy = [int(seed) % (1 << 64), zlib.crc32(stream.encode())]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])


def generator(seed: int, stream: str, dev) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(derive_seed(seed, stream))
    return g


def sampler(config: dict, seed: int, dev):
    """The configuration's ``draw(g, rows)``; the generator's per-dataset
    draws (such as per-dimension scales) come from the ``dims`` stream."""
    spec = config["data"]
    mod = importlib.import_module(f"lpqbench.data.{spec['generator']}")
    return mod.sampler(spec, int(config["dim"]), generator(seed, "dims", dev),
                       dev)


def slabs(draw, rows: int, seed: int, stream: str, dev):
    """Yield ``(start, [r, d] float32)`` over ``rows`` rows of one stream."""
    g = generator(seed, stream, dev)
    for start in range(0, rows, SLAB):
        yield start, draw(g, min(SLAB, rows - start))


def fill(draw, rows: int, d: int, seed: int, stream: str, dev) -> torch.Tensor:
    """All ``rows`` rows of one stream in one [rows, d] float32 tensor."""
    out = torch.empty((rows, d), dtype=torch.float32, device=dev)
    for start, x in slabs(draw, rows, seed, stream, dev):
        out[start:start + x.shape[0]] = x
    return out
