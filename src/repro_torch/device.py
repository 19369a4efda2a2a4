"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: ``None``
resolves to ``"cuda"`` and raises a clear error when no CUDA device
exists — it never falls back to the CPU silently.  Only an explicit
``device="cpu"`` runs there (the tests pass it).
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raising if absent); anything else as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the GPU by "
            "default — pass device='cpu' explicitly to run on the CPU"
        )
    return dev


def to_tensor(a, device=None, dtype=None) -> torch.Tensor:
    """numpy array or tensor -> tensor (a read-only numpy array is copied
    first: torch cannot share it)."""
    if isinstance(a, np.ndarray):
        a = np.ascontiguousarray(a)
        a = torch.from_numpy(a if a.flags.writeable else a.copy())
    return torch.as_tensor(a, dtype=dtype, device=device)
