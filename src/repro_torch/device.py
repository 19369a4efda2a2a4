"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: ``None``
resolves to ``"cuda"`` and raises a clear error when no CUDA device
exists — it never falls back to the CPU silently.  Only an explicit
``device="cpu"`` runs there (the tests pass it), or an applied runtime
profile whose platform is "cpu" (``runtime.profile.apply``).
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the applied runtime profile's platform, else ``cuda``
    (raising if absent); anything else as given."""
    if device is None:
        from repro_torch.runtime import profile as rtprofile

        device = rtprofile.platform_device() or "cuda"
    dev = torch.device(device)
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
