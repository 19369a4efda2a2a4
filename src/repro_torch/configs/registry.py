"""Architecture registry (port of ``repro.configs.registry``):
``--arch <id>`` resolution for the launcher and the step builders.
``ARCHS``, ``ASSIGNED`` and ``cells()`` equal the reference's."""

from __future__ import annotations

from repro_torch.configs import (
    autoint,
    dcn_v2,
    dien,
    dlrm_mlperf,
    gemma2_9b,
    gemma_2b,
    llama4_maverick,
    llama4_scout,
    lpq_ann,
    minicpm_2b,
    schnet,
)

_MODULES = (
    gemma_2b,
    gemma2_9b,
    minicpm_2b,
    llama4_scout,
    llama4_maverick,
    schnet,
    autoint,
    dlrm_mlperf,
    dien,
    dcn_v2,
    lpq_ann,
)

ARCHS = {m.ARCH_ID: m for m in _MODULES}
ASSIGNED = [m.ARCH_ID for m in _MODULES if m is not lpq_ann]


def get(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def cells():
    """All (arch_id, shape_name, skip_reason|None) dry-run cells."""
    out = []
    for arch_id in ASSIGNED:
        mod = ARCHS[arch_id]
        for shape in mod.SHAPES:
            out.append((arch_id, shape, mod.SKIP.get(shape)))
    return out
