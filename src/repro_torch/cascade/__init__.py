"""The cascade subsystem (port of ``repro.cascade``): multi-stage scoring
pipelines, a head index pruning into budgeted refinement stages, and
density-aware per-region Eq. 1 constants for the partitioned kinds."""

from repro_torch.cascade.index import CascadeIndex  # noqa: F401
from repro_torch.cascade.regions import RegionQuant, density_scales  # noqa: F401

__all__ = ["CascadeIndex", "RegionQuant", "density_scales"]
