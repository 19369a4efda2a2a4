"""Filtered search: predicate bitmaps in the engine's id-masking path
(port of ``repro.filter``)."""

from repro_torch.filter.filter import Filter, overfetch

__all__ = ["Filter", "overfetch"]
