"""Launch surface (port of ``repro.launch``): so far the step builders of
the ported paths (``launch.steps.make_retrieval``)."""

from repro_torch.launch.steps import make_retrieval

__all__ = ["make_retrieval"]
