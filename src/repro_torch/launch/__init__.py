"""Launch surface (port of ``repro.launch``): mesh construction, the step
builders of the ported paths (``launch.steps``) and the ANN serving loop
(``python -m repro_torch.launch.serve``)."""

from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.steps import (
    make_lm_decode,
    make_lm_decode_q8,
    make_lm_prefill,
    make_recsys_serve,
    make_retrieval,
)

__all__ = ["make_host_mesh", "make_production_mesh", "make_lm_decode",
           "make_lm_decode_q8", "make_lm_prefill", "make_recsys_serve",
           "make_retrieval"]
