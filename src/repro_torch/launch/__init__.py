"""Launch surface (port of ``repro.launch``): mesh construction, the step
builders of the ported paths (``launch.steps``), the ANN serving loop
(``python -m repro_torch.launch.serve``) and the training launcher
(``python -m repro_torch.launch.train``)."""

from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.steps import (
    make_gnn_train_step,
    make_lm_decode,
    make_lm_decode_q8,
    make_lm_prefill,
    make_lm_train_step,
    make_recsys_serve,
    make_recsys_train_step,
    make_retrieval,
)

__all__ = ["make_host_mesh", "make_production_mesh", "make_gnn_train_step",
           "make_lm_decode", "make_lm_decode_q8", "make_lm_prefill",
           "make_lm_train_step", "make_recsys_serve",
           "make_recsys_train_step", "make_retrieval"]
