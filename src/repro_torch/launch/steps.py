"""Step-function builders (port of ``repro.launch.steps``, the retrieval
part).  Each returns a function of tensors with its configuration closed
over.  The sharded ``make_retrieval_sharded`` comes with the mesh paths
(ROADMAP A14), the LM / GNN / recsys training and serving steps with A16.
"""

from __future__ import annotations

from typing import Callable

from repro_torch.core.quant import QuantParams
from repro_torch.models.recsys import retrieval as RT


def make_retrieval(quantized: bool, k: int = 100) -> Callable:
    """1-query x n_candidates MIP scoring (the paper's search problem).

    Quantized: ``step(query_emb, cand_codes, lo, hi, zero)`` over int8
    candidate codes with abs-max Eq. 1 constants (B1 then B6 on the GPU);
    else ``step(query_emb, cand_table)`` in fp32.  The reference's
    ``use_pallas`` switch (TPU kernel or XLA dot) has no counterpart.
    """
    if quantized:
        def step(query_emb, cand_codes, lo, hi, zero):
            params = QuantParams(lo=lo, hi=hi, zero=zero, bits=8,
                                 scheme="absmax")
            return RT.retrieve_quantized(query_emb, cand_codes, params, k=k)

        return step

    def step(query_emb, cand_table):
        return RT.retrieve_fp32(query_emb, cand_table, k=k)

    return step
