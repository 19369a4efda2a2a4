"""Graph construction utilities shared by the ANN indexes and the GNN
substrate (port of ``repro.knn.graph_utils``): kNN and radius graphs over
points, with the paper's quantized distances when asked.

Plain torch: the reference runs no kernel here either.  Integer scores
are exact on both devices (``core.distances``: int32 on the CPU, the
float64 product of ``int_matmul`` on CUDA).

``knn_graph`` follows its docstring, not the reference's code: the
reference subtracts ``inf * eye(n)`` from the scores, and ``inf * 0`` is
NaN off the diagonal, so its rows start with the row itself and then list
ids 0, 1, ... (ROADMAP queue C, C8).  Here the diagonal alone is set to
float32 min, and the k best of the rest are kept, ties to the lowest id.
"""

from __future__ import annotations

import torch

from repro_torch.core import distances as D
from repro_torch.core import quant as Qz
from repro_torch.kernels.ref import NEG, stable_desc


def knn_graph(
    points: torch.Tensor,
    k: int,
    metric: str = "l2",
    quantized: bool = False,
    bits: int = 8,
) -> torch.Tensor:
    """[N, d] -> [N, min(k, N-1)] int32 neighbour ids (self excluded), best
    first, ties to the lowest id.

    With ``quantized=True`` the O(N^2 d) distance pass runs over Eq. 1
    abs-max codes in the integer domain.
    """
    n = points.shape[0]
    if quantized:
        codes, _ = Qz.quantize_corpus(points, bits=bits,
                                      scheme=Qz.Scheme.ABSMAX)
        s = D.scores(codes, codes, metric, quantized=True).to(torch.float32)
    else:
        s = D.scores(points, points, metric).to(torch.float32)
    eye = torch.eye(n, dtype=torch.bool, device=s.device)
    s = torch.where(eye, NEG, s)                      # exclude self
    return stable_desc(s, min(k, n - 1)).to(torch.int32)


def radius_graph(
    positions: torch.Tensor,
    cutoff: float,
    max_neighbors: int,
    quantized: bool = False,
    bits: int = 8,
):
    """Edges within ``cutoff`` (L2), capped at ``max_neighbors`` per node.

    Returns (senders [N*max_neighbors], receivers [...], mask [...]) —
    flat padded edge lists ready for segment-sum message passing.
    """
    n = positions.shape[0]
    if quantized:
        codes, _ = Qz.quantize_corpus(positions, bits=bits,
                                      scheme=Qz.Scheme.ABSMAX)
        # int32 negated squared L2; rescale to compare against cutoff in
        # the original units via the (uniform) scale factor
        params = Qz.learn_params(positions, bits=bits, scheme=Qz.Scheme.ABSMAX)
        neg_l2 = D.ql2_scores(codes, codes).to(torch.float32)
        scale = torch.mean(params.scale)
        dist2 = -neg_l2 * scale * scale
    else:
        diff = positions[:, None, :] - positions[None, :, :]
        dist2 = torch.sum(diff * diff, dim=-1)

    self_mask = torch.eye(n, dtype=torch.bool, device=dist2.device)
    within = (dist2 <= cutoff * cutoff) & ~self_mask
    # per receiver: pick up to max_neighbors closest senders
    masked = torch.where(within, -dist2, NEG)
    top_i = stable_desc(masked, min(max_neighbors, n))
    valid = torch.gather(masked, 1, top_i) > NEG

    receivers = torch.arange(n, dtype=torch.int32, device=dist2.device)[
        :, None].expand(top_i.shape).reshape(-1)
    senders = top_i.to(torch.int32).reshape(-1)
    mask = valid.reshape(-1)
    return torch.where(mask, senders, 0), receivers, mask
