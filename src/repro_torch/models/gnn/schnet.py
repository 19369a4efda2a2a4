"""SchNet (Schütt et al., arXiv:1706.08566; port of
``repro.models.gnn.schnet``): continuous-filter convolution GNN,
n_interactions=3, d_hidden=64, 300 RBFs, cutoff 10 Å.

Message passing gathers sender features along the edge list, modulates
them with the RBF-generated continuous filter and sums them into their
receivers with ``index_add_`` (the reference's ``jax.ops.segment_sum``).
On the card that sum is float32 atomics, whose order varies, so a card
run agrees with a CPU run within a tolerance, not bit for bit.

Two input regimes:
  * molecular: atomic numbers [N] + positions [N, 3]; edge lengths are
    real interatomic distances;
  * feature graphs (cora / ogbn-products cells): no geometry, so edge
    "distances" are L2 gaps in a learned projection of node features; the
    cfconv structure is unchanged.

As the reference does, an edge's length is the norm of the difference
vector plus 1e-12 in each component (not under the square root), so a
self-edge has a finite length and a finite gradient.  The interaction
blocks' parameters are stacked [I, ...] as the reference's ``vmap``
builds them, so a reference tree converts leaf by leaf
(``convert.schnet_params_from_reference``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    max_z: int = 100                  # atomic-number vocabulary
    d_feat: Optional[int] = None      # set for feature-graph regime
    n_classes: Optional[int] = None   # node classification head
    dtype: str = "float32"

    @property
    def tdtype(self) -> torch.dtype:
        """The torch dtype named by ``dtype``."""
        return getattr(torch, self.dtype)


def rbf_centers(n_rbf: int, cutoff: float, device=None) -> torch.Tensor:
    """mu = ``jnp.linspace(0, cutoff, n_rbf)`` in float32, bit for bit as
    XLA computes it: the division by n - 1 becomes a product with its
    float32 reciprocal, folded into the stop, so mu_i = i * (cutoff * (1 /
    (n - 1))), each product rounded to float32, and the endpoint itself
    last.  ``torch.linspace``, and the form ``jnp.linspace`` is written
    in, round some centres otherwise."""
    if n_rbf == 1:
        return torch.zeros((1,), dtype=torch.float32, device=device)
    stop = torch.tensor(cutoff, dtype=torch.float32, device=device)
    recip = torch.tensor(1.0, dtype=torch.float32, device=device) / (
        n_rbf - 1)
    i = torch.arange(n_rbf - 1, dtype=torch.float32, device=device)
    return torch.cat([i * (stop * recip), stop[None]])


def rbf_expand(dist: torch.Tensor, n_rbf: int, cutoff: float):
    """Gaussian radial basis: exp(-gamma (d - mu_k)^2), mu on [0, cutoff]."""
    mu = rbf_centers(n_rbf, cutoff, dist.device)
    gamma = 1.0 / ((cutoff / n_rbf) ** 2)
    return torch.exp(-gamma * (dist[:, None] - mu[None, :]) ** 2)


def _affine_init(generator, d_in: int, d_out: int, cfg: SchNetConfig,
                 dev, lead=()):
    return {**L.dense_init(generator, d_in, d_out, cfg.tdtype, device=dev,
                           lead=lead),
            "b": torch.zeros((*lead, d_out), dtype=cfg.tdtype, device=dev)}


def init_params(generator: torch.Generator, cfg: SchNetConfig, device=None):
    """The parameter tree of ``cfg`` (interactions stacked [I, ...]), drawn
    from ``generator``, which must live on ``device`` (``None``: the
    GPU)."""
    dev = resolve_device(device)
    h, lead = cfg.d_hidden, (cfg.n_interactions,)
    if cfg.d_feat is None:
        embed = L.embed_init(generator, cfg.max_z, h, cfg.tdtype, device=dev)
    else:
        embed = L.dense_init(generator, cfg.d_feat, h, cfg.tdtype, device=dev)
    inter = {
        "in_proj": L.dense_init(generator, h, h, cfg.tdtype, device=dev,
                                lead=lead),
        "filter1": _affine_init(generator, cfg.n_rbf, h, cfg, dev, lead),
        "filter2": _affine_init(generator, h, h, cfg, dev, lead),
        "out1": _affine_init(generator, h, h, cfg, dev, lead),
        "out2": _affine_init(generator, h, h, cfg, dev, lead),
    }
    head_out = cfg.n_classes if cfg.n_classes else 1
    params = {
        "embed": embed,
        "interactions": inter,
        "head1": _affine_init(generator, h, h // 2, cfg, dev),
        "head2": _affine_init(generator, h // 2, head_out, cfg, dev),
    }
    if cfg.d_feat is not None:
        params["dist_proj"] = L.dense_init(generator, cfg.d_feat, 8,
                                           cfg.tdtype, device=dev)
    return params


def _affine(p, x):
    return L._dot(x, p["w"]) + p["b"]


def _segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                 n: int) -> torch.Tensor:
    """``jax.ops.segment_sum(data, ids, num_segments=n)`` for ids in
    [0, n): sums along the first axis with ``index_add``."""
    out = torch.zeros((n, *data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add(0, segment_ids.to(torch.int64), data)


def _edge_length(pts: torch.Tensor, senders, receivers) -> torch.Tensor:
    d = pts[senders.to(torch.int64)] - pts[receivers.to(torch.int64)] + 1e-12
    return torch.sqrt(torch.sum(d * d, dim=-1))     # jnp.linalg.norm's form


def _interaction(ip, x, w_filter, senders, receivers, edge_mask,
                 n_nodes: int):
    """One cfconv + atomwise block.  x: [N, h], w_filter: [E, h]."""
    msg_src = L.dense(ip["in_proj"], x)[senders.to(torch.int64)]
    msg = msg_src * w_filter
    msg = torch.where(edge_mask[:, None], msg, torch.zeros_like(msg))
    agg = _segment_sum(msg, receivers, n_nodes)
    y = _affine(ip["out1"], agg)
    y = L.shifted_softplus(y)
    y = _affine(ip["out2"], y)
    return x + y


def forward(params, cfg: SchNetConfig, senders, receivers, edge_mask,
            n_nodes: int, z=None, positions=None, node_feat=None):
    """Per-node head output [N, n_out] (n_out = n_classes, or 1 for the
    molecular energy)."""
    if cfg.d_feat is None:
        x = L.embed(params["embed"], z)
        dist = _edge_length(positions, senders, receivers)
    else:
        x = L.dense(params["embed"], node_feat)
        proj = L.dense(params["dist_proj"], node_feat)    # [N, 8]
        dist = _edge_length(proj, senders, receivers)

    rbf = rbf_expand(dist, cfg.n_rbf, cfg.cutoff).to(x.dtype)  # [E, n_rbf]
    for ip in L.unstack(params["interactions"], cfg.n_interactions):
        w = _affine(ip["filter1"], rbf)
        w = L.shifted_softplus(w)
        w = _affine(ip["filter2"], w)
        x = _interaction(ip, x, w, senders, receivers, edge_mask, n_nodes)

    y = _affine(params["head1"], x)
    y = L.shifted_softplus(y)
    return _affine(params["head2"], y)                     # [N, n_out]


def energy_loss(params, cfg: SchNetConfig, graph, graph_ids,
                n_graphs: int):
    """Molecular regression: sum-pool node outputs per molecule, MSE."""
    out = forward(
        params, cfg,
        senders=graph.senders, receivers=graph.receivers,
        edge_mask=graph.edge_mask, n_nodes=graph.n_nodes,
        z=graph.node_feat, positions=graph.positions,
    )[:, 0]
    energies = _segment_sum(out, graph_ids, n_graphs)
    return torch.mean((energies - graph.labels) ** 2)


def _node_nll(logits, labels) -> torch.Tensor:
    """Mean softmax cross-entropy of [N, C] logits against int labels."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.mean(-torch.gather(logp, -1,
                                    labels.to(torch.int64)[:, None])[:, 0])


def node_class_loss(params, cfg: SchNetConfig, graph):
    """Full-graph node classification: softmax CE over all nodes."""
    logits = forward(
        params, cfg,
        senders=graph.senders, receivers=graph.receivers,
        edge_mask=graph.edge_mask, n_nodes=graph.n_nodes,
        node_feat=graph.node_feat,
    )
    return _node_nll(logits, graph.labels)
