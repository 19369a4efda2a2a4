"""SchNet (Schütt et al., arXiv:1706.08566; port of
``repro.models.gnn.schnet``): continuous-filter convolution GNN,
n_interactions=3, d_hidden=64, 300 RBFs, cutoff 10 Å.

Message passing gathers sender features along the edge list, modulates
them with the RBF-generated continuous filter and sums them into their
receivers with ``index_add_`` (the reference's ``jax.ops.segment_sum``),
a block of edges at a time (``forward``): ogbn-products' [61.9 M, 300]
float32 RBF matrix alone would be 74 GB.
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


#: bytes of one edge block's [block, n_rbf] float32 RBF rows, the unit
#: ``forward`` runs each interaction's edge part in: 2 GiB is 1,789,569
#: edges at 300 RBFs (35 blocks for ogbn-products' 61,859,140 edges)
RBF_BYTES = 2 << 30


def edge_block(n_rbf: int) -> int:
    """Edges a block under ``RBF_BYTES``."""
    return max(1, RBF_BYTES // (n_rbf * 4))


def _edge_length(pts: torch.Tensor, senders, receivers) -> torch.Tensor:
    d = pts[senders.to(torch.int64)] - pts[receivers.to(torch.int64)] + 1e-12
    return torch.sqrt(torch.sum(d * d, dim=-1))     # jnp.linalg.norm's form


def _edge_messages(fp, hs, dist, edge_mask, n_rbf: int, cutoff: float):
    """One block's messages [b, h]: the RBF expansion of its lengths, the
    continuous filter (filter1, shifted softplus, filter2) times the
    gathered sender projections ``hs``, zero where the mask is off."""
    rbf = rbf_expand(dist, n_rbf, cutoff).to(hs.dtype)      # [b, n_rbf]
    w = _affine(fp["filter1"], rbf)
    w = L.shifted_softplus(w)
    w = _affine(fp["filter2"], w)
    msg = hs * w
    return torch.where(edge_mask[:, None], msg, torch.zeros_like(msg))


def _filters(leaves) -> dict:
    w1, b1, w2, b2 = leaves
    return {"filter1": {"w": w1, "b": b1}, "filter2": {"w": w2, "b": b2}}


class _EdgeBlocks(torch.autograd.Function):
    """One interaction's edge part, a block of edges at a time: the
    messages of ``_edge_messages`` summed into their receivers
    (``index_add_``) -> agg [N, h].  The forward keeps no block: it saves
    its inputs (h, the lengths, the filter weights, the edge lists), and
    the backward recomputes each block's messages to take their gradient
    (the gathered sender rows as a leaf, scattered back into dh with
    ``index_add_``)."""

    @staticmethod
    def forward(ctx, h, dist, w1, b1, w2, b2, senders, receivers, edge_mask,
                n_nodes, n_rbf, cutoff, block):
        fp = _filters((w1, b1, w2, b2))
        agg = torch.zeros((n_nodes, h.shape[1]), dtype=h.dtype,
                          device=h.device)
        for lo in range(0, dist.shape[0], block):
            cut = slice(lo, lo + block)
            agg.index_add_(0, receivers[cut], _edge_messages(
                fp, h[senders[cut]], dist[cut], edge_mask[cut], n_rbf,
                cutoff))
        ctx.save_for_backward(h, dist, w1, b1, w2, b2, senders, receivers,
                              edge_mask)
        ctx.config = (n_rbf, cutoff, block)
        return agg

    @staticmethod
    def backward(ctx, g):
        h, dist, *weights, senders, receivers, edge_mask = ctx.saved_tensors
        n_rbf, cutoff, block = ctx.config
        dh = torch.zeros_like(h)
        ddist = torch.empty_like(dist)
        dweights = [torch.zeros_like(w) for w in weights]
        leaves = [w.detach().requires_grad_() for w in weights]
        fp = _filters(leaves)
        for lo in range(0, dist.shape[0], block):
            cut = slice(lo, lo + block)
            with torch.enable_grad():
                hs = h[senders[cut]].detach().requires_grad_()
                d = dist[cut].detach().requires_grad_()
                msg = _edge_messages(fp, hs, d, edge_mask[cut], n_rbf,
                                     cutoff)
                grads = torch.autograd.grad(msg, [hs, d, *leaves],
                                            g[receivers[cut]])
            dh.index_add_(0, senders[cut], grads[0])
            ddist[cut] = grads[1]
            for acc, gw in zip(dweights, grads[2:]):
                acc += gw
        return (dh, ddist, *dweights, None, None, None, None, None, None,
                None)


def _interaction(ip, x, dist, senders, receivers, edge_mask, n_nodes: int,
                 cfg: SchNetConfig, block: int):
    """One cfconv + atomwise block.  x: [N, h], dist: [E], the edge lists
    int64."""
    h = L.dense(ip["in_proj"], x)
    agg = _EdgeBlocks.apply(
        h, dist, ip["filter1"]["w"], ip["filter1"]["b"], ip["filter2"]["w"],
        ip["filter2"]["b"], senders, receivers, edge_mask, n_nodes,
        cfg.n_rbf, cfg.cutoff, block)
    y = _affine(ip["out1"], agg)
    y = L.shifted_softplus(y)
    y = _affine(ip["out2"], y)
    return x + y


def forward(params, cfg: SchNetConfig, senders, receivers, edge_mask,
            n_nodes: int, z=None, positions=None, node_feat=None):
    """Per-node head output [N, n_out] (n_out = n_classes, or 1 for the
    molecular energy).

    Each interaction's edge part runs over blocks of
    ``edge_block(cfg.n_rbf)`` edges (an RBF block of ``RBF_BYTES``).
    A block is what one shard of the reference's ``gnn_edge_sharding``
    computes (its edges' RBFs, filters and messages), and the sum of the
    blocks' scatters into the receivers is that sharding's reduce.  The
    function is the reference's; only the order of the float32 sums
    changes, and a graph whose edges fit one block (``full_graph_sm``,
    ``molecule``, a ``minibatch_lg`` sample) runs as one block.  The
    lengths [E] are computed once and kept; a block's RBF rows and filters
    live only while it runs, in the forward and again in the backward."""
    senders = senders.to(torch.int64)
    receivers = receivers.to(torch.int64)
    if cfg.d_feat is None:
        x = L.embed(params["embed"], z)
        dist = _edge_length(positions, senders, receivers)
    else:
        x = L.dense(params["embed"], node_feat)
        proj = L.dense(params["dist_proj"], node_feat)    # [N, 8]
        dist = _edge_length(proj, senders, receivers)

    block = edge_block(cfg.n_rbf)
    for ip in L.unstack(params["interactions"], cfg.n_interactions):
        x = _interaction(ip, x, dist, senders, receivers, edge_mask, n_nodes,
                         cfg, block)

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
