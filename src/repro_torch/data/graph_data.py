"""Graph data substrate (port of ``repro.data.graph_data``): synthetic
graphs in the assigned shape regimes plus a GraphSAGE-style fan-out
neighbor sampler (the ``minibatch_lg`` cell's).

Graphs are (node_feat [N, F], senders [E], receivers [E], mask [E])
flat-padded edge lists, the layout the GNN's ``index_add_`` message
passing reads.  The generators draw from a ``torch.Generator`` on the
graph's device (the reference's ``jax.random`` draws cannot be
reproduced: tests carry the reference's graphs across).  The sampler is
host-side numpy, the reference's code (its local-id remap vectorized as an
``np.searchsorted`` over the sorted sample): on one
``np.random.Generator`` it returns the reference's subgraph bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class Graph:
    node_feat: torch.Tensor       # [N, F] (atomic numbers [N] for molecules)
    senders: torch.Tensor         # [E] int32
    receivers: torch.Tensor       # [E] int32
    edge_mask: torch.Tensor       # [E] bool
    n_nodes: int
    positions: Optional[torch.Tensor] = None   # [N, 3] for molecular graphs
    labels: Optional[torch.Tensor] = None


def _generator(generator, dev) -> torch.Generator:
    return (torch.Generator(device=dev).manual_seed(0) if generator is None
            else generator)


def random_graph(n_nodes: int, n_edges: int, d_feat: int,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> Graph:
    """Erdos-Renyi-ish graph with power-law-ish degree (preferential hubs)
    on ``device`` (``None``: the GPU), drawn from ``generator`` (default:
    seed 0 on that device).  Self-edges can occur."""
    dev = resolve_device(device)
    g = _generator(generator, dev)
    # hub-biased endpoints: square a uniform to concentrate on low ids
    s = (torch.rand((n_edges,), generator=g, device=dev) ** 2
         * n_nodes).to(torch.int32)
    r = torch.randint(0, n_nodes, (n_edges,), generator=g, device=dev,
                      dtype=torch.int32)
    feat = torch.randn((n_nodes, d_feat), generator=g, device=dev) * 0.5
    labels = torch.randint(0, 16, (n_nodes,), generator=g, device=dev,
                           dtype=torch.int32)
    return Graph(
        node_feat=feat,
        senders=torch.clamp(s, 0, n_nodes - 1),
        receivers=r,
        edge_mask=torch.ones((n_edges,), dtype=torch.bool, device=dev),
        n_nodes=n_nodes,
        labels=labels,
    )


def random_molecules(batch: int, n_atoms: int, n_edges_per: int,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> Graph:
    """Batched small molecules (the ``molecule`` cell): one disjoint-union
    graph with block-diagonal connectivity (molecule b's edges join atoms
    ``[b * n_atoms, (b + 1) * n_atoms)``), 3-D positions for SchNet and a
    per-molecule energy target."""
    dev = resolve_device(device)
    g = _generator(generator, dev)
    n = batch * n_atoms
    pos = torch.randn((batch, n_atoms, 3), generator=g, device=dev) * 2.0
    z = torch.randint(1, 10, (batch, n_atoms), generator=g, device=dev,
                      dtype=torch.int32)                 # atomic numbers
    s = torch.randint(0, n_atoms, (batch, n_edges_per), generator=g,
                      device=dev, dtype=torch.int32)
    r = torch.randint(0, n_atoms, (batch, n_edges_per), generator=g,
                      device=dev, dtype=torch.int32)
    offs = (torch.arange(batch, dtype=torch.int32, device=dev)
            * n_atoms)[:, None]
    return Graph(
        node_feat=z.reshape(-1),                         # atomic numbers [N]
        senders=(s + offs).reshape(-1),
        receivers=(r + offs).reshape(-1),
        edge_mask=torch.ones((batch * n_edges_per,), dtype=torch.bool,
                             device=dev),
        n_nodes=n,
        positions=pos.reshape(-1, 3),
        labels=torch.randn((batch,), generator=g, device=dev),
    )


# --------------------------------------------------------------------------
# Neighbor sampler (GraphSAGE fan-out): host-side, numpy CSR
# --------------------------------------------------------------------------

class NeighborSampler:
    """Uniform fan-out sampler over a static graph.

    Builds a CSR adjacency once (numpy), then ``sample(seed_nodes,
    fanouts)`` returns a fixed-shape padded subgraph: layered gather ids
    and edge lists compatible with the ``index_add_`` message passing.
    """

    def __init__(self, senders: np.ndarray, receivers: np.ndarray,
                 n_nodes: int):
        order = np.argsort(receivers, kind="stable")
        self.dst_sorted_src = senders[order]
        self.indptr = np.zeros(n_nodes + 1, np.int64)
        np.add.at(self.indptr, receivers + 1, 1)
        self.indptr = np.cumsum(self.indptr)
        self.n_nodes = n_nodes

    def sample(self, seeds: np.ndarray, fanouts: tuple[int, ...],
               rng: np.random.Generator):
        """Returns (all_nodes [M], layers) where each layer has
        (senders_local, receivers_local, mask) into all_nodes."""
        frontier = np.unique(seeds)
        all_nodes = [frontier]
        layers = []
        for fan in fanouts:
            src_list, dst_list = [], []
            for v in frontier:
                lo, hi = self.indptr[v], self.indptr[v + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = rng.integers(0, deg, size=fan)
                nbrs = self.dst_sorted_src[lo + take]
                src_list.append(nbrs)
                dst_list.append(np.full(fan, v, np.int64))
            if src_list:
                src = np.concatenate(src_list)
                dst = np.concatenate(dst_list)
            else:
                src = np.zeros(0, np.int64)
                dst = np.zeros(0, np.int64)
            layers.append((src, dst))
            frontier = np.unique(src)
            all_nodes.append(frontier)

        nodes = np.unique(np.concatenate(all_nodes))
        out_layers = []
        for src, dst in layers:
            # local ids: positions in the sorted ``nodes``, which hold every
            # endpoint (the reference's dict remap, vectorized)
            pad = max(len(src), 1)
            s_l = np.zeros(pad, np.int32)
            r_l = np.zeros(pad, np.int32)
            m_l = np.zeros(pad, bool)
            s_l[:len(src)] = np.searchsorted(nodes, src)
            r_l[:len(dst)] = np.searchsorted(nodes, dst)
            m_l[:len(src)] = True
            out_layers.append((s_l, r_l, m_l))
        return nodes.astype(np.int64), out_layers
