"""The GNN family (port of ``repro.models.gnn``): SchNet."""

from repro_torch.models.gnn import schnet

__all__ = ["schnet"]
