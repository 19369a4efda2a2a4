"""schnet [arXiv:1706.08566]: 3 interaction blocks, d_hidden 64, 300
Gaussian RBFs, cutoff 10 Å.  Molecular cells use real 3-D distances;
feature-graph cells (cora / ogbn-products) derive edge lengths from a
learned node-feature projection.  Port of ``repro.configs.schnet``."""

from repro_torch.configs.base import GNN_SHAPES
from repro_torch.models.gnn.schnet import SchNetConfig

ARCH_ID = "schnet"
FAMILY = "gnn"
SHAPES = GNN_SHAPES
SKIP = {}


def config(shape: str = "molecule") -> SchNetConfig:
    spec = GNN_SHAPES[shape]
    if spec["kind"] == "molecule":
        return SchNetConfig(
            name=ARCH_ID, n_interactions=3, d_hidden=64, n_rbf=300, cutoff=10.0
        )
    return SchNetConfig(
        name=ARCH_ID,
        n_interactions=3,
        d_hidden=64,
        n_rbf=300,
        cutoff=10.0,
        d_feat=spec["d_feat"],
        n_classes=spec["n_classes"],
    )


def reduced_config(shape: str = "molecule") -> SchNetConfig:
    if GNN_SHAPES[shape]["kind"] == "molecule":
        return SchNetConfig(
            name=ARCH_ID + "-smoke", n_interactions=2, d_hidden=16, n_rbf=20, cutoff=5.0
        )
    return SchNetConfig(
        name=ARCH_ID + "-smoke",
        n_interactions=2,
        d_hidden=16,
        n_rbf=20,
        cutoff=5.0,
        d_feat=24,
        n_classes=7,
    )
