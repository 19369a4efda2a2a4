"""Distribution (port of ``repro.dist``): the in-process device mesh and
the sharding rules for every model family, placement plans assigning rows
/ lists / segments to mesh shards, and replica-group query fan-out
(DESIGN.md §15).  ``shard_map`` has no counterpart: a sharded plan is a
loop over the mesh's devices (``dist.sharding``)."""

from repro_torch.dist import placement  # noqa: F401
from repro_torch.dist.placement import Placement  # noqa: F401
from repro_torch.dist.replica import (  # noqa: F401
    ReplicaSet,
    replicated_query_plan,
    submeshes,
)
from repro_torch.dist.sharding import (  # noqa: F401
    Mesh,
    P,
    corpus_shards,
    dp_axes,
    make_mesh,
    named,
    replicated,
    sentinel_gids,
)

__all__ = [
    "Mesh",
    "P",
    "Placement",
    "ReplicaSet",
    "corpus_shards",
    "dp_axes",
    "make_mesh",
    "named",
    "placement",
    "replicated",
    "replicated_query_plan",
    "sentinel_gids",
    "submeshes",
]
