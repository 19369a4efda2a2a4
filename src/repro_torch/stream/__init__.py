"""Mutable segmented indexes (port of ``repro.stream``, DESIGN.md §10): an
LSM-style wrapper that puts upsert / delete behind every ported index
kind.  A host fp32 Memtable absorbs writes; sealing builds an immutable
Segment (an inner index on the index's device with its own row-id base
and Eq. 1 constants); the Manifest tracks segments and tombstones and
drives save / load; the Compactor merges small segments, drops tombstoned
rows and re-quantizes when the live distribution has drifted.
MutableIndex ties it together as the factory prefix
``stream(<inner factory>)[+rN]``."""

from repro_torch.stream.compactor import CompactionPolicy, Compactor
from repro_torch.stream.manifest import Manifest
from repro_torch.stream.memtable import Memtable
from repro_torch.stream.mutable import MutableIndex
from repro_torch.stream.segment import Segment

__all__ = [
    "Memtable",
    "Segment",
    "Manifest",
    "Compactor",
    "CompactionPolicy",
    "MutableIndex",
]
