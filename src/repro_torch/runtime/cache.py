"""Hot-path cache tiers: exact-result cache and PQ LUT cache (port of
``repro.runtime.cache``).

  * **result tier** (``CachedSearcher`` over a ``TTLLRUCache``): the whole
    ``SearchResult`` keyed on a fingerprint of (canonical query bytes, k,
    params, index version).  The batch is normalized to contiguous fp32 on
    the host before fingerprinting, the form every Searcher consumes, so a
    float64 copy, a strided view and a CUDA tensor of the same values hit
    one entry.  A hit returns the stored score / id tensors, bit-identical
    to the miss that produced them, and launches no kernel.  The version
    component (a replan generation or manifest epoch) invalidates across
    mutations without a scan of the cache.
  * **LUT tier** (``LUTCache`` installed with ``engine.set_lut_cache``):
    per-batch ADC tables keyed on (query fingerprint, codebook fingerprint,
    metric, int8 or not).  Repeated batches skip the table build and its
    Eq. 1 quantization on the one-shot path; a bucketed Searcher's runs
    stand aside, as the reference's compiled buckets do.

``fingerprint`` hashes a tensor as the reference hashes the same numpy
array (numpy's dtype name, the shape as int64, the bytes), so one batch
gives one key in both packages.

Both tiers share one eviction discipline: LRU bounded by ``capacity`` plus
an optional TTL, with ``hits/misses/evictions/expirations`` counters.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

#: sentinel distinguishing "miss" from a cached None
MISS = object()


def _host(p) -> np.ndarray:
    if isinstance(p, torch.Tensor):
        return p.detach().cpu().numpy()
    return np.asarray(p)


def fingerprint(*parts: Any) -> str:
    """Stable blake2b fingerprint of tensors / arrays / bytes / scalars /
    strings.  Arrays hash over dtype + shape + raw bytes, so two batches
    fingerprint equal iff they are bit-identical."""
    h = hashlib.blake2b(digest_size=16)
    for p in parts:
        if hasattr(p, "shape"):            # ndarray / tensor
            a = _host(p)
            h.update(str(a.dtype).encode())
            h.update(np.asarray(a.shape, np.int64).tobytes())
            h.update(np.ascontiguousarray(a).tobytes())
        elif isinstance(p, bytes):
            h.update(p)
        else:
            h.update(repr(p).encode())
        h.update(b"|")
    return h.hexdigest()


class TTLLRUCache:
    """LRU cache with optional TTL and hit/miss/eviction accounting.

    ``clock`` is injectable (tests drive expiry deterministically).  Not
    thread-safe by design: each tier lives on the request path of one
    serving loop; the maintenance thread never touches caches.
    """

    def __init__(self, capacity: int, ttl_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if capacity <= 0:
            raise ValueError(f"cache capacity must be positive, got {capacity}")
        if ttl_s is not None and ttl_s <= 0:
            raise ValueError(f"cache ttl must be positive, got {ttl_s}")
        self.capacity = int(capacity)
        self.ttl_s = ttl_s
        self.clock = clock
        self._d: collections.OrderedDict[Any, tuple[float, Any]] = (
            collections.OrderedDict()
        )
        self.counters = collections.Counter(
            hits=0, misses=0, evictions=0, expirations=0
        )

    def __len__(self) -> int:
        return len(self._d)

    def get(self, key):
        """Cached value or the ``MISS`` sentinel (counts either way)."""
        entry = self._d.get(key)
        if entry is not None:
            t, value = entry
            if self.ttl_s is not None and self.clock() - t > self.ttl_s:
                del self._d[key]
                self.counters["expirations"] += 1
            else:
                self._d.move_to_end(key)
                self.counters["hits"] += 1
                return value
        self.counters["misses"] += 1
        return MISS

    def put(self, key, value) -> None:
        if key in self._d:
            del self._d[key]
        self._d[key] = (self.clock(), value)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.counters["evictions"] += 1

    def get_or_build(self, key, builder: Callable[[], Any]):
        v = self.get(key)
        if v is MISS:
            v = builder()
            self.put(key, v)
        return v

    def clear(self) -> None:
        self._d.clear()

    def stats(self) -> dict:
        return {"entries": len(self._d), "capacity": self.capacity,
                "ttl_s": self.ttl_s, **self.counters}


class LUTCache(TTLLRUCache):
    """The PQ LUT tier — install with ``engine.set_lut_cache``.

    Keys combine the query-batch fingerprint with a fingerprint of the
    store's codebooks (not ``id(store)``: object ids can be recycled,
    bytes cannot), so a cache shared across indexes never serves one
    index's tables to another."""

    def key_for(self, queries, codebooks, metric: str, lpq: bool):
        return ("lut", fingerprint(queries), fingerprint(codebooks),
                metric, bool(lpq))


@dataclasses.dataclass
class _CachedEntry:
    scores: torch.Tensor
    ids: torch.Tensor
    stats: dict


class CachedSearcher:
    """The result tier: a drop-in wrapper over a planned ``Searcher``.

    ``version`` feeds the cache key (a callable returning the replan
    generation), so entries from a superseded plan never satisfy a fresh
    request.  Hits return the stored tensors with ``stats["cache"] =
    "hit"`` and zeroed read accounting: a hit reads no corpus bytes.
    """

    def __init__(self, searcher, cache: TTLLRUCache,
                 version: Callable[[], Any] = lambda: 0):
        self.searcher = searcher
        self.cache = cache
        self.version = version

    @property
    def rerank(self):
        return self.searcher.rerank

    @property
    def n_shards(self) -> int:
        return self.searcher.n_shards

    def buckets_for(self, q_len: int):
        return self.searcher.buckets_for(q_len)

    @staticmethod
    def canonicalize(queries) -> np.ndarray:
        """The semantic-key normal form: contiguous fp32 on the host.

        Every Searcher casts its batch to fp32, so two batches that agree
        after this cast are the *same search*; fingerprinting the
        canonical array and then searching that same array keeps hits
        bit-identical to misses."""
        return np.ascontiguousarray(_host(queries).astype(np.float32,
                                                          copy=False))

    def _key(self, q: np.ndarray):
        s = self.searcher
        return ("result", fingerprint(q), s.k, s.params, self.version())

    def __call__(self, queries):
        q = self.canonicalize(queries)
        key = self._key(q)
        entry = self.cache.get(key)
        if entry is not MISS:
            stats = dict(entry.stats)
            stats.update(cache="hit", bytes_read=0, chunks=0, rerank_bytes=0)
            from repro_torch.knn import base as B

            return B.SearchResult(entry.scores, entry.ids, stats)
        res = self.searcher(q)
        self.cache.put(key, _CachedEntry(res.scores, res.ids,
                                         dict(res.stats)))
        res.stats["cache"] = "miss"
        return res
