"""Carry a reference index's state into the port.

The reference's ``CodeStore.state()`` / ``PQStore.state()`` (and the
``rr_`` rerank prefix), an HNSW graph's layers, levels and entry, a graph
index's adjacency and seeds, an IVF index's centroids and lists (each
with its ``rg_`` per-region constants and ``rgs_`` regional store when
built with ``regions``), a cascade's head (a nested npz) and ``cs<i>_``
stage stores, a stream index's segments (each an inner index's npz
blob), tombstones, memtable, live stats and key, or a reference-saved
npz, holds nothing JAX-specific: numpy arrays plus a
JSON-able meta record; so does a recsys ``QuantizedTable`` (int8 codes
and Eq. 1 constants).  These helpers
turn them into the port's objects so both packages can run on the same
codes, codebooks and Eq. 1 constants.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.core.quant import QuantParams
from repro_torch.device import resolve_device, to_tensor
from repro_torch.knn.flat import FlatIndex
from repro_torch.knn.graph_index import GraphIndex
from repro_torch.knn.hnsw import HNSWIndex
from repro_torch.knn.ivf import IVFIndex
from repro_torch.knn.pq import PQIndex
from repro_torch.models.recsys.embedding import QuantizedTable


def quant_params_from_numpy(lo: np.ndarray, hi: np.ndarray, zero: np.ndarray,
                            bits: int, scheme: str,
                            device=None) -> QuantParams:
    """Eq. 1 constants (numpy [d] f32 each) -> the port's ``QuantParams`` on
    ``device`` (``None``: the GPU)."""
    dev = resolve_device(device)

    def t(a):
        return to_tensor(np.asarray(a, dtype=np.float32), device=dev)

    return QuantParams(lo=t(lo), hi=t(hi), zero=t(zero), bits=int(bits),
                       scheme=str(scheme))


def flat_from_reference_state(arrays: dict[str, np.ndarray],
                              meta: dict[str, Any], device) -> FlatIndex:
    """A reference flat index's (arrays, meta) -> the port's ``FlatIndex``.

    ``meta`` needs ``metric`` and the ``store`` record (plus ``rr_store``
    for ``+rN`` builds), as ``FlatIndex.save`` / ``CodeStore.state`` write
    them; array values may be numpy arrays or anything ``np.asarray`` takes.
    """
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    return FlatIndex.from_state(arrays, meta, device=device)


def pq_from_reference_state(arrays: dict[str, np.ndarray],
                            meta: dict[str, Any], device) -> PQIndex:
    """A reference PQ index's (arrays, meta) -> the port's ``PQIndex``.

    ``meta`` needs ``metric`` and the ``store`` record (plus ``rr_store``
    for ``,r32`` / ``,r8`` builds), as ``PQIndex.save`` /
    ``PQStore.state`` write them: codes, codebooks and the rerank store
    carry across as numpy arrays.
    """
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    return PQIndex.from_state(arrays, meta, device=device)


def hnsw_from_reference_state(arrays: dict[str, np.ndarray],
                              meta: dict[str, Any], device) -> HNSWIndex:
    """A reference HNSW index's (arrays, meta) -> the port's ``HNSWIndex``.

    ``arrays`` hold ``levels``, ``layer_<l>`` and the store (plus ``rr_``)
    arrays; ``meta`` holds ``metric``, ``m``, ``entry``, ``n_layers`` and the
    store records, as ``HNSWIndex.save`` writes them.  A regions build
    adds the ``rg_`` constants and statistics, the ``rgs_`` regional store
    and ``rg_cents`` (meta ``rg_regions``, ``rgs_store``).
    """
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    return HNSWIndex.from_state(arrays, meta, device=device)


def graph_from_reference_state(arrays: dict[str, np.ndarray],
                               meta: dict[str, Any], device) -> GraphIndex:
    """A reference graph index's (arrays, meta) -> the port's ``GraphIndex``.

    ``arrays`` hold ``adj``, ``seeds``, ``seed_ids`` and the store (plus
    ``rr_``) arrays; ``meta`` holds ``metric``, ``degree``,
    ``internal_metric``, ``aug`` and the store records, as
    ``GraphIndex.save`` writes them.  A regions build adds the ``rg_``
    constants and statistics and the ``rgs_`` regional store (meta
    ``rg_regions``, ``rgs_store``).
    """
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    return GraphIndex.from_state(arrays, meta, device=device)


def ivf_from_reference_state(arrays: dict[str, np.ndarray],
                             meta: dict[str, Any], device) -> IVFIndex:
    """A reference IVF index's (arrays, meta) -> the port's ``IVFIndex``.

    ``arrays`` hold ``centroids``, ``lists`` and the store (plus ``rr_``)
    arrays; ``meta`` holds ``metric``, ``nlist``, ``max_list`` and the
    store records, as ``IVFIndex.save`` writes them.  A regions build adds
    the ``rg_`` constants and statistics (meta ``rg_regions``); its store
    holds the regional codes.
    """
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    return IVFIndex.from_state(arrays, meta, device=device)


def cascade_from_reference_state(arrays: dict[str, np.ndarray],
                                 meta: dict[str, Any], device):
    """A reference cascade's (arrays, meta) -> the port's ``CascadeIndex``.

    ``arrays`` hold ``cs_blob`` (the head index's own npz, loaded through
    its kind's port) and each refinement stage's store under ``cs<i>_``;
    ``meta`` holds ``metric``, ``stages``, ``head_kind`` and the stage
    store records, as ``CascadeIndex.save`` writes them.
    """
    from repro_torch.cascade import CascadeIndex

    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    return CascadeIndex.from_state(arrays, meta, device=device)


def stream_from_reference_state(arrays: dict[str, np.ndarray],
                                meta: dict[str, Any], device=None):
    """A reference stream index's (arrays, meta) -> the port's
    ``MutableIndex`` on ``device`` (``None``: the GPU).

    ``arrays`` hold each segment's ``seg<i>_blob`` (the inner index's own
    npz, loaded through its kind's port: ``flat_from_reference_state``
    and the others read the same fields), ``raw``, ``ids``, ``live`` and
    calibration stats, plus ``mem_vecs`` / ``mem_ids``, the ``ls_`` live
    stats and ``rng_key``; ``meta`` holds the policy, counters and
    segment records, as ``MutableIndex.save`` writes them.
    """
    from repro_torch.stream import MutableIndex

    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    return MutableIndex.from_state(arrays, meta, device=device)


def quantized_table_from_numpy(codes: np.ndarray, lo: np.ndarray,
                               hi: np.ndarray, zero: np.ndarray, bits: int,
                               scheme: str, device=None) -> QuantizedTable:
    """A reference ``QuantizedTable``'s int8 codes and Eq. 1 constants
    (numpy) -> the port's ``QuantizedTable`` on ``device`` (``None``: the
    GPU)."""
    dev = resolve_device(device)
    return QuantizedTable(
        codes=to_tensor(np.asarray(codes, dtype=np.int8), device=dev),
        params=quant_params_from_numpy(lo, hi, zero, bits, scheme,
                                       device=dev))


def dense_table_from_numpy(table: np.ndarray, device=None):
    """A dense [vocab, dim] embedding table (numpy) -> the port's f32
    tensor on ``device`` (``None``: the GPU)."""
    return to_tensor(np.asarray(table, dtype=np.float32),
                     device=resolve_device(device))
