"""Corpus storage for the scoring engine: ``CodeStore`` and ``PQStore``
(port of ``repro.engine.store``).

A ``CodeStore`` owns one corpus payload at any precision the paper's Eq. 1
family supports — fp32 vectors, int8 codes, or bit-packed int4 codes (two
per byte, ``core.pack``) — plus the quantization constants and a row-id
``base``.  ``memory_bytes()`` is the honest Table-1/2 accounting.

Odd dimensions under packing: the store pads codes with one zero-code
column before packing and ``encode_queries`` appends the matching zero
column, so scores are unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import pack as PK
from repro_torch.core import quant as Qz
from repro_torch.device import to_tensor


def _params_equal(a: Optional[Qz.QuantParams],
                  b: Optional[Qz.QuantParams]) -> bool:
    """Exact (bit-level) equality of two quantization-constant sets."""
    if a is None or b is None:
        return a is None and b is None

    def same(x, y):
        return torch.equal(x.detach().cpu(), y.detach().cpu())

    return (a.bits == b.bits and a.scheme == b.scheme
            and same(a.lo, b.lo) and same(a.hi, b.hi)
            and same(a.zero, b.zero))


#: codeword index widths PQStore supports: 4-bit (16-codeword codebooks,
#: codes packed two per byte) and 8-bit (256 codewords, one byte each)
PQ_CODE_BITS = (4, 8)


@dataclasses.dataclass(frozen=True)
class CodeStore:
    """One corpus, one precision, one id space."""

    n: int
    d: int                    # logical dim
    bits: int                 # 32 == fp32
    packed: bool
    data: torch.Tensor        # [N, d] f32 | [N, d_eff] int8 | [N, d_eff/2] u8
    params: Optional[Qz.QuantParams]
    base: int = 0

    # -- construction ------------------------------------------------------
    @staticmethod
    def dense(vectors, base: int = 0, device=None) -> "CodeStore":
        """fp32 storage (the unquantized arm)."""
        vectors = to_tensor(vectors, device=device, dtype=torch.float32)
        n, d = vectors.shape
        return CodeStore(n=n, d=d, bits=32, packed=False, data=vectors,
                         params=None, base=base)

    @staticmethod
    def from_codes(codes: torch.Tensor, params: Qz.QuantParams, *,
                   pack: bool = False, base: int = 0) -> "CodeStore":
        """Wrap already-encoded integer codes; optionally bit-pack int4."""
        n, d = codes.shape
        if pack:
            assert params.bits == 4, "packing is the 4-bit storage layout"
            if d % 2:
                codes = torch.nn.functional.pad(codes, (0, 1))  # zero-code column
            codes = PK.pack_int4(codes)
        return CodeStore(n=n, d=d, bits=params.bits, packed=pack,
                         data=codes.contiguous(), params=params, base=base)

    @staticmethod
    def concat(stores: "list[CodeStore]", base: int = 0) -> "CodeStore":
        """Row-concatenate layout-compatible stores into one id space (the
        stream layer's merge primitive).  Every input must agree on (d,
        bits, packed) and, when quantized, on the exact Eq. 1 constants:
        one store has one code space.  Input ``base`` offsets are dropped
        (rows are renumbered 0..sum(n)-1 under the new ``base``)."""
        if not stores:
            raise ValueError("CodeStore.concat of zero stores")
        head = stores[0]
        for s in stores[1:]:
            if (s.d, s.bits, s.packed) != (head.d, head.bits, head.packed):
                raise ValueError(
                    "concat of layout-incompatible stores: "
                    f"{(s.d, s.bits, s.packed)} vs "
                    f"{(head.d, head.bits, head.packed)}"
                )
            if not _params_equal(s.params, head.params):
                raise ValueError(
                    "concat of stores with different quantization constants "
                    "— one store has one code space; re-encode first "
                    "(stream compaction re-quantizes from raw payloads)"
                )
        data = torch.cat([s.data.to(head.device) for s in stores], dim=0)
        return CodeStore(n=sum(s.n for s in stores), d=head.d, bits=head.bits,
                         packed=head.packed, data=data, params=head.params,
                         base=base)

    def append(self, vectors) -> "CodeStore":
        """A new store with fp32 ``vectors`` encoded into this store's code
        space (B1 on the card) and appended; rows keep their order and ids
        extend n..n+m-1.  Grows a store under its constants without
        re-learning."""
        vectors = to_tensor(vectors, device=self.device, dtype=torch.float32)
        if vectors.shape[1] != self.d:
            raise ValueError(
                f"append dim {vectors.shape[1]} != store d {self.d}")
        if not self.quantized:
            extra = CodeStore.dense(vectors)
        else:
            from repro_torch.kernels import ops as K

            p = self.params
            codes = K.quantize(vectors, p.lo, p.hi, p.zero, bits=p.bits)
            extra = CodeStore.from_codes(codes, p, pack=self.packed)
        return CodeStore.concat([self, extra], base=self.base)

    # -- shape/metadata ----------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def quantized(self) -> bool:
        return self.bits < 32

    @property
    def d_eff(self) -> int:
        """Code width after the even-dim pad (== d unless packed odd-d)."""
        return self.data.shape[1] * 2 if self.packed else self.data.shape[1]

    @property
    def row_bytes(self) -> int:
        """Bytes of payload read to score one corpus row."""
        return int(self.data.shape[1]) * self.data.element_size()

    def memory_bytes(self) -> int:
        """Payload + Eq. 1 constants — the Table 1/2 memory column."""
        total = int(self.data.numel()) * self.data.element_size()
        if self.params is not None:
            total += 3 * self.d * 4                        # lo / hi / zero f32
        return total

    # -- views -------------------------------------------------------------
    def encode_queries(self, queries) -> torch.Tensor:
        """h(q) of Definition 2: map queries into the store's code space
        (B1 on the card); queries move to the store's device explicitly."""
        from repro_torch.kernels import ops as K

        q = to_tensor(queries, device=self.device, dtype=torch.float32)
        if not self.quantized:
            return q
        p = self.params
        q = K.quantize(q, p.lo, p.hi, p.zero, bits=p.bits)
        if self.packed and self.d_eff != self.d:
            q = torch.nn.functional.pad(q, (0, self.d_eff - self.d))
        return q

    def unpacked(self) -> torch.Tensor:
        """Full-width payload view ([N, d_eff]); unpacks int4 on the fly."""
        return PK.unpack_int4(self.data) if self.packed else self.data

    def take(self, ids: torch.Tensor) -> torch.Tensor:
        """Gather rows by id at full width (unpacks only what was gathered)."""
        rows = self.data[ids]
        return PK.unpack_int4(rows) if self.packed else rows

    # -- disk round-trip fragments ----------------------------------------
    def state(self, prefix: str = "") -> tuple[dict[str, Any], dict[str, Any]]:
        """Serializable (arrays, meta) fragments, keyed as the reference's
        (``{prefix}data``, ``{prefix}q_lo|q_hi|q_zero``, ``{prefix}store``)."""
        arrays: dict[str, Any] = {f"{prefix}data": self.data}
        meta: dict[str, Any] = {
            f"{prefix}store": {"n": self.n, "d": self.d, "bits": self.bits,
                               "packed": self.packed, "base": self.base,
                               "quant": None},
        }
        if self.params is not None:
            arrays.update({f"{prefix}q_lo": self.params.lo,
                           f"{prefix}q_hi": self.params.hi,
                           f"{prefix}q_zero": self.params.zero})
            meta[f"{prefix}store"]["quant"] = {"bits": self.params.bits,
                                               "scheme": self.params.scheme}
        return arrays, meta

    @staticmethod
    def from_state(arrays: dict[str, Any], meta: dict[str, Any],
                   prefix: str = "", device=None) -> "CodeStore":
        sm = meta[f"{prefix}store"]
        params = None
        if sm["quant"] is not None:
            params = Qz.QuantParams(
                lo=to_tensor(arrays[f"{prefix}q_lo"], device=device),
                hi=to_tensor(arrays[f"{prefix}q_hi"], device=device),
                zero=to_tensor(arrays[f"{prefix}q_zero"], device=device),
                bits=int(sm["quant"]["bits"]),
                scheme=str(sm["quant"]["scheme"]),
            )
        return CodeStore(
            n=int(sm["n"]), d=int(sm["d"]), bits=int(sm["bits"]),
            packed=bool(sm["packed"]),
            data=to_tensor(arrays[f"{prefix}data"], device=device).contiguous(),
            params=params, base=int(sm["base"]),
        )


@dataclasses.dataclass(frozen=True)
class PQStore:
    """Product-quantization storage: codewords + per-subspace codebooks.

    ``bits`` is the codeword index width.  At 8 bits, ``codes`` is
    [N, M] uint8 into 256-codeword codebooks; at 4 bits, codebooks hold
    16 codewords and codes are bit-packed two per byte —
    [N, ceil(M/2)] uint8 via :func:`repro_torch.core.pack.pack_uint4` (odd
    M pads a zero-code column; the ADC side pads its LUT with a zero
    subspace slice, so scores are unchanged).
    """

    n: int
    m: int                    # subspaces
    lpq_tables: bool
    codes: torch.Tensor       # [N, M] uint8 | [N, ceil(M/2)] uint8 packed
    codebooks: torch.Tensor   # [M, 2^bits, d/M] f32
    bits: int = 8

    def __post_init__(self):
        if self.bits not in PQ_CODE_BITS:
            raise ValueError(
                f"PQ codeword width must be one of {PQ_CODE_BITS} bits "
                f"(16- or 256-codeword codebooks), got {self.bits}"
            )

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @property
    def packed(self) -> bool:
        """Whether codes are stored two-per-byte (the 4-bit layout)."""
        return self.bits == 4

    @property
    def n_codewords(self) -> int:
        return 2 ** self.bits

    def unpacked_codes(self) -> torch.Tensor:
        """[N, M] codeword-index view; unpacks the 4-bit layout on the fly."""
        if not self.packed:
            return self.codes
        return PK.unpack_uint4(self.codes)[:, : self.m]

    @property
    def row_bytes(self) -> int:
        """Bytes of code payload read to score one corpus row."""
        return int(self.codes.shape[1])

    @property
    def code_bytes(self) -> int:
        """Bytes of the code matrix alone (the Table-1 codes column)."""
        return int(self.codes.numel())

    def memory_bytes(self) -> int:
        return self.code_bytes + int(self.codebooks.numel()) * 4

    def state(self) -> tuple[dict[str, Any], dict[str, Any]]:
        """Serializable (arrays, meta), keyed as the reference's."""
        arrays = {"codes": self.codes, "codebooks": self.codebooks}
        meta = {"store": {"n": self.n, "m": self.m, "bits": self.bits,
                          "lpq_tables": self.lpq_tables}}
        return arrays, meta

    @staticmethod
    def from_state(arrays: dict[str, Any], meta: dict[str, Any],
                   device=None) -> "PQStore":
        sm = meta["store"]
        return PQStore(
            n=int(sm["n"]), m=int(sm["m"]), lpq_tables=bool(sm["lpq_tables"]),
            codes=to_tensor(arrays["codes"], device=device).contiguous(),
            codebooks=to_tensor(arrays["codebooks"], device=device,
                                dtype=torch.float32).contiguous(),
            bits=int(sm.get("bits", 8)),       # early saves: 8-bit codes
        )
