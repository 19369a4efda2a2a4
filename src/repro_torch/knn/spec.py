"""Unified index configuration: ``QuantSpec``, ``IndexSpec`` and the
FAISS-style factory-string parser (port of ``repro.knn.spec``: the whole
grammar is kept, so every factory string parses and round-trips as in the
reference, and every kind it parses is built).

The paper's central claim is that low-precision quantization is an
*implementation-level* substitution — "it can be combined with existing
KNN algorithms".  These spec objects make that composition expressible as
one API: a single ``QuantSpec`` describes the (Q, phi) family of Eq. 1
(bits, scheme, clamp width, optionally pre-learned constants) and plugs
unchanged into any index ``kind``; an ``IndexSpec`` adds the per-kind
build parameters.  ``parse_factory`` turns FAISS-style strings into specs:

    "flat"                  exhaustive fp32 scan
    "flat,lpq8"             exhaustive int8 scan (the paper's Table 2 arm)
    "ivf256,lpq8"           IVF, 256 lists, int8 codes
    "hnsw32,lpq8@gaussian:3" HNSW M=32, int8 with 3-sigma Gaussian clamp
    "graph24,lpq8"          NGT-equivalent graph index, degree 24
    "pq64+lpq"              PQ with 64 subspaces, int8 ADC tables
    "pq16x4"                PQ with 16 subspaces and 4-bit codewords:
                            16-entry codebooks, codes bit-packed two per
                            byte (half the code bytes of pq16); "pq64"
                            stays an alias for "pq64x8"
    "pq16x4,lpq8"           the fused-ADC arm: packed 4-bit codes scored
                            in-kernel against int8-quantized LUTs
    "flat,lpq8,l2"          metric override fragment (ip | l2 | angular)
    "flat,lpq4+r32"         packed int4 scan + fp32 rerank tail (§3.4
                            recall recovery; DESIGN.md §9)
    "pq16+lpq,r32"          standalone rerank fragment for kinds whose
                            quant rides elsewhere (PQ ADC tables)
    "stream(ivf256,lpq4)+r32"  mutable LSM-style wrapper around any other
                            kind: memtable + quantized segments +
                            tombstones + live compaction (DESIGN.md §10)
    "cascade(pq16x4|lpq8|r32)"  N-stage scoring cascade (DESIGN.md §14):
                            the head stage (any non-stream factory) prunes
                            the corpus to a per-stage candidate budget,
                            each later stage re-scores the survivors at
                            higher precision (lpq<bits> int codes, r8 int8,
                            r32 fp32), the final stage settles the top-k
    "ivf64,lpq8,regions"    per-region Eq. 1 constants: one constant set
                            per IVF list / graph neighborhood instead of
                            one global set, with density-scaled clipping

Grammar: comma-separated fragments.  Exactly one *kind* fragment
(``flat`` | ``ivf<nlist>`` | ``hnsw<M>`` | ``graph<degree>`` |
``pq<M>[x<b>][+lpq]`` with b in {4, 8}), at most one *quant* fragment
(``lpq<bits>[@<scheme>][:<sigmas>][+r<rbits>]``), at most one *metric*
fragment, at most one *rerank* fragment (``r<rbits>``, rbits in {8, 32} —
the precision of the exact re-scoring store the Searcher's rerank tail
gathers from).  ``to_factory`` is the inverse, up to default elision.

The mutable wrapper is an outer production: ``stream(<factory>)[+r<N>]``,
where ``<factory>`` is any non-stream factory string (the sealed-segment
kind) and the rerank suffix — whether written inside or outside the
parens — names the precision of the cross-segment merge/rerank store.

The cascade is a second outer production: ``cascade(<head>|<stage>|...)``
with ``|``-separated stages.  The head is any non-stream, non-cascade
factory string; every later stage is a precision fragment — ``lpq<bits>``
(its own Eq. 1 constants, learned on the build corpus) or ``r8`` / ``r32``
(the rerank-store precisions).  Stage fetch budgets are *plan-time* knobs
(``SearchParams.budgets``), not grammar, so one built cascade serves any
budget schedule.  ``stream(cascade(...))`` composes; a rerank fragment
inside the head is rejected — write it as a later stage instead.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Mapping, Optional

from repro_torch.core import quant as Qz
from repro_torch.engine.store import PQ_CODE_BITS

METRICS = ("ip", "l2", "angular")

#: kind -> (numeric build-parameter set by the factory fragment, default)
KIND_PARAM = {
    "flat": (None, None),
    "ivf": ("nlist", 64),
    "hnsw": ("m", 16),
    "graph": ("degree", 32),
    "pq": ("m", 8),
    # the mutable LSM wrapper; its "parameter" is a whole inner factory
    # string carried in params["inner"], not a numeric fragment
    "stream": (None, None),
    # the multi-stage scoring cascade; its "parameter" is the normalized
    # "|"-joined stage list carried in params["stages"]
    "cascade": (None, None),
}


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """The paper's quantization family as a reusable configuration.

    ``params`` may carry pre-learned Eq. 1 constants so several index
    components (or several indexes over the same corpus) share one
    learn pass; when absent, ``learn`` fits them on the build corpus.

    ``packed`` selects bit-packed storage (two 4-bit codes per byte).
    ``None`` means automatic: 4-bit codes pack (honest width — the
    ``lpq4`` factory arm), everything else stores at dtype width.  Pass
    ``packed=False`` to keep int4 codes at int8 width (the unpacked
    reference arm the parity tests compare against).
    """

    bits: int = 8
    scheme: str = "gaussian"
    sigmas: float = 1.0
    params: Optional[Qz.QuantParams] = None
    packed: Optional[bool] = None

    @property
    def effective_packed(self) -> bool:
        return self.bits == 4 if self.packed is None else self.packed

    def learn(self, corpus) -> Qz.QuantParams:
        """Resolve Eq. 1 constants: reuse pre-learned params or fit."""
        if self.params is not None:
            return self.params
        return Qz.learn_params(
            corpus, bits=self.bits, scheme=self.scheme, sigmas=self.sigmas
        )

    def encode(self, x, params: Qz.QuantParams):
        """Apply Eq. 1 through the kernel path — the single quantize
        entrypoint every index build/query routes through."""
        from repro_torch.kernels import ops as K

        return K.quantize(x, params.lo, params.hi, params.zero, bits=params.bits)

    def build_store(self, corpus, base: int = 0):
        """learn + encode + (maybe) pack into an ``engine.CodeStore`` —
        how every index build materializes its corpus payload (on the
        corpus's device: B1 encodes it there)."""
        from repro_torch.engine import CodeStore

        if self.bits > 8:
            raise ValueError(
                f"the scoring engine supports B <= 8 (got bits={self.bits}): "
                "wider codes overflow int32 score accumulation"
            )
        qp = self.learn(corpus).to(corpus.device)
        codes = self.encode(corpus, qp)
        return CodeStore.from_codes(
            codes, qp, pack=self.effective_packed, base=base
        )

    def with_params(self, params: Qz.QuantParams) -> "QuantSpec":
        return dataclasses.replace(self, params=params)

    def to_fragment(self) -> str:
        frag = f"lpq{self.bits}"
        if self.scheme != "gaussian":
            frag += f"@{self.scheme}"
        if self.sigmas != 1.0:
            frag += f":{self.sigmas:g}"
        return frag


def quant_spec_from_kwargs(
    quantized: bool = False,
    bits: int = 8,
    scheme: str | Qz.Scheme = Qz.Scheme.GAUSSIAN,
    sigmas: float = 1.0,
    params: Optional[Qz.QuantParams] = None,
) -> Optional[QuantSpec]:
    """Adapter from the pre-unification per-index kwargs to a QuantSpec.

    Legacy semantics: ``params`` is only honored when ``quantized=True``
    (an fp32 build ignores it), exactly as the old per-index builds did.
    """
    if not quantized:
        return None
    if params is not None:
        return QuantSpec(
            bits=params.bits, scheme=params.scheme, sigmas=sigmas, params=params
        )
    return QuantSpec(bits=bits, scheme=Qz.Scheme(scheme).value, sigmas=sigmas)


#: precisions a rerank store may hold: fp32 exact or int8 codes
RERANK_BITS = (8, 32)


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """One config object any index, benchmark or serving path accepts.

    ``rerank_bits`` asks the build to keep a second, higher-precision
    ``CodeStore`` of the corpus (32 = fp32, 8 = int8) that the Searcher's
    rerank tail re-scores quantized candidates against — the paper's §3.4
    recall-recovery pattern as a first-class config (``"flat,lpq4+r32"``).
    """

    kind: str = "flat"
    metric: str = "ip"
    quant: Optional[QuantSpec] = None
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    rerank_bits: Optional[int] = None

    def __post_init__(self):
        if self.kind not in KIND_PARAM:
            raise ValueError(
                f"unknown index kind {self.kind!r}; known: {sorted(KIND_PARAM)}"
            )
        if self.metric not in METRICS:
            raise ValueError(f"unknown metric {self.metric!r}; known: {METRICS}")
        if self.rerank_bits is not None and self.rerank_bits not in RERANK_BITS:
            raise ValueError(
                f"rerank_bits must be one of {RERANK_BITS} (got "
                f"{self.rerank_bits!r}): the rerank store is fp32 or int8"
            )
        if self.kind == "stream" and "inner" not in self.params:
            raise ValueError(
                "a stream spec needs params['inner'] — the factory string "
                "of the kind its sealed segments are built as, e.g. "
                "parse_factory('stream(flat,lpq4)')"
            )
        if self.kind == "cascade":
            if "stages" not in self.params:
                raise ValueError(
                    "a cascade spec needs params['stages'] — the "
                    "'|'-joined stage list, e.g. "
                    "parse_factory('cascade(pq16x4|lpq8|r32)')"
                )
            if self.rerank_bits is not None:
                raise ValueError(
                    "a cascade spec takes no rerank fragment: the rerank "
                    "tail is generalized by the stage list — write "
                    "'cascade(...|r32)' instead of '+r32'"
                )
        if self.params.get("regions") and self.kind in ("flat", "pq"):
            raise ValueError(
                f"'regions' needs a partitioned kind (per-IVF-list or "
                f"per-graph-neighborhood constants): {self.kind!r} has no "
                "regions — use ivf/hnsw/graph, e.g. 'ivf64,lpq8,regions'"
            )
        if (self.kind == "pq"
                and self.params.get("bits") not in (None, *PQ_CODE_BITS)):
            raise ValueError(
                f"pq codeword width must be one of {PQ_CODE_BITS} bits "
                f"(16- or 256-codeword codebooks), got "
                f"bits={self.params['bits']!r}"
            )

    def with_overrides(self, **overrides) -> "IndexSpec":
        """Merge extra build parameters (ef_construction, key knobs...)."""
        return dataclasses.replace(self, params={**dict(self.params), **overrides})

    def to_factory(self) -> str:
        """Inverse of ``parse_factory`` (defaults elided)."""
        if self.kind == "stream":
            frag = f"stream({self.params['inner']})"
            if self.rerank_bits is not None:
                frag += f"+r{self.rerank_bits}"
            return frag
        if self.kind == "cascade":
            return f"cascade({self.params['stages']})"
        pname, pdefault = KIND_PARAM[self.kind]
        frag = self.kind
        if pname is not None:
            frag += str(self.params.get(pname, pdefault))
        if self.kind == "pq" and int(self.params.get("bits") or 8) != 8:
            frag += f"x{int(self.params['bits'])}"
        if self.kind == "pq" and self.params.get("lpq_tables"):
            frag += "+lpq"
        parts = [frag]
        if self.quant is not None:
            qfrag = self.quant.to_fragment()
            if self.rerank_bits is not None:
                qfrag += f"+r{self.rerank_bits}"
            parts.append(qfrag)
        elif self.rerank_bits is not None:
            parts.append(f"r{self.rerank_bits}")
        if self.params.get("regions"):
            parts.append("regions")
        if self.metric != "ip":
            parts.append(self.metric)
        return ",".join(parts)


_KIND_RE = re.compile(r"^(flat|ivf|hnsw|graph|pq)(\d+)?(?:x(\d+))?(\+lpq)?$")
_QUANT_RE = re.compile(
    r"^lpq(\d+)(?:@([a-z_0-9]+))?(?::([0-9.]+))?(?:\+r(\d+))?$"
)
_RERANK_RE = re.compile(r"^r(\d+)$")


_STREAM_RE = re.compile(r"^stream\((.+)\)(\+r(\d+))?$", re.IGNORECASE)
_CASCADE_RE = re.compile(r"^cascade\((.+)\)$", re.IGNORECASE)


def _parse_cascade(factory: str, metric: str | None) -> IndexSpec:
    """``cascade(<head>|<stage>|...)`` -> a kind-"cascade" spec.

    The head stage is parsed recursively (any non-stream, non-cascade
    factory) and re-serialized in normalized form; later stages are
    precision fragments (``lpq<bits>[@scheme][:sigmas]`` | ``r8`` |
    ``r32``).  The normalized ``"|"``-joined stage list rides in
    ``params["stages"]`` so the spec stays a plain JSON-able record,
    exactly like stream's ``params["inner"]``.
    """
    m = _CASCADE_RE.match(factory.strip())
    assert m is not None
    stages = [s.strip() for s in m.group(1).split("|")]
    if len(stages) < 2:
        raise ValueError(
            f"cascade needs at least two '|'-separated stages (a head "
            f"index and one refinement), got {factory!r}"
        )
    if _STREAM_RE.match(stages[0]) or _CASCADE_RE.match(stages[0]):
        raise ValueError(
            f"cascade head must be a plain kind, not {stages[0]!r}: "
            "wrap the whole cascade in stream(...) instead of nesting"
        )
    head = parse_factory(stages[0], metric=metric)
    if head.rerank_bits is not None:
        raise ValueError(
            f"cascade head {stages[0]!r} carries a rerank fragment — "
            "write the exact tail as a later stage: "
            "cascade(pq16x4|lpq8|r32), not cascade(pq16x4+r32|lpq8)"
        )
    norm = [head.to_factory()]
    for s in stages[1:]:
        frag = s.lower()
        mq = _QUANT_RE.match(frag)
        if mq:
            if mq.group(4):
                raise ValueError(
                    f"cascade stage {s!r} carries a '+r' suffix — each "
                    "precision is its own stage: write '|lpq8|r32'"
                )
            bits = int(mq.group(1))
            if not 1 <= bits <= 8:
                raise ValueError(
                    f"lpq bits must be in [1, 8], got {bits} in {factory!r}"
                )
            scheme = mq.group(2) or "gaussian"
            Qz.Scheme(scheme)  # validate early
            sigmas = float(mq.group(3)) if mq.group(3) else 1.0
            norm.append(
                QuantSpec(bits=bits, scheme=scheme, sigmas=sigmas).to_fragment()
            )
            continue
        mr = _RERANK_RE.match(frag)
        if mr:
            rbits = int(mr.group(1))
            if rbits not in RERANK_BITS:
                raise ValueError(
                    f"rerank precision must be one of {RERANK_BITS} "
                    f"(fp32 or int8 store), got r{rbits} in {factory!r}"
                )
            norm.append(f"r{rbits}")
            continue
        raise ValueError(
            f"cascade stage {s!r} in {factory!r} must be a precision "
            "fragment: lpq<bits>[@scheme][:sigmas], r8, or r32"
        )
    return IndexSpec(
        kind="cascade",
        metric=head.metric,
        params={"stages": "|".join(norm)},
    )


def _parse_stream(factory: str, metric: str | None) -> IndexSpec:
    """``stream(<inner factory>)[+r<N>]`` -> a kind-"stream" spec.

    The inner factory is parsed recursively (nesting ``stream`` inside
    ``stream`` is rejected) and re-serialized in normalized form into
    ``params["inner"]`` — segment builds call ``parse_factory`` on it
    again, so the spec stays a plain JSON-able record.  A rerank fragment
    written inside the parens is lifted to the outer spec: the rerank /
    merge store belongs to the wrapper (which keeps the raw fp32
    payloads), not to any single sealed segment.
    """
    m = _STREAM_RE.match(factory.strip())
    assert m is not None
    inner_str = m.group(1)
    if _STREAM_RE.match(inner_str.strip()):
        raise ValueError(
            f"nested stream(...) in {factory!r}: the mutable wrapper "
            "already composes with every registered kind"
        )
    inner = parse_factory(inner_str, metric=metric)
    rerank_bits = inner.rerank_bits
    if m.group(3) is not None:
        if rerank_bits is not None:
            raise ValueError(f"duplicate rerank fragment in {factory!r}")
        rerank_bits = int(m.group(3))
        if rerank_bits not in RERANK_BITS:
            raise ValueError(
                f"rerank precision must be one of {RERANK_BITS} "
                f"(fp32 or int8 store), got r{rerank_bits} in {factory!r}"
            )
    inner = dataclasses.replace(inner, rerank_bits=None)
    return IndexSpec(
        kind="stream",
        metric=inner.metric,
        params={"inner": inner.to_factory()},
        rerank_bits=rerank_bits,
    )


def parse_factory(factory: str, metric: str | None = None) -> IndexSpec:
    """Parse a FAISS-style factory string into an ``IndexSpec``.

    ``metric`` provides the default when the string has no metric fragment.
    """
    if _STREAM_RE.match(factory.strip()):
        return _parse_stream(factory, metric)
    if _CASCADE_RE.match(factory.strip()):
        return _parse_cascade(factory, metric)
    if re.match(r"^cascade\(.*\)\+r\d+$", factory.strip(), re.IGNORECASE):
        raise ValueError(
            f"a cascade takes no '+r' suffix ({factory!r}): the final "
            "stage IS the rerank — spell it cascade(...|r32)"
        )
    kind = None
    params: dict[str, Any] = {}
    quant = None
    rerank_bits: Optional[int] = None
    regions = False
    out_metric = metric or "ip"
    metric_seen = False

    def _set_rerank(bits_str: str) -> None:
        nonlocal rerank_bits
        if rerank_bits is not None:
            raise ValueError(f"duplicate rerank fragment in {factory!r}")
        rbits = int(bits_str)
        if rbits not in RERANK_BITS:
            raise ValueError(
                f"rerank precision must be one of {RERANK_BITS} "
                f"(fp32 or int8 store), got r{rbits} in {factory!r}"
            )
        rerank_bits = rbits

    for raw in factory.split(","):
        frag = raw.strip().lower()
        if not frag:
            continue
        if frag in METRICS:
            if metric_seen:
                raise ValueError(f"duplicate metric fragment in {factory!r}")
            metric_seen = True
            out_metric = frag
            continue
        if frag == "regions":
            if regions:
                raise ValueError(f"duplicate regions fragment in {factory!r}")
            regions = True
            continue
        mq = _QUANT_RE.match(frag)
        if mq:
            if quant is not None:
                raise ValueError(f"duplicate quant fragment in {factory!r}")
            bits = int(mq.group(1))
            if not 1 <= bits <= 8:
                # int16 codes overflow the engine's int32 accumulation
                # (d * (2^15)^2 > 2^31 already at d=2) — the paper's
                # low-precision regime is B <= 8
                raise ValueError(
                    f"lpq bits must be in [1, 8], got {bits} in {factory!r}"
                )
            scheme = mq.group(2) or "gaussian"
            Qz.Scheme(scheme)  # validate early
            sigmas = float(mq.group(3)) if mq.group(3) else 1.0
            quant = QuantSpec(bits=bits, scheme=scheme, sigmas=sigmas)
            if mq.group(4):
                _set_rerank(mq.group(4))
            continue
        mr = _RERANK_RE.match(frag)
        if mr:
            _set_rerank(mr.group(1))
            continue
        mk = _KIND_RE.match(frag)
        if mk:
            if kind is not None:
                raise ValueError(f"duplicate kind fragment in {factory!r}")
            kind = mk.group(1)
            pname, pdefault = KIND_PARAM[kind]
            if mk.group(2) is not None:
                if pname is None:
                    raise ValueError(f"{kind!r} takes no numeric parameter")
                params[pname] = int(mk.group(2))
            elif pname is not None:
                params[pname] = pdefault
            if mk.group(3) is not None:
                if kind != "pq":
                    raise ValueError(
                        f"codeword-width suffix 'x{mk.group(3)}' only "
                        f"composes with pq, not {kind!r} (in {factory!r})"
                    )
                cbits = int(mk.group(3))
                if cbits not in PQ_CODE_BITS:
                    raise ValueError(
                        f"pq codeword width must be one of {PQ_CODE_BITS} "
                        f"bits (16- or 256-codeword codebooks), got "
                        f"'x{cbits}' in {factory!r}"
                    )
                if cbits != 8:              # pq<M> stays an alias of x8
                    params["bits"] = cbits
            if mk.group(4):
                if kind != "pq":
                    raise ValueError("'+lpq' only composes with pq")
                params["lpq_tables"] = True
            continue
        raise ValueError(f"cannot parse factory fragment {raw!r} in {factory!r}")

    if kind is None:
        raise ValueError(f"no index kind in factory string {factory!r}")
    if kind == "pq" and quant is not None:
        # the paper's composition: LPQ applied after the codebook mapping
        # step means int8 ADC tables (there is no separate code path for
        # quantizing PQ codes — they are already 1 byte).  Only the
        # default int8 fragment is implemented; reject variants rather
        # than silently substituting int8.
        if quant != QuantSpec(bits=8, scheme="gaussian", sigmas=1.0):
            raise ValueError(
                f"pq only composes with plain 'lpq8' ADC tables, got "
                f"{quant.to_fragment()!r} in {factory!r}"
            )
        params["lpq_tables"] = True
    if regions:
        if quant is None:
            raise ValueError(
                f"'regions' scales per-region Eq. 1 constants — add an "
                f"lpq fragment, e.g. 'ivf64,lpq8,regions' (in {factory!r})"
            )
        params["regions"] = True
    return IndexSpec(kind=kind, metric=out_metric, quant=quant, params=params,
                     rerank_bits=rerank_bits)


def resolve_build_spec(
    kind: str,
    spec: "IndexSpec | str | None",
    *,
    metric: str,
    quant: Optional[QuantSpec] = None,
    **defaults,
) -> tuple[IndexSpec, dict[str, Any]]:
    """Shared entry adapter for every index ``build``.

    ``spec=None`` means the caller used the legacy kwargs: assemble a spec
    from ``metric`` / ``quant`` / ``defaults``.  Otherwise coerce factory
    strings and fill unset per-kind params from ``defaults``.  Returns the
    resolved spec plus the merged build-parameter dict.
    """
    if spec is None:
        spec = IndexSpec(kind=kind, metric=metric, quant=quant,
                         params=dict(defaults))
    else:
        spec = as_spec(spec, metric=metric)
        if spec.kind != kind:
            raise ValueError(f"spec kind {spec.kind!r} routed to {kind!r} build")
    return spec, {**defaults, **dict(spec.params)}


def build_rerank_store(spec: IndexSpec, corpus):
    """Materialize the spec's rerank store (None when not requested).

    fp32 (r32) keeps the corpus verbatim; int8 (r8) learns its own Eq. 1
    constants — the rerank arm's accuracy must not inherit the scan arm's
    aggressive clamp.  Every kind's build calls this after
    ``resolve_build_spec`` so ``"<kind>,lpq4+r32"`` works uniformly.
    """
    if spec.rerank_bits is None:
        return None
    from repro_torch.engine import CodeStore

    if spec.rerank_bits == 32:
        return CodeStore.dense(corpus)
    return QuantSpec(bits=8).build_store(corpus)


def as_spec(spec: "IndexSpec | str", metric: str | None = None) -> IndexSpec:
    """Coerce a factory string or pass through an IndexSpec."""
    if isinstance(spec, IndexSpec):
        return spec
    if isinstance(spec, str):
        return parse_factory(spec, metric=metric)
    raise TypeError(f"expected IndexSpec or factory string, got {type(spec)!r}")
