"""Admission control: token-bucket budgets, bounded queues, graceful
degradation, deadline propagation (port of ``repro.runtime.admission``;
host-side policy, the same decisions on the same clock).

Run open-loop, every arrival executes at full plan depth whatever the
backlog, so overload turns into unbounded queueing delay.  The
``AdmissionController`` puts a shed ladder in front of the Searcher:

    admit     budget available at full cost — run the primary plan
    degrade   budget only covers a *discounted* cost, or the backlog has
              crossed the degrade watermark, or the request's deadline no
              longer fits the observed latency — run the **degraded
              plan** (shallower rerank depth, smaller nprobe/ef: recall
              bends, the process does not break)
    shed      queue at its hard bound, bucket empty even at the
              discounted cost, or deadline already blown — reject
              outright (the only polite answer left)

Costs are measured in *queries* (a 32-query batch spends 32 tokens): the
bucket meters work, not requests.  ``observe`` feeds an EMA of execute
latency back in, which is what deadline re-checks compare remaining
budget against.  Every decision increments shared counters that
telemetry serializes, and the clock is injectable so the ladder is
deterministic under test.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.knn.base import SearchParams

#: decision actions, in ladder order
ADMIT, DEGRADE, SHED = "admit", "degrade", "shed"


@dataclasses.dataclass(frozen=True)
class Decision:
    """One admission verdict: what to run (if anything) and why."""

    action: str                # admit | degrade | shed
    reason: str                # ok | queue | budget | deadline
    tokens: float = 0.0        # tokens actually charged

    @property
    def admitted(self) -> bool:
        return self.action != SHED

    @property
    def degraded(self) -> bool:
        return self.action == DEGRADE


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s, ``burst`` capacity."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        if rate <= 0 or burst <= 0:
            raise ValueError(f"rate/burst must be positive, got {rate}/{burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self.clock = clock
        self._tokens = float(burst)
        self._t = clock()

    def _refill(self) -> None:
        now = self.clock()
        self._tokens = min(self.burst, self._tokens + (now - self._t) * self.rate)
        self._t = now

    @property
    def available(self) -> float:
        self._refill()
        return self._tokens

    def take(self, tokens: float) -> bool:
        self._refill()
        if self._tokens >= tokens:
            self._tokens -= tokens
            return True
        return False


@dataclasses.dataclass(frozen=True)
class DegradePolicy:
    """How a degraded request differs from a full one.

    The knobs mirror the recall/cost dials every plan already has: the
    rerank tail shrinks (or disappears), IVF probes fewer lists, the
    graph walk narrows.  ``degrade_cost`` is the token discount — the
    fraction of full cost a degraded request is charged, which is what
    makes degradation a real pressure valve rather than a rename.
    """

    rerank_scale: float = 0.25      # degraded depth = ceil(scale * full)
    nprobe_scale: float = 0.5
    ef_scale: float = 0.5
    degrade_cost: float = 0.25
    budget_scale: float = 0.5       # cascade stage budgets shrink by this

    def params(self, sp: SearchParams, k: Optional[int] = None) -> SearchParams:
        return dataclasses.replace(
            sp,
            nprobe=max(1, int(sp.nprobe * self.nprobe_scale)),
            ef_search=max(1, int(sp.ef_search * self.ef_scale)),
            budgets=self.budgets(sp.budgets, k),
        )

    def budgets(
        self, budgets: Optional[tuple[int, ...]], k: Optional[int]
    ) -> Optional[tuple[int, ...]]:
        """Degraded cascade stage budgets: every fetch depth shrinks by
        ``budget_scale`` but no stage drops below ``k`` (or below 1 when
        k is unset) — the shrunken schedule must stay a valid
        non-increasing cascade, so the floor is applied uniformly and
        ceil-rounding preserves the ordering of the full schedule."""
        if budgets is None:
            return None
        floor = max(1, int(k or 1))
        return tuple(
            max(floor, int(-(-b * self.budget_scale // 1))) for b in budgets
        )

    def rerank_depth(self, depth: int, k: int) -> int:
        """Degraded rerank depth (never below k; 0 stays 0 = no tail)."""
        if depth <= 0:
            return 0
        return max(k, int(-(-depth * self.rerank_scale // 1)))


class AdmissionController:
    """The shed ladder in front of a serving session.

    rate_qps / burst   token budget (tokens = queries)
    max_queue          hard backlog bound — arrivals beyond it shed
    degrade_queue      soft watermark — arrivals beyond it degrade
                       (default: half the hard bound)
    policy             how much a degraded plan backs off / costs
    counters           any Counter-like mapping with ``+=`` semantics;
                       serve passes telemetry's registry so admission
                       numbers land in the session report for free
    """

    def __init__(
        self,
        *,
        rate_qps: float,
        burst: Optional[float] = None,
        max_queue: int = 64,
        degrade_queue: Optional[int] = None,
        policy: Optional[DegradePolicy] = None,
        clock: Callable[[], float] = time.monotonic,
        counters=None,
    ):
        if max_queue <= 0:
            raise ValueError(f"max_queue must be positive, got {max_queue}")
        self.bucket = TokenBucket(rate_qps, burst or rate_qps, clock)
        self.max_queue = int(max_queue)
        self.degrade_queue = (int(degrade_queue) if degrade_queue is not None
                              else max(1, self.max_queue // 2))
        self.policy = policy or DegradePolicy()
        self.clock = clock
        import collections

        self.counters = counters if counters is not None else collections.Counter()
        self._ema_latency = 0.0

    # -- latency feedback (deadline re-checks compare against this) --------
    def observe(self, latency_s: float, alpha: float = 0.25) -> None:
        if self._ema_latency == 0.0:
            self._ema_latency = float(latency_s)
        else:
            self._ema_latency += alpha * (float(latency_s) - self._ema_latency)

    @property
    def ema_latency(self) -> float:
        return self._ema_latency

    # -- the ladder --------------------------------------------------------
    def admit(self, n_queries: int, queue_depth: int,
              deadline: Optional[float] = None) -> Decision:
        """Arrival-time decision for an ``n_queries``-query request."""
        now = self.clock()
        if deadline is not None and now >= deadline:
            return self._count(Decision(SHED, "deadline"), n_queries)
        if queue_depth >= self.max_queue:
            return self._count(Decision(SHED, "queue"), n_queries)
        cost = float(n_queries)
        degraded_cost = cost * self.policy.degrade_cost
        over_watermark = queue_depth >= self.degrade_queue
        if not over_watermark and self.bucket.take(cost):
            return self._count(Decision(ADMIT, "ok", cost), n_queries)
        if self.bucket.take(degraded_cost):
            reason = "queue" if over_watermark else "budget"
            return self._count(Decision(DEGRADE, reason, degraded_cost),
                               n_queries)
        return self._count(Decision(SHED, "budget"), n_queries)

    def recheck(self, decision: Decision,
                deadline: Optional[float] = None) -> Decision:
        """Dequeue-time deadline propagation: a request admitted at
        arrival may have aged in the queue.  Blown deadline -> shed;
        remaining budget below the observed latency -> degrade."""
        if decision.action == SHED or deadline is None:
            return decision
        now = self.clock()
        if now >= deadline:
            return self._count(Decision(SHED, "deadline"), 0, recheck=True)
        if (decision.action == ADMIT
                and self._ema_latency > 0.0
                and deadline - now < self._ema_latency):
            return self._count(Decision(DEGRADE, "deadline", decision.tokens),
                               0, recheck=True)
        return decision

    def _count(self, d: Decision, n_queries: int, recheck: bool = False) -> Decision:
        self.counters[f"admission_{d.action}"] += 1
        self.counters[f"admission_{d.action}_{d.reason}"] += 1
        if recheck:
            self.counters["admission_rechecks"] += 1
        if d.action == SHED and n_queries:
            self.counters["admission_shed_queries"] += int(n_queries)
        return d
