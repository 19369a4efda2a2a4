"""The runtime subsystem (port of ``repro.runtime``): named process
profiles stamped into every artifact (``profile``), hot-path result and
LUT caching (``cache``), token-bucket admission with a degrade / shed
ladder and deadline propagation (``admission``), background compaction
and drift recalibration off the request path (``maintenance``), and
per-request telemetry (``telemetry``)."""

from repro_torch.runtime import profile
from repro_torch.runtime.admission import (
    ADMIT,
    DEGRADE,
    SHED,
    AdmissionController,
    Decision,
    DegradePolicy,
    TokenBucket,
)
from repro_torch.runtime.cache import (
    MISS,
    CachedSearcher,
    LUTCache,
    TTLLRUCache,
    fingerprint,
)
from repro_torch.runtime.maintenance import MaintenanceScheduler
from repro_torch.runtime.profile import PROFILES, RuntimeProfile
from repro_torch.runtime.telemetry import RequestTrace, Telemetry

__all__ = [
    "profile",
    "RuntimeProfile",
    "PROFILES",
    "TTLLRUCache",
    "LUTCache",
    "CachedSearcher",
    "MISS",
    "fingerprint",
    "AdmissionController",
    "DegradePolicy",
    "TokenBucket",
    "Decision",
    "ADMIT",
    "DEGRADE",
    "SHED",
    "MaintenanceScheduler",
    "Telemetry",
    "RequestTrace",
]
