"""Named runtime profiles: one reproducible environment per serve or
benchmark run (port of ``repro.runtime.profile``).

A ``RuntimeProfile`` names the process-start state of a run, and
``stamp`` writes the resolved facts into every report, so a CPU number can
never be mistaken for a card number and two runs of one profile are
comparable by construction.

    from repro_torch.runtime import profile as rt
    rt.apply(rt.resolve("cuda-serve"))  # at process start
    meta["runtime"] = rt.stamp()        # in every report

Selection order: explicit name > ``REPRO_RUNTIME_PROFILE`` env var >
``"default"``.  The fields and the JSON form are the reference's, so one
profile file serves both packages.  ``apply`` maps each field to its torch
counterpart where one exists:

    platform    None keeps the card default of every entry point; "cpu"
                is the caller asking for the CPU (``device.resolve_device``
                then resolves None to the CPU); "cuda" (or the reference's
                "gpu") raises when no card exists; any other raises
    nan_debug   ``torch.autograd.set_detect_anomaly(check_nan=True)``
    seed        the explicit ``torch.Generator`` seed policy (``key``)
    host_device_count
                the CPU devices ``dist.sharding.default_devices`` gives a
                CPU profile (``cpu-mesh4``: four), so a mesh over them
                shards as the reference's host devices do

These only ride in the stamp: ``xla_flags`` and ``x64`` (no torch
counterpart), and ``deterministic`` (a marker for the trend gate, as in
the reference).
"""

from __future__ import annotations

import dataclasses
import os
import platform as _platform
import warnings
from typing import Optional

import torch

ENV_VAR = "REPRO_RUNTIME_PROFILE"

_PROFILE_FIELDS = ("name", "platform", "host_device_count", "xla_flags",
                   "nan_debug", "x64", "seed", "deterministic")

#: platform names ``apply`` accepts, and the torch device each asks for
PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


@dataclasses.dataclass(frozen=True)
class RuntimeProfile:
    """One named runtime environment, resolved at process start.

    name               registry key, stamped into every artifact
    platform           "cpu" / "cuda" ("gpu"), or None: the card default
    host_device_count  host devices a CPU profile's meshes shard over
    xla_flags          the reference's XLA flags (stamp only)
    nan_debug          fail fast on NaN in autograd
    x64                the reference's 64-bit switch (stamp only)
    seed               the deterministic-seed policy: the base seed every
                       profiled entry point derives its generators from
    deterministic      False marks a profile whose runs are *expected* to
                       differ (e.g. time-seeded soak runs)
    """

    name: str
    platform: Optional[str] = None
    host_device_count: Optional[int] = None
    xla_flags: tuple[str, ...] = ()
    nan_debug: bool = False
    x64: bool = False
    seed: int = 0
    deterministic: bool = True

    # -- (de)serialization round-trip --------------------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["xla_flags"] = list(self.xla_flags)
        return d

    @staticmethod
    def from_dict(d: dict) -> "RuntimeProfile":
        unknown = set(d) - set(_PROFILE_FIELDS)
        if unknown:
            raise ValueError(f"unknown RuntimeProfile fields: {sorted(unknown)}")
        d = dict(d)
        d["xla_flags"] = tuple(d.get("xla_flags") or ())
        return RuntimeProfile(**d)


#: the named registry; "cuda-serve" takes the place of the reference's
#: "tpu-serve"
PROFILES: dict[str, RuntimeProfile] = {
    # honest autodetect: the card, deterministic seed 0
    "default": RuntimeProfile(name="default"),
    # single-process CPU dev box
    "cpu-dev": RuntimeProfile(name="cpu-dev", platform="cpu"),
    # CI profile: CPU, one host device, fixed seed
    "ci-cpu": RuntimeProfile(name="ci-cpu", platform="cpu",
                             host_device_count=1),
    # sharded-serving rehearsal on one host (4 host devices, A14)
    "cpu-mesh4": RuntimeProfile(name="cpu-mesh4", platform="cpu",
                                host_device_count=4),
    # debugging: fail fast on NaN
    "debug-nan": RuntimeProfile(name="debug-nan", platform="cpu",
                                nan_debug=True),
    # GPU serving: the card, raising where there is none
    "cuda-serve": RuntimeProfile(name="cuda-serve", platform="cuda"),
}

#: the profile ``apply`` installed in this process (at most one)
_ACTIVE: Optional[RuntimeProfile] = None
#: this process's backend facts (``backend_facts``), fixed once a profile
#: is applied; ``apply`` and ``_reset_for_tests`` forget them
_FACTS: Optional[dict] = None


def register(profile: RuntimeProfile) -> RuntimeProfile:
    """Add or replace a named profile."""
    PROFILES[profile.name] = profile
    return profile


def from_file(path) -> RuntimeProfile:
    """Load a profile from a JSON file (one ``RuntimeProfile.to_dict()``
    object) and register it; unknown fields are rejected with the field
    list, and the profile must be named."""
    import json

    with open(path) as f:
        d = json.load(f)
    if not isinstance(d, dict):
        raise ValueError(
            f"profile file {path!r} must hold one JSON object "
            f"(RuntimeProfile.to_dict()), got {type(d).__name__}"
        )
    if "name" not in d:
        raise ValueError(
            f"profile file {path!r} needs a 'name' field — profiles are "
            "named artifacts stamped into every report"
        )
    return register(RuntimeProfile.from_dict(d))


def to_file(profile: RuntimeProfile, path) -> None:
    """Write ``profile`` as JSON — ``from_file``'s exact inverse."""
    import json

    with open(path, "w") as f:
        json.dump(profile.to_dict(), f, indent=2, sort_keys=True)
        f.write("\n")


def resolve(name: Optional[str] = None) -> RuntimeProfile:
    """Resolve a profile: explicit name > $REPRO_RUNTIME_PROFILE > default."""
    name = name or os.environ.get(ENV_VAR) or "default"
    try:
        return PROFILES[name]
    except KeyError:
        raise ValueError(
            f"unknown runtime profile {name!r}; registered: "
            f"{sorted(PROFILES)}"
        ) from None


def apply(profile: RuntimeProfile) -> RuntimeProfile:
    """Install ``profile`` into this process (idempotent per profile).

    A second ``apply`` of the *same* profile is a no-op; a different one
    warns and is ignored (profiles are process-start state).  A platform
    the process cannot give raises ``ValueError`` / ``RuntimeError``.
    """
    global _ACTIVE, _FACTS
    if _ACTIVE is not None:
        if profile.name != _ACTIVE.name:
            warnings.warn(
                f"runtime profile {_ACTIVE.name!r} already applied; ignoring "
                f"{profile.name!r} (profiles are process-start state)",
                RuntimeWarning, stacklevel=2,
            )
        return _ACTIVE
    if profile.platform is not None:
        if profile.platform not in PLATFORMS:
            raise ValueError(
                f"runtime profile {profile.name!r}: platform "
                f"{profile.platform!r} is not one of {sorted(PLATFORMS)}")
        if (PLATFORMS[profile.platform] == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError(
                f"runtime profile {profile.name!r} asks for the GPU but no "
                "CUDA device is available")
    if profile.nan_debug:
        torch.autograd.set_detect_anomaly(True, check_nan=True)
    _ACTIVE, _FACTS = profile, None
    return profile


def active() -> RuntimeProfile:
    """The applied profile, or the resolved-but-unapplied default — so
    ``stamp`` always has a name to report."""
    return _ACTIVE if _ACTIVE is not None else resolve()


def platform_device() -> Optional[str]:
    """The device the applied profile asks entry points to default to
    ("cpu" / "cuda"), or None where no profile names one."""
    if _ACTIVE is None or _ACTIVE.platform is None:
        return None
    return PLATFORMS.get(_ACTIVE.platform)


def host_devices() -> int:
    """The CPU devices a CPU run shards over: the applied profile's
    ``host_device_count`` where its platform is the CPU, else 1."""
    if platform_device() != "cpu":
        return 1
    return max(1, int(_ACTIVE.host_device_count or 1))


def key(profile: Optional[RuntimeProfile] = None) -> torch.Generator:
    """A CPU ``torch.Generator`` seeded with the profile's seed (the seed
    policy in one place)."""
    return torch.Generator().manual_seed((profile or active()).seed)


def backend() -> str:
    """"cuda" where entry points default to the card and one exists, else
    "cpu" (where the kernels' plain versions run)."""
    if platform_device() == "cpu" or not torch.cuda.is_available():
        return "cpu"
    return "cuda"


def backend_facts() -> dict:
    """The stamp keys two tuning tables must agree on (``backend``,
    ``device_kind``, ``interpret``), worked out once a process: every
    tuned dispatch compares them (``tune.table.lookup``)."""
    global _FACTS
    if _FACTS is None:
        be = backend()
        _FACTS = {"backend": be,
                  "device_kind": (torch.cuda.get_device_name(0)
                                  if be == "cuda" else "cpu"),
                  "interpret": be == "cpu"}
    return _FACTS


def stamp(profile: Optional[RuntimeProfile] = None) -> dict:
    """The runtime-metadata block every report embeds: the resolved facts
    (backend, device kind, device count, whether only the kernels' plain
    versions run) beside the profile that asked for them."""
    p = profile or active()
    facts = backend_facts()
    be = facts["backend"]
    return {
        "profile": p.name,
        # the active TuneTable's dispatch hash (None = fallback rows)
        "tune_table": _tune_table_hash(),
        "applied": _ACTIVE is not None,
        "backend": be,
        "device_kind": facts["device_kind"],
        "n_devices": (torch.cuda.device_count() if be == "cuda"
                      else host_devices()),
        "interpret": facts["interpret"],
        "platform": _platform.platform(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "seed": p.seed,
        "deterministic": p.deterministic,
        "nan_debug": p.nan_debug,
        "x64": p.x64,
        "xla_flags": list(p.xla_flags),
        "host_device_count": p.host_device_count,
    }


def _tune_table_hash() -> Optional[str]:
    """The active TuneTable's dispatch hash (lazy import: ``tune.table``
    depends on this module for ``live_stamp``)."""
    from repro_torch.tune import table as tunetable

    return tunetable.active_hash()


def _reset_for_tests() -> None:
    """Test hook: forget the applied profile."""
    global _ACTIVE, _FACTS
    _ACTIVE = _FACTS = None
