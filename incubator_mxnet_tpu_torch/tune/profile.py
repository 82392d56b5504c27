"""mx.tune.profile of the PyTorch port — persisted deployment profiles and
their activation.

Counterpart of `incubator_mxnet_tpu/tune/profile.py`, with the same
schema, hashes, events and counters: a profile file is byte-for-byte the
JAX package's for the same inputs, so profiles cross both ways.

A `DeploymentProfile` is the durable output of a sweep: the winning knob
assignment keyed by **(model fingerprint, hardware fingerprint)**, saved
as JSON under ``MXNET_TUNE_PROFILE_DIR`` (default: a sibling of
``MXNET_COMPILE_CACHE_DIR``, so a replica's deployment root holds its
tuned knobs).

Activation is process-global and explicit: `activate(profile, ...)`
validates every value against the knob catalog and checks both
fingerprints; a mismatch **falls back loudly to defaults** (structured
`tune.profile_mismatch` event + counter, nothing applied) rather than
silently tuning model A with model B's winners. Wired constructors
(`ContinuousEngine`, `FusedTrainStep`, `ImageRecordIter` and its decode
pool, `CallableModel`, the dispatch engine) consult `resolve()` between
their explicit arguments and their env/default fallbacks, giving the
knob precedence:

    explicit constructor arg  >  active profile  >  MXNET_* env  >  default

Profile beats env on purpose: a deployment profile is a measured,
fingerprint-checked artifact while an env var is ambient shell state.
``MXNET_TUNE_DISABLE=1`` is the explicit kill switch.

`hardware_fingerprint(device=None)` describes the card from torch
(platform "gpu", `torch.cuda.get_device_name`, `device_count`, whether
`mem_get_info` answers) and runs no work; without a card, or for
``device="cpu"``, it gives the JAX package's CPU values, so a profile
swept on the card fails the fingerprint gate loudly on a host without it.
"""
from __future__ import annotations

import json
import os
import threading

from ..base import MXNetError, get_env
from ..fault import _log_event, atomic_output
from ..telemetry.registry import stats_group as _stats_group
from . import space as _space

__all__ = ["DeploymentProfile", "model_fingerprint",
           "hardware_fingerprint", "profile_dir", "profile_path",
           "activate", "deactivate", "active", "resolve", "lookup",
           "disabled", "TUNE_STATS", "tune_stats", "SCHEMA_VERSION"]

SCHEMA_VERSION = 1

_STATS_LOCK = threading.Lock()
TUNE_STATS = _stats_group("tune", {
    "trials": 0,            # sweep trials launched (ok + failed)
    "trials_failed": 0,     # trials that crashed / hung / errored
    "trial_ms": 0.0,        # cumulative wall-clock spent measuring
    "profile_applied": 0,   # successful activate() calls
    "profile_mismatch": 0,  # fingerprint-mismatch fallbacks to defaults
}, lock=_STATS_LOCK, help="deployment-profile autotuner counters")


def tune_stats(reset=False):
    """Snapshot (optionally reset) of the process-wide tune counters."""
    return TUNE_STATS.snapshot(reset=reset)


# process-global activation state: [profile-or-None, env-autoload-done]
_ACTIVE = [None]
_AUTOLOADED = [False]
# reentrant: active() holds it across the autoload call into activate()
_LOCK = threading.RLock()


def disabled():
    """True when MXNET_TUNE_DISABLE kills the profile tier entirely."""
    return bool(get_env("MXNET_TUNE_DISABLE", False, typ=bool))


def _canon_hash(obj, n=12):
    """Stable short hash of canonical-JSON(obj) — fingerprints + ids."""
    import hashlib
    blob = json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=str).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()[:n]


def model_fingerprint(meta):
    """Fingerprint of the tuned model, from whatever durable identity is
    at hand: a DecoderConfig/export-metadata dict, an ExportedModel
    manifest, or any JSON-able description of the program. Same meta →
    same fingerprint across processes, hosts and both packages."""
    if meta is None:
        meta = {}
    if hasattr(meta, "to_dict"):
        meta = meta.to_dict()
    elif hasattr(meta, "__dict__") and not isinstance(meta, dict):
        meta = {k: v for k, v in vars(meta).items()
                if not k.startswith("_")}
    return _canon_hash({"model": meta})


def _device_facts(device):
    """(platform, device_kind, n_devices, memory_known) of `device`: the
    card's from torch, or the JAX package's CPU values."""
    import torch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu", "cpu", 1, False
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        known = bool(torch.cuda.mem_get_info(index)[1])
    except Exception:
        known = False
    return ("gpu", torch.cuda.get_device_name(index),
            torch.cuda.device_count(), known)


def hardware_fingerprint(device=None):
    """Fingerprint of THIS host's accelerator reality: platform, device
    kind, device and core counts, and whether per-device memory is known —
    the axes along which a tuned winner stops being a winner. `device`
    None means the card when `torch.cuda.is_available()`, else the CPU;
    on the CPU the values are the JAX package's under JAX_PLATFORMS=cpu
    (platform "cpu", kind "cpu", 1 device, memory unknown). Returns the
    full dict; `["fp"]` is the key."""
    meta = {"cpu_count": os.cpu_count() or 1}
    (meta["platform"], meta["device_kind"], meta["n_devices"],
     meta["memory_known"]) = _device_facts(device)
    meta["fp"] = _canon_hash({"hw": {k: meta[k] for k in sorted(meta)}})
    return meta


def profile_dir():
    """Where profiles live: MXNET_TUNE_PROFILE_DIR, else a `tune-profiles`
    sibling of MXNET_COMPILE_CACHE_DIR (the JAX package's deployment root),
    else None (persistence off, activation-by-path still works)."""
    d = get_env("MXNET_TUNE_PROFILE_DIR")
    if d:
        return d
    cache = get_env("MXNET_COMPILE_CACHE_DIR")
    if cache:
        return os.path.join(os.path.dirname(os.path.abspath(cache)),
                            os.path.basename(cache) + "-tune-profiles")
    return None


def profile_path(model_fp, hw_fp, directory=None):
    """Canonical on-disk location for a (model, hardware) profile."""
    d = directory or profile_dir()
    if d is None:
        return None
    return os.path.join(d, f"profile-{model_fp}-{hw_fp}.json")


class DeploymentProfile:
    """A validated knob assignment bound to (model_fp, hw_fp)."""

    def __init__(self, knobs, model_fp, hw_fp, model_meta=None,
                 hw_meta=None, phases=None, meta=None):
        self.knobs = _space.validate_assignment(dict(knobs))
        self.model_fp = str(model_fp)
        self.hw_fp = str(hw_fp)
        self.model_meta = dict(model_meta or {})
        self.hw_meta = dict(hw_meta or {})
        self.phases = dict(phases or {})   # per-phase sweep evidence
        self.meta = dict(meta or {})       # seed, budget, timestamps...

    @property
    def profile_hash(self):
        """Short content hash of (fingerprints, knobs) — what replicas
        report in their hello so a Fleet can spot divergent tunings."""
        return _canon_hash({"model_fp": self.model_fp,
                            "hw_fp": self.hw_fp, "knobs": self.knobs})

    def to_dict(self):
        return {"schema": SCHEMA_VERSION, "model_fp": self.model_fp,
                "hw_fp": self.hw_fp, "profile_hash": self.profile_hash,
                "knobs": self.knobs, "model_meta": self.model_meta,
                "hw_meta": self.hw_meta, "phases": self.phases,
                "meta": self.meta}

    @classmethod
    def from_dict(cls, d):
        if int(d.get("schema", 0)) != SCHEMA_VERSION:
            raise MXNetError(
                f"deployment profile schema {d.get('schema')!r} != "
                f"{SCHEMA_VERSION} — refusing to guess at a knob format")
        return cls(d["knobs"], d["model_fp"], d["hw_fp"],
                   model_meta=d.get("model_meta"),
                   hw_meta=d.get("hw_meta"), phases=d.get("phases"),
                   meta=d.get("meta"))

    def save(self, directory=None):
        """Atomically persist under the profile dir; returns the path."""
        path = profile_path(self.model_fp, self.hw_fp,
                            directory=directory)
        if path is None:
            raise MXNetError(
                "no profile directory: set MXNET_TUNE_PROFILE_DIR or "
                "MXNET_COMPILE_CACHE_DIR, or pass directory=")
        blob = (json.dumps(self.to_dict(), indent=2, sort_keys=True)
                + "\n").encode("utf-8")
        with atomic_output(path) as f:
            f.write(blob)
        return path

    @classmethod
    def load(cls, path):
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def apply(self, model_fp=None, hw_fp=None, source="api"):
        """Activate this profile process-globally (see `activate`)."""
        return activate(self, model_fp=model_fp, hw_fp=hw_fp,
                        source=source)

    def __repr__(self):
        return (f"DeploymentProfile({self.profile_hash}, "
                f"model={self.model_fp}, hw={self.hw_fp}, "
                f"knobs={len(self.knobs)})")


def lookup(model_fp, hw_fp=None, directory=None):
    """Find the persisted profile for (model_fp, this-host hw_fp) under
    the profile dir. Returns None when the dir or file is absent; a
    present-but-corrupt file is a loud structured event, not a crash —
    a replica must come up (on defaults) even with a damaged profile."""
    if hw_fp is None:
        hw_fp = hardware_fingerprint()["fp"]
    path = profile_path(model_fp, hw_fp, directory=directory)
    if path is None or not os.path.exists(path):
        return None
    try:
        return DeploymentProfile.load(path)
    except Exception as e:  # noqa: BLE001 — fall back loudly, boot anyway
        _log_event("tune.profile_corrupt", path=path, error=repr(e))
        return None


def activate(profile, model_fp=None, hw_fp=None, source="api"):
    """Make `profile` the process-global active profile.

    Fingerprint gate: when the caller supplies `model_fp` (and/or
    `hw_fp`; hw defaults to this host's) each must match the profile's —
    a mismatch logs `tune.profile_mismatch`, bumps the counter, leaves
    defaults in force, and returns False. Disabled (MXNET_TUNE_DISABLE)
    likewise returns False without applying anything.
    """
    if disabled():
        _log_event("tune.profile_disabled", source=source)
        return False
    if model_fp is not None and model_fp != profile.model_fp:
        with _STATS_LOCK:
            TUNE_STATS["profile_mismatch"] += 1
        _log_event("tune.profile_mismatch", axis="model",
                   expected=model_fp, profile=profile.model_fp,
                   profile_hash=profile.profile_hash, source=source)
        return False
    if hw_fp is None:
        hw_fp = hardware_fingerprint()["fp"]
    if hw_fp != profile.hw_fp:
        with _STATS_LOCK:
            TUNE_STATS["profile_mismatch"] += 1
        _log_event("tune.profile_mismatch", axis="hardware",
                   expected=hw_fp, profile=profile.hw_fp,
                   profile_hash=profile.profile_hash, source=source)
        return False
    with _LOCK:
        _ACTIVE[0] = profile
    with _STATS_LOCK:
        TUNE_STATS["profile_applied"] += 1
    _log_event("tune.profile_applied", profile_hash=profile.profile_hash,
               model_fp=profile.model_fp, knobs=len(profile.knobs),
               source=source)
    return True


def deactivate():
    """Drop the active profile (tests; operator rollback)."""
    with _LOCK:
        _ACTIVE[0] = None


def active():
    """The active DeploymentProfile, or None. First call autoloads
    ``MXNET_TUNE_PROFILE`` (an explicit profile *path* — the env-side
    activation used by replica children) exactly once per process."""
    if disabled():
        return None
    if not _AUTOLOADED[0]:
        with _LOCK:
            if not _AUTOLOADED[0]:
                _AUTOLOADED[0] = True
                path = get_env("MXNET_TUNE_PROFILE")
                if path and _ACTIVE[0] is None:
                    try:
                        prof = DeploymentProfile.load(path)
                    except Exception as e:  # noqa: BLE001
                        _log_event("tune.profile_corrupt", path=path,
                                   error=repr(e))
                    else:
                        activate(prof, source="env")
    return _ACTIVE[0]


def resolve(name, default=None):
    """The profile tier of the knob precedence chain: the active
    profile's (catalog-validated) value for knob `name`, else `default`.
    Wire sites call this BETWEEN their explicit-arg check and their env
    read: `explicit > resolve(...) > env > built-in default`."""
    prof = active()
    if prof is None:
        return default
    if name not in prof.knobs:
        return default
    try:
        return _space.knob(name).validate(prof.knobs[name])
    except MXNetError:
        # catalog drifted since the profile was written: default, loudly
        _log_event("tune.profile_stale_knob", knob=name,
                   value=repr(prof.knobs[name]),
                   profile_hash=prof.profile_hash)
        return default
