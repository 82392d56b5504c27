"""mx.tune.space of the PyTorch port — the registered knob catalog the
autotuner sweeps.

Counterpart of `incubator_mxnet_tpu/tune/space.py`: the same `KNOBS`
literal (names, kinds, defaults, choice lists, `env`, `phase`, `wire`),
the same `NON_TUNABLE_ENV` set and the same helpers, so a profile written
by either package validates in the other. Every measured,
workload-dependent knob is declared here once: its type, default, the
bounded choice set a sweep may visit, the `MXNET_*` env var that already
controls it (when one exists), the measurement phase (`tune.measure`)
and the module the resolved value is wired into.

The `help` strings describe what a knob does. They carry no measured
number: the JAX package's readings were taken on its own hardware, and
the port's are the sweep's (`tools/torch_mxtune.py`).

`train.donate` stays in the catalog although the port updates weights
and optimizer state in place and has nothing to donate: `FusedTrainStep`
records the resolved value and changes nothing, and a profile written by
the JAX package keeps validating here.

Kinds: `categorical` (enumerated values), `int` (small integer set),
`pow2` (power-of-two ladder), `bool`. All four carry an explicit literal
`choices` list, so the swept space is auditable by reading this file.

`scrubbed_env()` is the shared scrub-and-set helper of the trial runner:
a child measurement process starts from a baseline with NO ambient knob
exports, so a knob set by one trial (or by the operator's shell) never
leaks into the next trial's baseline.
"""
from __future__ import annotations

import os

from ..base import MXNetError

__all__ = ["KNOBS", "NON_TUNABLE_ENV", "Knob", "catalog", "knob",
           "knobs_for_phase", "phases", "knob_env_vars",
           "default_assignment", "validate_assignment", "scrubbed_env"]

# ---------------------------------------------------------------------------
# The catalog. A LITERAL dict on purpose, as in the JAX package: it can be
# parsed with `ast` (like fault.POINTS) and held against the
# docs/TUNING.md knob table; computed entries would be invisible there.
# ---------------------------------------------------------------------------
KNOBS = {
    "serve.decode_steps": {
        "kind": "int", "default": 4, "choices": [1, 2, 4, 6, 8],
        "env": "MXNET_SERVE_DECODE_STEPS", "phase": "serve_decode",
        "wire": "serve/continuous.py",
        "help": "micro-steps per decode wave (amortizes the host "
                "round trip of a wave over up to K tokens a lane)"},
    "serve.prefill_lanes": {
        "kind": "pow2", "default": None, "choices": [None, 1, 2, 4, 8, 16],
        "env": "MXNET_SERVE_PREFILL_LANES", "phase": "serve_decode",
        "wire": "serve/continuous.py",
        "help": "fixed lane count of the prefill program (None = derived "
                "min(max_slots, 8)); sized to the admission rate"},
    "serve.max_slots": {
        "kind": "pow2", "default": 8, "choices": [4, 8, 16, 32],
        "env": "MXNET_SERVE_MAX_SLOTS", "phase": "serve_decode",
        "wire": "serve/kv_pool.py",
        "help": "KV-cache slots = max concurrently-decoding requests "
                "(the slab is carved once at startup)"},
    "serve.draft_tokens": {
        "kind": "int", "default": 0, "choices": [0, 2, 4, 6],
        "env": "MXNET_SERVE_DRAFT_TOKENS", "phase": "serve_decode",
        "wire": "serve/continuous.py",
        "help": "speculative decode depth k (0 = off); which depth "
                "wins depends on the deployment's load, which is why it "
                "is swept per deployment"},
    "serve.kv_dtype": {
        "kind": "categorical", "default": None, "choices": [None, "int8"],
        "env": "MXNET_SERVE_KV_DTYPE", "phase": "serve_decode",
        "wire": "serve/continuous.py",
        "help": "KV pool storage dtype (None = model dtype; int8 = "
                "quantized codes + per-position scales, more slots per "
                "GB: KVCachePool.slots_per_gb())"},
    "serve.prefix_block": {
        "kind": "pow2", "default": 16, "choices": [4, 8, 16, 32],
        "env": "MXNET_SERVE_PREFIX_BLOCK", "phase": "serve_prefill",
        "wire": "serve/continuous.py",
        "help": "shared-prefix cache granularity in tokens (prefixes "
                "cache and match on whole blocks; smaller = finer reuse "
                "but more hash/verify work per lookup)"},
    "serve.prefix_cache_slots": {
        "kind": "int", "default": 0, "choices": [0, 2, 4, 8],
        "env": "MXNET_SERVE_PREFIX_CACHE_SLOTS", "phase": "serve_prefill",
        "wire": "serve/continuous.py",
        "help": "dedicated KV-pool rows holding shared-prefix KV (0 = "
                "off); each costs one slot page of device memory and "
                "turns a repeated prefix's prefill into a row copy"},
    "serve.prefix_cache_insert": {
        "kind": "bool", "default": True, "choices": [True, False],
        "env": "MXNET_SERVE_PREFIX_CACHE_INSERT", "phase": "serve_prefill",
        "wire": "serve/continuous.py",
        "help": "publish retiring prompts' prefixes back into the cache "
                "(False = read-only cache, for pinned system prompts "
                "warmed once)"},
    "serve.batch_buckets": {
        "kind": "categorical", "default": [1, 2, 4, 8, 16, 32],
        "choices": [[1, 2, 4, 8, 16, 32], [8, 16, 32], [1, 4, 16, 64],
                    [2, 8, 32]],
        "env": None, "phase": "serve_batch", "wire": "serve/batcher.py",
        "help": "static-batcher shape buckets (each bucket is one "
                "program shape; fewer buckets = less padding variety "
                "but more pad waste)"},
    "dispatch.bulk_size": {
        "kind": "pow2", "default": 4096,
        "choices": [512, 1024, 2048, 4096, 8192],
        "env": "MXNET_ENGINE_BULK_SIZE", "phase": "dispatch",
        "wire": "engine.py",
        "help": "max eager ops deferred per bulked segment before a "
                "forced flush (recorded by the port's engine; nothing "
                "bulks there)"},
    "train.remat": {
        "kind": "categorical", "default": None,
        "choices": [None, "full", "dots"],
        "env": None, "phase": "train_fused",
        "wire": "gluon/contrib/fused.py",
        "help": "rematerialization policy of the fused train step "
                "(recomputed operations vs saved activations; which "
                "wins depends on the hardware)"},
    "train.donate": {
        "kind": "bool", "default": True, "choices": [True, False],
        "env": None, "phase": "train_fused",
        "wire": "gluon/contrib/fused.py",
        "help": "donate weight/optimizer buffers to the step (the "
                "JAX package's knob; the port updates them in place, so "
                "FusedTrainStep records the value and changes nothing)"},
    "train.conv_layout": {
        "kind": "categorical", "default": "NHWC",
        "choices": ["NHWC", "NCHW"],
        "env": None, "phase": "train_fused", "wire": None,
        "help": "conv data layout the model is BUILT with (consumed at "
                "model construction, not wired into a constructor — "
                "read it from the profile when building the net)"},
    "io.workers": {
        "kind": "int", "default": 0, "choices": [0, 2, 4, 8],
        "env": "MXNET_IO_WORKERS", "phase": "io_pipeline",
        "wire": "io/__init__.py",
        "help": "ImageRecordIter decode workers (0 = in-process thread "
                "pool, N = persistent shm worker processes)"},
    "io.lookahead": {
        "kind": "int", "default": 2, "choices": [1, 2, 4],
        "env": "MXNET_IMAGEREC_LOOKAHEAD", "phase": "io_pipeline",
        "wire": "io/__init__.py",
        "help": "batches decoded ahead of the consumer into the "
                "preallocated ring"},
    "io.shm_mb": {
        "kind": "pow2", "default": 256, "choices": [64, 128, 256, 512],
        "env": "MXNET_IO_SHM_MB", "phase": "io_pipeline",
        "wire": "io/imagerec_pool.py",
        "help": "shared-memory budget for the decode ring in "
                "process-worker mode"},
}

# Ambient MXNET_* vars that wired modules legitimately read WITHOUT being
# tunable knobs (infra/config/debug surface, not perf sweep targets): the
# JAX package's set. Anything else read in a wired module must be declared
# above (tests/test_torch_tune.py holds the port's wired modules to it).
NON_TUNABLE_ENV = {
    "MXNET_COMPILE_CACHE_DIR", "MXNET_FUSION_INTERPRET",
    "MXNET_SERVE_DEADLINE_MS", "MXNET_SERVE_MAX_QUEUE",
    "MXNET_SERVE_PREFILL_BUDGET", "MXNET_SERVE_BATCH_TIMEOUT_MS",
    "MXNET_SERVE_OVERLOAD_POLICY", "MXNET_FAULT_SPEC",
    "MXNET_FLIGHTREC_DIR", "MXNET_METRICS_PORT", "MXNET_TELEMETRY",
    "MXNET_TRACE_SAMPLE", "MXNET_IO_DEVICE_AUGMENT",
    "MXNET_PREFETCH_RESTARTS", "MXNET_USE_FUSION", "MXNET_ENGINE_TYPE",
    "MXNET_TUNE_PROFILE", "MXNET_TUNE_PROFILE_DIR", "MXNET_TUNE_DISABLE",
    "MXNET_TUNE_BUDGET",
}

_KINDS = ("categorical", "int", "pow2", "bool")


class Knob:
    """One typed catalog entry (built from the KNOBS literal)."""

    __slots__ = ("name", "kind", "default", "choices", "env", "phase",
                 "wire", "help")

    def __init__(self, name, spec):
        self.name = name
        self.kind = spec["kind"]
        self.default = spec["default"]
        self.choices = list(spec["choices"])
        self.env = spec.get("env")
        self.phase = spec["phase"]
        self.wire = spec.get("wire")
        self.help = spec.get("help", "")
        if self.kind not in _KINDS:
            raise MXNetError(f"knob {name}: unknown kind {self.kind!r}")
        if not self.choices:
            raise MXNetError(f"knob {name}: empty choice set")
        if not any(self.default == c for c in self.choices):
            raise MXNetError(
                f"knob {name}: default {self.default!r} not in choices")
        if self.kind == "bool" and set(self.choices) != {True, False}:
            raise MXNetError(f"knob {name}: bool knobs enumerate exactly "
                             f"True/False")
        if self.kind == "pow2":
            for c in self.choices:
                if c is None:
                    continue          # a "derived" sentinel rides along
                if not (isinstance(c, int) and c > 0
                        and (c & (c - 1)) == 0):
                    raise MXNetError(
                        f"knob {name}: pow2 choice {c!r} is not a power "
                        f"of two")
        if self.kind == "int":
            for c in self.choices:
                if not isinstance(c, int):
                    raise MXNetError(
                        f"knob {name}: int choice {c!r} is not an int")

    def validate(self, value):
        """Return `value` if it is a legal choice; typed error otherwise.
        (Equality scan, not set membership: choices may be lists.)"""
        for c in self.choices:
            if value == c and type(value) is type(c):
                return value
        # int/bool cross-typing (json round-trips True as true) is the
        # one equivalence worth tolerating across the wire
        for c in self.choices:
            if value == c:
                return c
        raise MXNetError(
            f"knob {self.name}: value {value!r} not in the declared "
            f"choice set {self.choices!r}")

    def to_row(self):
        """Plain-data view (CLI/markdown rendering)."""
        return {"name": self.name, "kind": self.kind,
                "default": self.default, "choices": self.choices,
                "env": self.env, "phase": self.phase, "wire": self.wire,
                "help": self.help}


_CATALOG = {name: Knob(name, spec) for name, spec in KNOBS.items()}


def catalog():
    """{name: Knob} — the validated, typed view of the KNOBS literal."""
    return dict(_CATALOG)


def knob(name):
    """Catalog lookup; typed error on an unknown knob."""
    try:
        return _CATALOG[name]
    except KeyError:
        raise MXNetError(f"unknown tune knob {name!r} (catalog: "
                         f"{sorted(_CATALOG)})") from None


def knobs_for_phase(phase):
    """Knobs measured by `phase`, in deterministic (sorted-name) order."""
    return [k for _, k in sorted(_CATALOG.items()) if k.phase == phase]


def phases():
    """Sorted set of bench phases the catalog references."""
    return sorted({k.phase for k in _CATALOG.values()})


def knob_env_vars():
    """Sorted env vars owned by declared knobs (the scrub set)."""
    return sorted({k.env for k in _CATALOG.values() if k.env})


def default_assignment(phase=None):
    """{knob: default} for the whole catalog (or one phase)."""
    ks = _CATALOG.values() if phase is None else knobs_for_phase(phase)
    return {k.name: k.default for k in sorted(ks, key=lambda k: k.name)}


def validate_assignment(assignment):
    """Validate {knob: value} against the catalog; returns a normalized
    copy. Unknown knobs and out-of-space values are typed errors — a
    corrupt or hand-edited profile must fail loudly, not half-apply."""
    out = {}
    for name in sorted(assignment):
        out[name] = knob(name).validate(assignment[name])
    return out


def scrubbed_env(overrides=None, base=None):
    """The shared scrub-and-set helper for measurement subprocesses.

    Returns a copy of `base` (default: ``os.environ``) with EVERY declared
    knob env var removed — plus ``MXNET_TUNE_PROFILE``, so a parent's
    active profile never leaks into a child's baseline — and `overrides`
    applied on top (value ``None`` deletes). Non-knob infra vars
    (``CUDA_VISIBLE_DEVICES``, ``MXNET_FAULT_SPEC``,
    ``MXNET_COMPILE_CACHE_DIR``, ...) pass through untouched: the scrub
    removes exactly the tunable surface, nothing else. Used by the tune
    trial runner (`tune.search`).
    """
    env = dict(os.environ if base is None else base)
    for var in knob_env_vars():
        env.pop(var, None)
    env.pop("MXNET_TUNE_PROFILE", None)
    if overrides:
        for k, v in overrides.items():
            if v is None:
                env.pop(k, None)
            else:
                env[k] = str(v)
    return env
