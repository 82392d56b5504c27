"""mx.tune of the PyTorch port — the deployment-profile autotuner.

Counterpart of `incubator_mxnet_tpu/tune/`, with its surface:

  * `tune.space`   — the typed, registered knob catalog (the swept
    space; the JAX package's literal);
  * `tune.search`  — deterministic coordinate-descent sweeps through
    crash-isolated measurement subprocesses on the card (`device=`);
  * `tune.profile` — `DeploymentProfile`: winners keyed by (model
    fingerprint, hardware fingerprint), persisted under the profile
    directory and activated at startup, so a fresh replica boots tuned.

Operator entry point: `tools/torch_mxtune.py`.
"""
from .space import (KNOBS, NON_TUNABLE_ENV, Knob, catalog, knob,
                    knobs_for_phase, phases, knob_env_vars,
                    default_assignment, validate_assignment,
                    scrubbed_env)
from .profile import (DeploymentProfile, model_fingerprint,
                      hardware_fingerprint, profile_dir, profile_path,
                      activate, deactivate, active, resolve, lookup,
                      disabled, TUNE_STATS, tune_stats)
from .search import HAND_TUNED, sweep, build_profile, plan

__all__ = [
    "KNOBS", "NON_TUNABLE_ENV", "Knob", "catalog", "knob",
    "knobs_for_phase", "phases", "knob_env_vars", "default_assignment",
    "validate_assignment", "scrubbed_env",
    "DeploymentProfile", "model_fingerprint", "hardware_fingerprint",
    "profile_dir", "profile_path", "activate", "deactivate", "active",
    "resolve", "lookup", "disabled", "TUNE_STATS", "tune_stats",
    "HAND_TUNED", "sweep", "build_profile", "plan",
]
