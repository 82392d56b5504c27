"""mx.tune.search of the PyTorch port — the deterministic sweep engine.

Counterpart of `incubator_mxnet_tpu/tune/search.py`, with the same
schedule, trial records, fault point, span and counters. Coordinate
descent over the declared knob space, per measurement phase: start from
the **hand-tuned assignment** (`HAND_TUNED`; trial 0 measures exactly
that baseline), then walk each knob of the phase in sorted-name order,
trying every declared choice and adopting strict improvements, until the
trial budget runs out or a full round changes nothing. The schedule is a
pure function of (catalog, start, budget), so two sweeps over the same
space visit the same trials in the same order, in both packages.

Every trial is one scrubbed-env subprocess (`python -m
incubator_mxnet_tpu_torch.tune.measure --device ...`, in a session of its
own, killed with its process group on timeout): a crashing, hanging or
out-of-memory configuration becomes a *failed trial* with a recorded
reason and the sweep keeps walking. The `tune.trial` fault point makes
that containment drillable, and each trial lands in telemetry
(`tune.trials`, `tune.trials_failed`, cumulative `tune.trial_ms`, and a
`tune.trial` span).

The sweep's product is `build_profile(result, ...)`: a
`DeploymentProfile` carrying the merged per-phase winners plus the
per-phase evidence (baseline score, best score, speedup).
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

from ..base import MXNetError, get_env
from ..fault import _log_event, inject as _fault_inject
from ..telemetry import record_span
from . import space as _space
from .profile import (TUNE_STATS, _STATS_LOCK, DeploymentProfile,
                      hardware_fingerprint, model_fingerprint)

__all__ = ["HAND_TUNED", "sweep", "build_profile", "plan"]

# The JAX package's hand-tuned assignments, the same literal: the winners
# its earlier work found by hand on its own hardware (its committed bench
# artifacts), not readings from the card. Trial 0 of every phase measures
# THIS assignment, so "profile >= hand-tuned" is checked inside one sweep
# on one host.
HAND_TUNED = {
    # the JAX package's saturation arm: slots 32, decode_steps 4, no
    # speculation, float KV, derived prefill lanes
    "serve_decode": {"serve.decode_steps": 4, "serve.draft_tokens": 0,
                     "serve.max_slots": 32, "serve.prefill_lanes": None,
                     "serve.kv_dtype": None},
    # no remat, donated buffers (a no-op in the port), NHWC
    "train_fused": {"train.remat": None, "train.donate": True,
                    "train.conv_layout": "NHWC"},
    # in-process thread pool, lookahead 2, 256 MB ring
    "io_pipeline": {"io.workers": 0, "io.lookahead": 2, "io.shm_mb": 256},
    # the full pow2 bucket ladder
    "serve_batch": {"serve.batch_buckets": [1, 2, 4, 8, 16, 32]},
    # engine default bulked-segment size
    "dispatch": {"dispatch.bulk_size": 4096},
}

_TRIAL_TIMEOUT_S = {"quick": 240.0, "full": 600.0}


def plan(phase, start=None, budget=None):
    """The deterministic trial schedule for one phase: the ordered list
    of assignments coordinate descent WOULD visit if nothing improved
    (improvements only re-anchor later proposals; the visit order of
    (knob, choice) pairs is fixed). Drives `--dry-run`."""
    base = dict(_space.default_assignment(phase))
    base.update(HAND_TUNED.get(phase, {}))
    if start:
        base.update({k: v for k, v in start.items() if k in base})
    base = _space.validate_assignment(base)
    out = [dict(base)]
    for k in _space.knobs_for_phase(phase):
        for c in k.choices:
            if c == base[k.name] and type(c) is type(base[k.name]):
                continue
            cand = dict(base)
            cand[k.name] = c
            out.append(cand)
            if budget is not None and len(out) >= budget:
                return out
    return out


_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _spawn_trial(phase, assignment, scale, timeout_s, device="cuda"):
    """One measurement subprocess on `device`: scrubbed env, the
    package's root on PYTHONPATH, own process group, killpg on timeout (a
    hung config must not hang the sweep)."""
    argv = [sys.executable, "-m", "incubator_mxnet_tpu_torch.tune.measure",
            "--phase", phase, "--knobs", json.dumps(assignment),
            "--scale", scale, "--device", str(device)]
    env = _space.scrubbed_env()
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = _ROOT + (os.pathsep + path if path else "")
    p = subprocess.Popen(argv, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, env=env,
                         start_new_session=True, text=True)
    try:
        out, err = p.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        p.communicate()
        return {"ok": False, "error": f"timeout after {timeout_s:.0f}s"}
    for line in reversed(out.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    tail = (err or out or "").strip().splitlines()[-3:]
    return {"ok": False,
            "error": f"rc={p.returncode}, no result line; "
                     f"tail={' | '.join(tail)!r}"}


def _run_trial(phase, assignment, scale, timeout_s, runner,
               device="cuda"):
    """One trial end-to-end: fault point, subprocess (or injected
    runner), telemetry. Returns the trial record — ok OR failed, but
    always a record; exceptions never escape to the sweep loop."""
    t0 = time.perf_counter()
    try:
        _fault_inject("tune.trial")
        if runner is not None:
            res = runner(phase, dict(assignment), scale)
            if not isinstance(res, dict):
                res = {"ok": True, "score": float(res)}
        else:
            res = _spawn_trial(phase, assignment, scale, timeout_s,
                               device)
    except BaseException as e:  # noqa: BLE001 — containment is the point
        res = {"ok": False, "error": f"{type(e).__name__}: {e}"}
    dt_ms = (time.perf_counter() - t0) * 1e3
    ok = bool(res.get("ok")) and res.get("score") is not None
    rec = {"phase": phase, "knobs": dict(assignment), "ok": ok,
           "score": (round(float(res["score"]), 2) if ok else None),
           "unit": res.get("unit"), "elapsed_ms": round(dt_ms, 1),
           "error": None if ok else res.get("error", "no score")}
    # what else the measurement reported (a child's kernel launches, its
    # device, its token count): kept beside the JAX package's record keys
    detail = {k: v for k, v in res.items()
              if k not in ("phase", "ok", "score", "unit", "error")}
    if detail:
        rec["detail"] = detail
    with _STATS_LOCK:
        TUNE_STATS["trials"] += 1
        TUNE_STATS["trial_ms"] += dt_ms
        if not ok:
            TUNE_STATS["trials_failed"] += 1
    record_span("tune.trial", dt_ms * 1e3, cat="tune", phase=phase,
                ok=ok)
    if not ok:
        _log_event("tune.trial_failed", phase=phase,
                   error=rec["error"], knobs=json.dumps(assignment))
    return rec


def sweep(phases=None, budget=None, seed=0, scale="quick", start=None,
          runner=None, timeout_s=None, max_rounds=3, device="cuda"):
    """Coordinate-descent sweep over `phases` (default: every phase the
    catalog declares and HAND_TUNED seeds).

    `budget` caps TOTAL trials across all phases (default:
    ``MXNET_TUNE_BUDGET`` or 24). `runner` injects an in-process
    measurement callable `(phase, assignment, scale) -> score|dict` (an
    in-process runner); otherwise every trial is a scrubbed-env
    subprocess on `device` (default the card). `seed` is
    recorded and reserved for future stochastic searchers — coordinate
    descent itself is already order-deterministic.
    """
    if phases is None:
        phases = [p for p in _space.phases() if p in HAND_TUNED]
    if budget is None:
        budget = int(get_env("MXNET_TUNE_BUDGET", 24, typ=int))
    if timeout_s is None:
        timeout_s = _TRIAL_TIMEOUT_S.get(scale, 600.0)
    budget = max(len(phases), int(budget))
    per_phase = max(1, budget // max(1, len(phases)))
    result = {"phases": {}, "knobs": {}, "trials": 0, "trials_failed": 0,
              "budget": budget, "seed": int(seed), "scale": scale}
    for phase in phases:
        base = dict(_space.default_assignment(phase))
        base.update(HAND_TUNED.get(phase, {}))
        if start:
            base.update({k: v for k, v in start.items() if k in base})
        base = _space.validate_assignment(base)
        trials = []
        remaining = min(per_phase, budget - result["trials"])

        def _measure(asn):
            rec = _run_trial(phase, asn, scale, timeout_s, runner,
                             device)
            trials.append(rec)
            result["trials"] += 1
            if not rec["ok"]:
                result["trials_failed"] += 1
            return rec

        baseline = _measure(base) if remaining > 0 else None
        best_asn, best = dict(base), baseline
        rounds = 0
        improved = True
        while (improved and rounds < max_rounds
               and len(trials) < remaining):
            improved = False
            rounds += 1
            for k in _space.knobs_for_phase(phase):
                for c in k.choices:
                    if len(trials) >= remaining:
                        break
                    cur = best_asn[k.name]
                    if c == cur and type(c) is type(cur):
                        continue
                    cand = dict(best_asn)
                    cand[k.name] = c
                    rec = _measure(cand)
                    if rec["ok"] and (best is None
                                      or not best.get("ok")
                                      or rec["score"] > best["score"]):
                        best, best_asn = rec, cand
                        improved = True
                else:
                    continue
                break
        speedup = None
        if (baseline and baseline["ok"] and best and best["ok"]
                and baseline["score"] > 0):
            speedup = round(best["score"] / baseline["score"], 4)
        result["phases"][phase] = {
            "baseline": baseline, "best": best, "best_knobs": best_asn,
            "trials": trials, "speedup_vs_hand": speedup}
        if best and best.get("ok"):
            result["knobs"].update(best_asn)
        _log_event("tune.sweep_phase", phase=phase,
                   trials=len(trials),
                   failed=sum(1 for t in trials if not t["ok"]),
                   speedup=speedup)
    return result


def build_profile(result, model_meta=None, hw_meta=None):
    """Wrap a sweep result as a persisted-ready DeploymentProfile."""
    if not result.get("knobs"):
        raise MXNetError("sweep produced no successful trials — refusing "
                         "to build an empty profile")
    hw = hw_meta or hardware_fingerprint()
    phases = {
        p: {"baseline_score": (d["baseline"] or {}).get("score"),
            "best_score": (d["best"] or {}).get("score"),
            "unit": (d["best"] or {}).get("unit"),
            "speedup_vs_hand": d.get("speedup_vs_hand"),
            "trials": len(d["trials"]),
            "trials_failed": sum(1 for t in d["trials"] if not t["ok"])}
        for p, d in result["phases"].items()}
    meta = {"seed": result.get("seed"), "budget": result.get("budget"),
            "scale": result.get("scale"), "trials": result.get("trials"),
            "trials_failed": result.get("trials_failed")}
    return DeploymentProfile(
        result["knobs"], model_fingerprint(model_meta or {}), hw["fp"],
        model_meta=(model_meta if isinstance(model_meta, dict)
                    else {"repr": repr(model_meta)}),
        hw_meta={k: v for k, v in hw.items() if k != "fp"},
        phases=phases, meta=meta)
