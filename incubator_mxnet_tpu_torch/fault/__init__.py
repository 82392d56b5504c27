"""mx.fault of the PyTorch port — fault injection, crash-consistent I/O,
retry/watchdog, and the auto-resume training driver.

Counterpart of `incubator_mxnet_tpu/fault/__init__.py`, with its public
names, its spec syntax and its injection-point names:

  fault.inject(point[, value])      named injection points wired through
                                    checkpoint/io/gluon.data/serve/fleet;
                                    armed from MXNET_FAULT_SPEC or
                                    fault.install()
  fault.retrying(...)               bounded-retry decorator with exponential
                                    backoff and structured logs
  fault.watchdog(seconds)           abort a stalled region with
                                    WatchdogTimeout (SIGALRM-preemptive on
                                    the main thread)
  fault.atomic_output(path)         write-to-temp + fsync + os.replace commit
                                    (the primitive behind crash-consistent
                                    checkpoints)
  fault.run_resilient(step_fn, ...) training driver: checkpoint every K
                                    steps, skip non-finite-loss steps, and on
                                    restart resume from the newest COMMITTED
                                    checkpoint

Fault-spec syntax (comma-separated rules):

    MXNET_FAULT_SPEC="<point>:<hit>:<kind>[:<arg>][,...]"

`point` is an injection-point name (see POINTS), `hit` selects which
occurrence fires — `3` (exactly the 3rd), `3+` (the 3rd and every one
after), `*` (every hit) — and `kind` is one of ioerror / oserror / error /
timeout / nan / stall / kill.  `stall` sleeps `arg` seconds (default 30)
instead of raising; `nan` returns a NaN in place of the value passed to
inject(); `kill` SIGKILLs the process (crash simulation for
tools/torch_crashtest.py).  Hit counting is per-point and deterministic, so
`checkpoint.save_sharded:2:ioerror` always fails the second save and only
the second save.

On the card: a Python signal handler runs between bytecodes, so the
watchdog preempts a host that sleeps or spins in Python, not one blocked
inside a CUDA synchronize (it fires when the call returns). Kernels queued
before a step raised may still run; they write the step's NEW tensors, so
a step function that never writes its inputs (as
`models.transformer.make_train_step`) leaves the kept state intact.

Not carried over until their queues land (ROADMAP): the `elastic`
submodule and the mesh-rescaling resume (`mesh=` / `specs=`, A10), which
raise.
"""
from __future__ import annotations

import base64
import functools
import json
import logging
import os
import signal
import tempfile
import threading
import time
from contextlib import contextmanager

import numpy as _np
import torch

from ..base import MXNetError, get_env

__all__ = [
    "FaultRule", "InjectedFault", "WatchdogTimeout", "POINTS",
    "parse_spec", "install", "clear", "hits", "reset_hits", "scope",
    "inject", "active_rules",
    "retrying", "watchdog", "atomic_output", "fsync_dir",
    "loss_is_finite", "run_resilient", "ResilientRun",
    "rng_state_encode", "rng_state_restore",
]

logger = logging.getLogger("incubator_mxnet_tpu_torch.fault")

# Injection points (call sites register themselves implicitly by calling
# inject(); this table documents the stable names, the JAX package's).
# Wired in the port: checkpoint.*, io.*, dataloader.fetch, serve.enqueue,
# serve.execute, serve.reply, fleet.*, resilient.*. `engine.flush` never
# fires: the port's engine runs every op eagerly, with no bulked segment
# to flush. The others wait for their modules: kvstore.* and elastic.*
# (A10), estimator.checkpoint (A4), tune.trial (A11).
POINTS = {
    "checkpoint.save": "save_checkpoint, after temp write / before commit",
    "checkpoint.save_sharded": "save_sharded, after shard write / before "
                               "the rename+manifest commit",
    "checkpoint.load": "load_checkpoint / load_sharded entry",
    "io.prefetch": "PrefetchingIter worker, per fetched batch",
    "io.device_feed": "DeviceFeed feeder thread, before each source fetch",
    "io.imagerec": "ImageRecordIter producer, before each batch decode "
                   "submit (worker death mid-batch)",
    "dataloader.fetch": "gluon DataLoader batch assembly, per batch",
    "kvstore.push": "KVStore.push entry",
    "kvstore.pull": "KVStore.pull entry",
    "kvstore.collective": "cross-process collective sum (dist mode)",
    "engine.flush": "bulked-segment flush, before the XLA replay runs",
    "estimator.checkpoint": "gluon estimator CheckpointHandler save",
    "serve.enqueue": "serve.Server.submit, before admission control",
    "serve.execute": "serve batcher, before the bucketed program runs",
    "serve.reply": "serve batcher, after execution / before futures resolve",
    "resilient.step": "run_resilient, inside the watchdog around step_fn",
    "resilient.loss": "run_resilient, applied to the returned loss "
                      "(nan kind poisons it)",
    "kvstore.reduce_scatter": "bucketed dp-axis reduce-scatter, before "
                              "each bucket dispatch (the ZeRO gradient "
                              "path)",
    "kvstore.allgather": "bucketed dp-axis all-gather, before each bucket "
                         "dispatch (the ZeRO parameter reassembly)",
    "elastic.resume": "ElasticTrainer.resume entry, before the checkpoint "
                      "restore / shard repartition",
    "elastic.step": "run_elastic, before each trainer step",
    "elastic.loss": "run_elastic, applied to the step loss (nan kind "
                    "poisons it)",
    "fleet.dispatch": "serve.Fleet router, before a request is sent to "
                      "the chosen replica (failure consumes one retry "
                      "from the failover budget)",
    "fleet.heartbeat": "serve.Fleet monitor, per replica health check "
                       "(failure counts as a missed heartbeat)",
    "fleet.respawn": "serve.Fleet supervisor, before a dead replica is "
                     "respawned (failure bills a consecutive restart)",
    "fleet.swap": "serve.Fleet.swap, before each replica's "
                  "drain-and-swap (failure aborts the rolling upgrade)",
    "tune.trial": "tune sweep, before each trial's measurement "
                  "subprocess is launched (failure is a recorded failed "
                  "TRIAL; the sweep itself completes)",
}

_KINDS = ("ioerror", "oserror", "error", "timeout", "nan", "stall", "kill")


class InjectedFault(MXNetError):
    """Raised for kind=error injections (distinguishable from real faults)."""


class WatchdogTimeout(MXNetError):
    """A watchdog-guarded region exceeded its deadline."""


class FaultRule:
    """One armed injection: fire `kind` at the `at`-th hit of `point`
    (every hit from `at` on when persistent)."""

    __slots__ = ("point", "at", "persistent", "kind", "arg")

    def __init__(self, point, kind, at=1, persistent=False, arg=None):
        if kind not in _KINDS:
            raise MXNetError(f"unknown fault kind {kind!r}; one of {_KINDS}")
        if at < 1:
            raise MXNetError("fault hit index is 1-based")
        self.point = point
        self.kind = kind
        self.at = int(at)
        self.persistent = bool(persistent)
        self.arg = arg

    def __repr__(self):
        n = f"{self.at}{'+' if self.persistent else ''}"
        a = f":{self.arg}" if self.arg is not None else ""
        return f"FaultRule({self.point}:{n}:{self.kind}{a})"


def parse_spec(spec):
    """Parse a MXNET_FAULT_SPEC string into FaultRules."""
    rules = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) < 3:
            raise MXNetError(
                f"bad fault spec entry {entry!r}: want point:hit:kind[:arg]")
        point, hit, kind = parts[0], parts[1], parts[2]
        arg = ":".join(parts[3:]) if len(parts) > 3 else None
        if hit == "*":
            at, persistent = 1, True
        elif hit.endswith("+"):
            at, persistent = int(hit[:-1]), True
        else:
            at, persistent = int(hit), False
        rules.append(FaultRule(point, kind, at=at, persistent=persistent,
                               arg=arg))
    return rules


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_lock = threading.Lock()
_rules = []
_hit_counts = {}
_env_loaded = False


def _ensure_env():
    global _env_loaded
    if _env_loaded:
        return
    with _lock:
        if _env_loaded:
            return
        spec = get_env("MXNET_FAULT_SPEC")
        if spec:
            _rules.extend(parse_spec(spec))
        _env_loaded = True


def install(point, kind, at=1, persistent=False, arg=None):
    """Programmatically arm one injection rule; returns it."""
    _ensure_env()
    rule = FaultRule(point, kind, at=at, persistent=persistent, arg=arg)
    with _lock:
        _rules.append(rule)
    return rule


def clear():
    """Disarm every rule and reset hit counters (env spec is NOT re-read)."""
    global _env_loaded
    with _lock:
        _rules.clear()
        _hit_counts.clear()
        _env_loaded = True


def reset_hits():
    with _lock:
        _hit_counts.clear()


def hits(point):
    """How many times `point` has been hit since the last clear/reset."""
    with _lock:
        return _hit_counts.get(point, 0)


def active_rules():
    _ensure_env()
    with _lock:
        return list(_rules)


@contextmanager
def scope(spec):
    """Arm a spec string (or iterable of FaultRules) for the duration of the
    block, restoring the previous rule set and counters on exit."""
    _ensure_env()
    new = parse_spec(spec) if isinstance(spec, str) else list(spec)
    with _lock:
        saved_rules, saved_hits = list(_rules), dict(_hit_counts)
        _rules.clear()
        _rules.extend(new)
        _hit_counts.clear()
    try:
        yield
    finally:
        with _lock:
            _rules.clear()
            _rules.extend(saved_rules)
            _hit_counts.clear()
            _hit_counts.update(saved_hits)


def _log_event(event, **fields):
    """One structured log line (`<event> <json fields>`) on the
    `incubator_mxnet_tpu_torch.fault` logger, under the JAX package's event
    names. Every line also feeds the flight recorder (and its spool when
    MXNET_FLIGHTREC_DIR is set), so fault injections, restarts and
    nonfinite skips land in the post-mortem ring."""
    try:
        logger.info("%s %s", event, json.dumps(fields, default=str))
    except Exception:
        logger.info("%s %r", event, fields)
    try:
        from ..telemetry.trace import flightrec_record
        flightrec_record("fault", event, **fields)
    except Exception:
        pass


def _poison_nan(value):
    if value is None:
        return float("nan")
    t = getattr(value, "_t", value)      # an NDArray's tensor
    if isinstance(t, torch.Tensor):
        if t.dim() == 0 or not t.is_floating_point():
            return float("nan")
        out = torch.full_like(t, float("nan"))
        if t is value:
            return out
        from ..ndarray import _wrap
        return _wrap(out)
    try:
        arr = _np.asarray(value)
        if arr.shape == ():
            return float("nan")
        return _np.full(arr.shape, _np.nan, dtype=_np.float64)
    except Exception:
        return float("nan")


def _trigger(rule, point, n, value):
    _log_event("fault.injected", point=point, hit=n, kind=rule.kind,
               arg=rule.arg)
    msg = f"injected {rule.kind} at {point!r} (hit {n})"
    if rule.kind == "ioerror":
        raise IOError(msg)
    if rule.kind == "oserror":
        raise OSError(msg)
    if rule.kind == "error":
        raise InjectedFault(msg)
    if rule.kind == "timeout":
        raise TimeoutError(msg)
    if rule.kind == "stall":
        time.sleep(float(rule.arg) if rule.arg is not None else 30.0)
        return value
    if rule.kind == "nan":
        return _poison_nan(value)
    if rule.kind == "kill":
        # crash simulation: no atexit, no cleanup — exactly like OOM-killer
        logging.shutdown()
        os.kill(os.getpid(), signal.SIGKILL)
    return value


def inject(point, value=None):
    """Hit the named injection point. Free when no rules are armed;
    otherwise counts the hit and triggers any matching rule (raising, or
    transforming and returning `value`)."""
    if _env_loaded and not _rules:
        return value
    _ensure_env()
    if not _rules:
        return value
    with _lock:
        n = _hit_counts.get(point, 0) + 1
        _hit_counts[point] = n
        fire = [r for r in _rules
                if r.point == point
                and (n == r.at or (r.persistent and n >= r.at))]
    for rule in fire:
        value = _trigger(rule, point, n, value)
    return value


# ---------------------------------------------------------------------------
# retry / watchdog / atomic commit
# ---------------------------------------------------------------------------
_DEFAULT_RETRY_ON = (IOError, OSError, TimeoutError, WatchdogTimeout)


def retrying(max_attempts=3, backoff=0.05, max_backoff=2.0,
             retry_on=_DEFAULT_RETRY_ON, name=None, on_retry=None):
    """Decorator: retry `fn` on transient errors with exponential backoff.

    Every retry emits a structured log record (event, point, attempt,
    error, sleep) and invokes `on_retry(attempt, error)` when given. The
    final failure re-raises. `max_attempts` is clamped to ≥1 (attempts
    COUNT CALLS, not retries — 0 would silently return None without ever
    calling fn; call sites wire user env vars like
    MXNET_DATALOADER_RETRIES straight in)."""
    attempts = max(1, int(max_attempts))

    def deco(fn):
        label = name or getattr(fn, "__qualname__", repr(fn))

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            delay = backoff
            for attempt in range(1, attempts + 1):
                try:
                    return fn(*args, **kwargs)
                except retry_on as e:
                    if attempt >= attempts:
                        _log_event("fault.retry_exhausted", point=label,
                                   attempts=attempt, error=repr(e))
                        raise
                    _log_event("fault.retry", point=label, attempt=attempt,
                               error=repr(e), sleep=delay)
                    if on_retry is not None:
                        on_retry(attempt, e)
                    time.sleep(delay)
                    delay = min(delay * 2, max_backoff)
        return wrapper
    return deco


def _flightrec_watchdog(message):
    """Black-box the stall before WatchdogTimeout unwinds the stack: the
    ring names the spans that were open when the region blew its budget.
    Crash-path code: never raises."""
    try:
        from ..telemetry.trace import flightrec_record, flightrec_maybe_dump
        flightrec_record("watchdog", message)
        flightrec_maybe_dump("watchdog")
    except Exception:
        pass


@contextmanager
def watchdog(seconds, message=None):
    """Bound the wall-clock time of a region.

    On the main thread this is preemptive: SIGALRM fires mid-region and
    raises WatchdogTimeout even inside a blocking call that returns to the
    interpreter (a sleep; not a CUDA synchronize, which holds the thread
    until the card is done). Off the main thread it degrades to a
    cooperative check at region exit (POSIX signals only deliver to the
    main thread). Nesting works: the inner region saves the outer timer
    and re-arms its remaining time on exit (an outer deadline that expired
    inside the inner region fires immediately after). A region that
    expires is recorded in the flight recorder (and dumped, rate-limited,
    when MXNET_FLIGHTREC_DIR is set) before the error unwinds."""
    if seconds is None or seconds <= 0:
        yield
        return
    msg = message or f"watchdog: step exceeded {seconds:.3g}s"
    main = threading.current_thread() is threading.main_thread()
    if main and hasattr(signal, "setitimer"):
        fired = [False]

        def _handler(signum, frame):
            fired[0] = True
            raise WatchdogTimeout(msg)
        prev_handler = signal.signal(signal.SIGALRM, _handler)
        outer_delay, _ = signal.setitimer(signal.ITIMER_REAL, seconds)
        t0 = time.monotonic()
        try:
            yield
        except WatchdogTimeout:
            # recorded here, not in the handler: by now every lock the
            # interrupted code held (the recorder's too) is released; only
            # when this region's timer fired, not a nested one's
            if fired[0]:
                _flightrec_watchdog(msg)
            raise
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, prev_handler)
            if outer_delay:
                remaining = outer_delay - (time.monotonic() - t0)
                signal.setitimer(signal.ITIMER_REAL, max(remaining, 1e-3))
    else:
        expired = threading.Event()
        timer = threading.Timer(seconds, expired.set)
        timer.daemon = True
        timer.start()
        try:
            yield
        finally:
            timer.cancel()
        if expired.is_set():
            _flightrec_watchdog(msg)
            raise WatchdogTimeout(msg)


def fsync_dir(path):
    """fsync a directory so a committed rename survives power loss."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextmanager
def atomic_output(path, mode="wb"):
    """Crash-consistent file write: yields a temp file in the target's
    directory; on clean exit the data is flushed, fsync'd, and os.replace'd
    over `path` (then the directory is fsync'd). On error the temp file is
    removed and `path` is untouched — a partial write can never shadow a
    good file."""
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix="." + os.path.basename(path),
                               suffix=".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            yield f
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(d)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


# ---------------------------------------------------------------------------
# anomaly guard (the amp all_finite pattern, standalone)
# ---------------------------------------------------------------------------
def loss_is_finite(loss):
    """True iff the step's loss is entirely finite. Accepts python scalars,
    numpy arrays, tensors, NDArrays, or (nested) lists of them — the
    standalone form of amp's all_finite overflow scan. A tensor on the card
    is read with one synchronizing copy of a bool."""
    if loss is None:
        return True
    if isinstance(loss, (list, tuple)):
        return all(loss_is_finite(l) for l in loss)
    t = getattr(loss, "_t", loss)        # an NDArray's tensor
    if isinstance(t, torch.Tensor):
        return bool(torch.isfinite(t.detach()).all())
    return bool(_np.isfinite(_np.asarray(loss, dtype=_np.float64)).all())


# ---------------------------------------------------------------------------
# auto-resume driver
# ---------------------------------------------------------------------------
def _jsonify_rng_leaf(v):
    """Recursively make a bit_generator.state tree JSON-safe: ndarray
    leaves (MT19937's 624-word key, Philox counters) become tagged
    base64 blobs; everything else PCG64-style plain ints/strs."""
    if isinstance(v, dict):
        return {k: _jsonify_rng_leaf(x) for k, x in v.items()}
    if isinstance(v, _np.ndarray):
        return {"__nd__": base64.b64encode(v.tobytes()).decode("ascii"),
                "dtype": str(v.dtype), "shape": list(v.shape)}
    if isinstance(v, _np.integer):
        return int(v)
    return v


def _unjsonify_rng_leaf(v):
    if isinstance(v, dict):
        if "__nd__" in v:
            return _np.frombuffer(
                base64.b64decode(v["__nd__"]),
                dtype=_np.dtype(v["dtype"])).reshape(v["shape"]).copy()
        return {k: _unjsonify_rng_leaf(x) for k, x in v.items()}
    return v


def rng_state_encode(rng):
    """JSON-safe snapshot of a random stream, for the checkpoint manifest:
    a numpy RandomState, a numpy Generator over ANY bit generator
    (MT19937/Philox array states are base64-tagged), or a torch.Generator
    (the port's streams; the counterpart of a JAX key carried in the
    state). None passes through."""
    if rng is None:
        return None
    if isinstance(rng, torch.Generator):
        return {"kind": "torch", "device": str(rng.device),
                "state": base64.b64encode(
                    rng.get_state().numpy().tobytes()).decode("ascii")}
    if hasattr(rng, "bit_generator"):      # np.random.Generator
        return {"kind": "generator",
                "state": _jsonify_rng_leaf(rng.bit_generator.state)}
    name, keys, pos, has_gauss, cached = rng.get_state()
    return {"kind": "randomstate", "name": name,
            "keys": base64.b64encode(
                _np.asarray(keys, dtype=_np.uint32).tobytes())
            .decode("ascii"),
            "pos": int(pos), "has_gauss": int(has_gauss),
            "cached": float(cached)}


def rng_state_restore(rng, snap):
    """Restore a `rng_state_encode` snapshot into the SAME kind of RNG."""
    if rng is None or snap is None:
        return
    names = {"torch": "torch.Generator", "generator": "np.random.Generator",
             "randomstate": "RandomState"}
    kind = ("torch" if isinstance(rng, torch.Generator) else
            "generator" if hasattr(rng, "bit_generator") else "randomstate")
    if snap["kind"] != kind:
        raise MXNetError(f"checkpoint holds {names[snap['kind']]} state but "
                         f"a {names[kind]} was passed")
    if kind == "torch":
        state = _np.frombuffer(base64.b64decode(snap["state"]),
                               dtype=_np.uint8).copy()
        rng.set_state(torch.from_numpy(state))
    elif kind == "generator":
        rng.bit_generator.state = _unjsonify_rng_leaf(snap["state"])
    else:
        keys = _np.frombuffer(base64.b64decode(snap["keys"]),
                              dtype=_np.uint32)
        rng.set_state((snap["name"], keys, snap["pos"], snap["has_gauss"],
                       snap["cached"]))


class ResilientRun:
    """Result of run_resilient: final state + step + failure accounting."""

    def __init__(self):
        self.state = None
        self.step = 0
        self.resumed_from = None
        self.saved_steps = []
        self.skipped_nonfinite = 0
        self.step_retries = 0

    def __repr__(self):
        return (f"ResilientRun(step={self.step}, "
                f"resumed_from={self.resumed_from}, "
                f"saved={self.saved_steps}, "
                f"skipped_nonfinite={self.skipped_nonfinite}, "
                f"step_retries={self.step_retries})")


def _restore(ckpt_dir, step, sharded, device, like):
    from .. import checkpoint as ckpt
    if not sharded:
        entry = ckpt.latest_entry(ckpt_dir)
        path = os.path.join(ckpt_dir, entry["path"])
        # as_numpy: bit-exact restore (an NDArray would narrow float64)
        params, _ = ckpt.load_checkpoint(path, device=device,
                                         as_numpy=device is None)
        return params
    # each tensor leaf lands where the cold-start state's leaf lives, with
    # its dtype (an explicit `device` overrides the placement)
    tree, _ = ckpt.load_sharded(ckpt_dir, step=step,
                                target=like if device is None else None,
                                device=device)
    return tree


def run_resilient(step_fn, state, ckpt_dir, num_steps, *, ckpt_every=10,
                  keep_last=3, skip_nonfinite=True, watchdog_seconds=None,
                  mesh=None, specs=None, sharded=True, device=None,
                  max_step_retries=2, retry_backoff=0.05,
                  retry_on=(IOError, OSError, TimeoutError),
                  ckpt_retries=3, rng=None):
    """Run `num_steps` of `step_fn(state, step) -> (state, loss)` with
    crash-consistent checkpoints every `ckpt_every` steps and automatic
    resume from the newest COMMITTED checkpoint in `ckpt_dir`.

    `step_fn` must not write its input state (return new tensors, as
    `models.transformer.make_train_step` does): a skipped or retried step
    goes on from the very state it was given.

    Recovery behaviors:
      - on entry, if `ckpt_dir` holds a committed checkpoint, training
        resumes from it (the passed `state` is only the cold-start value,
        and with `sharded=True` the template each restored leaf's device
        and dtype come from)
      - a step whose loss is non-finite is skipped — the state does not
        advance, the step index does (so a deterministic step_fn replays
        identically after a crash) — and counted in `skipped_nonfinite`
      - transient step errors (`retry_on`, default IOError/OSError/
        TimeoutError) are retried up to `max_step_retries` times.
        WatchdogTimeout is deliberately NOT retried by default: a stalled
        step may be blocked inside a cross-process collective, and one
        participant re-entering it desynchronizes the job — add
        `fault.WatchdogTimeout` to `retry_on` only for single-process
        steps where a stall is known to be retry-safe
      - each step runs under `fault.watchdog(watchdog_seconds)` when set,
        so a stalled step aborts instead of hanging the job
      - checkpoint saves go through fault.retrying(`ckpt_retries`)

    `sharded=True` (default) uses checkpoint.save_sharded/load_sharded (the
    port's per-leaf directory format); `sharded=False` uses the host-local
    npz format for plain dict-of-array state. Both commit through the
    manifest protocol, so a crash mid-save never loses the previous
    checkpoint. Resuming onto a different mesh (`mesh`, `specs`) waits for
    the port's mesh (ROADMAP A10) and raises.

    Crash-consistent accounting: `skipped_nonfinite` / `step_retries`
    counters — and the state of `rng` (a numpy RandomState/Generator or a
    torch.Generator the step_fn draws from), when one is passed — are
    persisted in each committed manifest entry and restored on resume, so
    a SIGKILL cannot reset the skip count or replay different random draws
    than the uninterrupted run would have made. Returns a ResilientRun.
    """
    from .. import checkpoint as ckpt
    if mesh is not None or specs is not None:
        raise MXNetError("run_resilient(mesh=, specs=): resuming onto a "
                         "device mesh waits for the port's mesh "
                         "(ROADMAP A10)")
    from ..telemetry import (install_crash_hooks, mem_install_oom_hook,
                             mem_on_oom, span as _span)
    # a resilient run leaves a black box: the flight recorder's hooks
    # (armed while MXNET_FLIGHTREC_DIR is set) and the OOM excepthook
    install_crash_hooks()
    mem_install_oom_hook()
    run = ResilientRun()
    entry = ckpt.latest_entry(ckpt_dir)
    if entry is not None:
        completed = entry["step"]
        state = _restore(ckpt_dir, completed, sharded, device, state)
        run.resumed_from = completed
        saved = (entry.get("extra") or {}).get("resilient") or {}
        run.skipped_nonfinite = int(saved.get("skipped_nonfinite", 0))
        run.step_retries = int(saved.get("step_retries", 0))
        rng_state_restore(rng, saved.get("rng"))
        _log_event("resilient.resumed", dir=ckpt_dir, step=completed,
                   rescaled=False,
                   skipped_nonfinite=run.skipped_nonfinite,
                   step_retries=run.step_retries,
                   rng_restored=rng is not None
                   and saved.get("rng") is not None)
    else:
        completed = 0

    def _run_extra():
        ex = {"skipped_nonfinite": run.skipped_nonfinite,
              "step_retries": run.step_retries}
        if rng is not None:
            ex["rng"] = rng_state_encode(rng)
        return {"resilient": ex}

    def _save(st, step_no):
        if sharded:
            ckpt.save_sharded(ckpt_dir, st, step=step_no,
                              keep_last=keep_last, extra=_run_extra())
        else:
            name = f"ckpt-{step_no}"
            ckpt.save_checkpoint(os.path.join(ckpt_dir, name), st,
                                 step=step_no)
            ckpt.commit_step(ckpt_dir, step_no, kind="npz",
                             path=name + ".npz", keep_last=keep_last,
                             extra=_run_extra())
        run.saved_steps.append(step_no)
        _log_event("resilient.saved", dir=ckpt_dir, step=step_no)

    save_retrying = retrying(max_attempts=max(1, ckpt_retries),
                             backoff=retry_backoff,
                             name="resilient.checkpoint")(_save)

    def _count_retry(attempt, error):
        run.step_retries += 1

    def _attempt(step):
        # the span outside the watchdog: its span_open flight-recorder
        # event (with the step) is spooled before the step body runs, so
        # a SIGKILL mid-step leaves a black box naming the step
        with _span("resilient.step", step=step):
            with watchdog(watchdog_seconds):
                inject("resilient.step")
                try:
                    return step_fn(state, step)
                except BaseException as e:
                    # an OOM leaves the memory black box before the retry
                    # machinery sees it (never raises; a no-op otherwise)
                    mem_on_oom(e, where="resilient.step")
                    raise

    run_step = retrying(max_attempts=max_step_retries + 1,
                        backoff=retry_backoff, retry_on=tuple(retry_on),
                        name="resilient.step",
                        on_retry=_count_retry)(_attempt)

    for step in range(completed, num_steps):
        out = run_step(step)
        if isinstance(out, tuple) and len(out) == 2:
            new_state, loss = out
        else:
            new_state, loss = out, None
        loss = inject("resilient.loss", loss)
        if skip_nonfinite and not loss_is_finite(loss):
            run.skipped_nonfinite += 1
            _log_event("resilient.skipped_nonfinite", step=step)
        else:
            state = new_state
        done = step + 1
        if done % ckpt_every == 0 or done == num_steps:
            save_retrying(state, done)

    run.state = state
    run.step = num_steps
    return run
