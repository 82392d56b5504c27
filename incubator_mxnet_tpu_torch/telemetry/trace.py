"""mx.telemetry.trace of the PyTorch port: request tracing and the crash
flight recorder.

Counterpart of `incubator_mxnet_tpu/telemetry/trace.py`, the port's own
copy. Two halves, one question ("what was this process doing?") asked
live and post mortem:

  * **Trace context.** A `TraceContext` (trace_id, span_id, name,
    parent) makes spans recorded on different threads, or in different
    processes, reassemble into one request tree. The active context lives
    in a `contextvars.ContextVar`, so `telemetry.span` nests without an
    explicit stack, and a hop is two calls:

        ctx = trace.current_context()        # the producer side
        token = trace.attach(ctx)            # the consumer side
        ...
        trace.detach(token)

    Process boundaries carry `ctx.to_dict()` / `TraceContext.from_dict`.
    `MXNET_TRACE_SAMPLE` (0..1, default 1) head-samples root traces,
    deterministically 1 in k.

  * **Flight recorder.** A bounded ring (`MXNET_FLIGHTREC_EVENTS`, default
    512) of recent events (span opens and closes, fault injections, the
    watchdog, overload sheds, OOMs), fed by `telemetry.span`,
    `record_span` and `fault._log_event`. `flightrec_dump()` writes the
    ring as one JSON file; with `MXNET_FLIGHTREC_DIR` set every event is
    also spooled as a flushed JSONL line to `<dir>/flightrec-<pid>.jsonl`,
    which survives a SIGKILL.

One difference from the JAX package: `install_crash_hooks` arms its
atexit dump and SIGTERM handler only while `MXNET_FLIGHTREC_DIR` is set.
Without it both would be no-ops in the JAX package too, and the port
leaves the process's handlers alone.

No torch, no numpy: the module imports nothing heavy.
"""
from __future__ import annotations

import contextvars
import itertools
import json
import os
import threading
import time
from collections import deque

from ..base import _register_env, get_env
from .registry import REGISTRY

__all__ = [
    "TraceContext", "current_context", "attach", "detach", "attached",
    "new_context", "child_context", "FlightRecorder", "FLIGHTREC",
    "flightrec_record", "flightrec_dump", "flightrec_maybe_dump",
    "flightrec_events", "install_crash_hooks", "request_root", "enabled",
    "collector_active",
]

_register_env("MXNET_TRACE_SAMPLE", float, 1.0,
              "Head-sampling rate (0..1) for NEW root trace contexts "
              "(serve requests, root spans). Sampled-out work still runs "
              "and still counts in every metric; it just mints no trace "
              "ids. Deterministic 1-in-k, not random")
_register_env("MXNET_FLIGHTREC_EVENTS", int, 512,
              "Flight-recorder ring capacity (recent events retained "
              "in memory; older events count in flightrec.dropped)")
_register_env("MXNET_FLIGHTREC_DIR", str, None,
              "When set: spool every flight-recorder event as a flushed "
              "JSONL line to <dir>/flightrec-<pid>.jsonl (SIGKILL-durable "
              "black box) and enable the watchdog/atexit dump files there")

# -- metrics (docs/OBSERVABILITY.md catalog; exercised in tests) ------------
# lock-free GIL-atomic stats groups, NOT registry Counter objects: a mint
# (and its sampled-out twin) happens per REQUEST on every submitter
# thread at once, and a registry-lock `inc()` measured 15us under
# 16-thread contention (lock convoy) vs ~0.1us for a plain dict add —
# the documented DISPATCH_STATS tradeoff (rare lost increments are
# acceptable for diagnostics counters; snapshot(reset) stays atomic
# under the group's private lock). Snapshot names are identical to the
# object-metric form: `trace.traces`, `flightrec.events`, ...
TRACE_STATS = REGISTRY.stats_group("trace", {
    "traces": 0,        # root trace contexts minted
    "spans": 0,         # spans recorded carrying a trace context
    "attaches": 0,      # contexts attached across a thread/process hop
    "sampled_out": 0,   # root traces skipped by MXNET_TRACE_SAMPLE
}, lock=None, help="request-tracing counters (lock-free hot path)")
FLIGHTREC_STATS = REGISTRY.stats_group("flightrec", {
    "events": 0,        # events appended to the flight-recorder ring
    "dropped": 0,       # ring-capacity evictions (oldest overwritten)
    "dumps": 0,         # black-box dump files written
}, lock=None, help="flight-recorder counters")


# ---------------------------------------------------------------------------
# ids + context
# ---------------------------------------------------------------------------
_ids = itertools.count(1)
# os.getpid() is a real syscall (~0.5us) and ids mint per request: cache
# the prefix, refreshed in fork children so ids stay process-unique
_pid_prefix = [f"{os.getpid():x}-"]
if hasattr(os, "register_at_fork"):
    os.register_at_fork(
        after_in_child=lambda: _pid_prefix.__setitem__(
            0, f"{os.getpid():x}-"))


def _new_id():
    # pid-prefixed monotonic counter: unique within a process tree without
    # randomness (scripts/workflows stay deterministic and replayable)
    return _pid_prefix[0] + format(next(_ids), "x")


class TraceContext:
    """One node of a request tree: immutable, ~free to mint, serializable.

    `trace_id` names the whole request; `span_id` this node; `parent_*`
    the enclosing node (None at the root). Spans recorded under an
    attached context stamp all three into their Chrome-trace args, so a
    viewer (or a test) can reassemble the cross-thread tree."""

    __slots__ = ("trace_id", "span_id", "name", "parent_span_id",
                 "parent_name")

    def __init__(self, trace_id, span_id, name, parent_span_id=None,
                 parent_name=None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.name = name
        self.parent_span_id = parent_span_id
        self.parent_name = parent_name

    def to_dict(self):
        """JSON-safe form for process boundaries (serve requests, worker
        commands). `from_dict` is the inverse."""
        d = {"trace_id": self.trace_id, "span_id": self.span_id,
             "name": self.name}
        if self.parent_span_id is not None:
            d["parent_span_id"] = self.parent_span_id
        if self.parent_name is not None:
            d["parent_name"] = self.parent_name
        return d

    @classmethod
    def from_dict(cls, d):
        if not d or "trace_id" not in d:
            return None
        return cls(d["trace_id"], d.get("span_id"), d.get("name"),
                   d.get("parent_span_id"), d.get("parent_name"))

    def __repr__(self):
        return (f"TraceContext({self.name!r}, trace={self.trace_id}, "
                f"span={self.span_id}, parent={self.parent_name!r})")


_CTX = contextvars.ContextVar("mx_trace_ctx", default=None)

# sentinel pushed by a root span whose trace was SAMPLED OUT: descendants
# must inherit the decision (no ids, no fresh root per inner span) instead
# of each rolling their own sampling draw and minting orphan mid-request
# roots. `current_context()` renders it as None; only the span class and
# request_root look at the raw value.
NOT_SAMPLED = TraceContext("", "", "<not-sampled>")

# deterministic 1-in-k head sampler (no random: replayable, lint-clean)
_sample_lock = threading.Lock()
_sample_n = [0]
# root-mint env read: cache keyed on the RAW env string, so a
# monkeypatched value still takes effect immediately (mints only happen
# while a collector is active, so this read is off the default hot path)
_sample_memo = [object(), 1.0]


def _sample_rate():
    raw = os.environ.get("MXNET_TRACE_SAMPLE")
    if raw != _sample_memo[0]:
        try:
            _sample_memo[1] = 1.0 if raw is None else float(raw)
        except ValueError:
            _sample_memo[1] = 1.0
        _sample_memo[0] = raw
    return _sample_memo[1]


def _sampled():
    rate = _sample_rate()
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    with _sample_lock:
        _sample_n[0] += 1
        n = _sample_n[0]
    return int(n * rate) != int((n - 1) * rate)


# MXNET_TELEMETRY / MXNET_TRACE_SAMPLE presence are consulted on the
# per-request serve path; `os.environ.get` of an UNSET key costs ~1us
# (internal KeyError) and it adds up at 10k req/s under a saturated GIL,
# so both are TTL-cached (50ms — env toggles still land promptly; the
# paired A/B harness and env-monkeypatching tests call
# _expire_env_memo() for an immediate re-read)
_ENV_TTL_S = 0.05
_env_deadline = [0.0]
_env_memo = {"enabled": True, "explicit_sample": False}


def _expire_env_memo():
    _env_deadline[0] = 0.0


def _env_refresh():
    raw = os.environ.get("MXNET_TELEMETRY")
    _env_memo["enabled"] = raw not in ("0", "false", "False", "")
    _env_memo["explicit_sample"] = \
        os.environ.get("MXNET_TRACE_SAMPLE") is not None


def enabled():
    """Tracing rides the MXNET_TELEMETRY master switch: `0` disables
    span recording AND context minting (counters stay live). TTL-cached
    (see above) — hot-path callers pay a clock read, not an env parse."""
    now = time.monotonic()
    if now > _env_deadline[0]:
        _env_deadline[0] = now + _ENV_TTL_S
        _env_refresh()
    return _env_memo["enabled"]


def collector_active():
    """True when something can actually CONSUME per-request trace ids:
    the profiler is collecting a Chrome trace, the flight-recorder spool
    is armed (`MXNET_FLIGHTREC_DIR`), or `MXNET_TRACE_SAMPLE` is
    explicitly set (an operator forcing request tracing, e.g. for the
    slowest-requests table). The per-REQUEST root-mint hot path (serve
    submit) gates on this: at ~10k req/s even a few microseconds of
    mint work per request measurably taxes a GIL-saturated server, and
    ids nobody can see are pure cost. Step-scale spans
    (`telemetry.span`) are NOT gated — their rate is harmless and their
    ids feed the flight-recorder ring either way."""
    now = time.monotonic()
    if now > _env_deadline[0]:
        _env_deadline[0] = now + _ENV_TTL_S
        _env_refresh()
    if _env_memo["explicit_sample"]:
        return True
    f = FLIGHTREC
    if f._ring is None:
        if f._spool_dir() is not None:      # first call: sized under lock
            return True
    elif f._spool_dir_memo is not None:     # immutable once sized
        return True
    return _profiler_running()


# the profiler module, resolved once: `from .. import profiler` per call
# runs the import machinery (~1us + import-lock traffic) on a
# per-request path
_profiler_mod = [None]


def _profiler_running():
    """Whether the port's `profiler` is collecting."""
    p = _profiler_mod[0]
    if p is None:
        from .. import profiler as p
        _profiler_mod[0] = p
    return p._state["running"]


def request_root(name):
    """Mint a request-root context iff tracing is enabled AND a
    collector is active — `enabled() and collector_active()` fused into
    ONE TTL check for the per-request serve hot path. Returns None
    otherwise (and None when the root is sampled out)."""
    now = time.monotonic()
    if now > _env_deadline[0]:
        _env_deadline[0] = now + _ENV_TTL_S
        _env_refresh()
    if not _env_memo["enabled"]:
        return None
    if not _env_memo["explicit_sample"]:
        f = FLIGHTREC
        if f._ring is None:
            if f._spool_dir() is None and not _profiler_running():
                return None
        elif f._spool_dir_memo is None and not _profiler_running():
            return None
    parent = _CTX.get()
    if parent is NOT_SAMPLED:   # a request is its own sampling domain
        parent = None
    return child_context(parent, name)


def current_context():
    """The TraceContext active on this thread of execution, or None
    (a sampled-out subtree reads as None — no ids exist there)."""
    ctx = _CTX.get()
    return None if ctx is NOT_SAMPLED else ctx


def _raw_context():
    """Internal: like current_context but exposing the NOT_SAMPLED
    sentinel, so span entry can inherit a sampled-out decision."""
    return _CTX.get()


def new_context(name, sampled=None):
    """Mint a ROOT context (a new trace). Subject to MXNET_TRACE_SAMPLE
    unless `sampled` forces the decision; returns None when sampled out."""
    if not (_sampled() if sampled is None else sampled):
        TRACE_STATS["sampled_out"] += 1  # mxlint: disable=lock-shared-mutation -- documented lock-free diagnostics (DISPATCH_STATS pattern)
        return None
    TRACE_STATS["traces"] += 1  # mxlint: disable=lock-shared-mutation -- documented lock-free diagnostics (DISPATCH_STATS pattern)
    # convention: the ROOT span's id IS the trace id (one mint per root —
    # this runs per request on the serve path)
    tid = _new_id()
    return TraceContext(tid, tid, name)


def child_context(parent, name, sampled=None):
    """Mint a child of `parent` (same trace, fresh span id). With
    `parent=None` this starts a new root trace (sampling applies)."""
    if parent is None:
        return new_context(name, sampled=sampled)
    return TraceContext(parent.trace_id, _new_id(), name,
                        parent_span_id=parent.span_id,
                        parent_name=parent.name)


def attach(ctx):
    """Make `ctx` current on THIS thread (the consumer side of a hop);
    returns a token for `detach`. Counted in `trace.attaches`."""
    if ctx is not None:
        TRACE_STATS["attaches"] += 1  # mxlint: disable=lock-shared-mutation -- documented lock-free diagnostics (DISPATCH_STATS pattern)
    return _CTX.set(ctx)


def detach(token):
    """Undo an `attach` (tolerates tokens from a dead context)."""
    try:
        _CTX.reset(token)
    except ValueError:
        pass


class attached:
    """`with trace.attached(ctx):` — scoped attach/detach."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx):
        self._ctx = ctx
        self._token = None

    def __enter__(self):
        self._token = attach(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        detach(self._token)
        return False


def _push(ctx):
    """Internal: set the current context WITHOUT counting an attach —
    span entry/exit, not a cross-boundary hop."""
    return _CTX.set(ctx)


_reset = detach


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------
def _now_us():
    return time.perf_counter_ns() // 1000


class FlightRecorder:
    """Bounded ring of recent structured events + optional SIGKILL-durable
    JSONL spool (see module docstring). `record` is the only hot call:
    one lock, one deque append, and — only when `MXNET_FLIGHTREC_DIR` is
    set — one flushed line write."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ring = None            # sized lazily from the env knob
        self._spool = None
        self._spool_path = None
        self._spool_failed = False
        self._spool_dir_memo = None  # read once per ring life (reset hook)
        self._last_dump = {}         # reason -> monotonic seconds

    # -- setup ----------------------------------------------------------
    def _ensure_locked(self):
        if self._ring is None:
            cap = max(16, get_env("MXNET_FLIGHTREC_EVENTS", 512, typ=int))
            self._ring = deque(maxlen=cap)
            self._spool_dir_memo = get_env("MXNET_FLIGHTREC_DIR", typ=str)

    def _spool_dir(self):
        # cached with the ring (one env read per recorder life, not per
        # event); _reset_for_tests re-reads
        with self._lock:
            self._ensure_locked()
            return self._spool_dir_memo

    def _spool_file_locked(self):
        if self._spool is not None or self._spool_failed:
            return self._spool
        d = self._spool_dir_memo
        if not d:
            return None
        try:
            os.makedirs(d, exist_ok=True)
            self._spool_path = os.path.join(
                d, f"flightrec-{os.getpid()}.jsonl")
            self._spool = open(self._spool_path, "a", encoding="utf-8")
        except OSError:
            # a broken spool dir must never take the traced workload down
            self._spool_failed = True
            self._spool = None
        return self._spool

    # -- the one hot call ------------------------------------------------
    def record(self, kind, name, /, **fields):
        """Append one event. `kind` is the event class (`span_open`,
        `span`, `fault`, `watchdog`, `collective_timeout`, `serve.shed`,
        ...), `name` the subsystem-specific symbol (span name, fault
        point). The active trace context's ids ride along."""
        ev = {"ts_us": _now_us(), "kind": kind, "name": name}
        ctx = _CTX.get()
        if ctx is not None:
            ev["trace_id"] = ctx.trace_id
            ev["span_id"] = ctx.span_id
        for k, v in fields.items():
            if k == "trace_id" and v is None:
                continue            # "no trace" is absence, not null
            # caller fields must not clobber the envelope (fault events
            # carry their own `kind="kill"` etc.) — prefix collisions
            ev[("f_" + k) if k in ("ts_us", "kind", "name", "thread")
               else k] = v
        ev["thread"] = threading.current_thread().name
        with self._lock:
            self._ensure_locked()
            if len(self._ring) == self._ring.maxlen:
                FLIGHTREC_STATS["dropped"] += 1  # mxlint: disable=lock-shared-mutation -- under self._lock; group is lock-free by design
            self._ring.append(ev)
            f = self._spool_file_locked()
            if f is not None:
                try:
                    # flush per line: data handed to the kernel survives a
                    # SIGKILL (fsync would only add power-loss durability
                    # at ~100x the cost)
                    f.write(json.dumps(ev, default=str) + "\n")
                    f.flush()
                except (OSError, ValueError):
                    self._spool_failed = True
                    self._spool = None
        FLIGHTREC_STATS["events"] += 1  # mxlint: disable=lock-shared-mutation -- documented lock-free diagnostics (DISPATCH_STATS pattern)

    # -- inspection / dump ----------------------------------------------
    def events(self):
        """Copy of the ring, oldest first."""
        with self._lock:
            self._ensure_locked()
            return list(self._ring)

    @property
    def spool_path(self):
        return self._spool_path

    def dump(self, path=None, reason=""):
        """Write the ring as one JSON black-box file and return its path
        (None on failure — dump sits on crash paths and must never raise).
        Default location: `MXNET_FLIGHTREC_DIR` (or the cwd) /
        `flightrec-<pid>.json`; an existing file is atomically replaced,
        so the newest dump wins."""
        try:
            events = self.events()
            if path is None:
                d = self._spool_dir() or "."
                os.makedirs(d, exist_ok=True)
                path = os.path.join(d, f"flightrec-{os.getpid()}.json")
            payload = {
                "pid": os.getpid(),
                "reason": reason,
                "dumped_ts_us": _now_us(),
                "n_events": len(events),
                "events": events,
            }
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f, default=str)
            os.replace(tmp, path)
            FLIGHTREC_STATS["dumps"] += 1  # mxlint: disable=lock-shared-mutation -- documented lock-free diagnostics (DISPATCH_STATS pattern)
            return path
        except Exception:
            return None

    def maybe_dump(self, reason, min_interval_s=5.0):
        """Rate-limited dump for recurring triggers (overload shedding,
        watchdogs): at most one file per `reason` per interval, and a
        NO-OP unless MXNET_FLIGHTREC_DIR is set (no surprise files)."""
        if not self._spool_dir():
            return None
        now = time.monotonic()
        with self._lock:
            last = self._last_dump.get(reason)
            if last is not None and now - last < min_interval_s:
                return None
            self._last_dump[reason] = now
        return self.dump(reason=reason)

    def _reset_for_tests(self):
        """Drop the ring and spool so a test can re-read the env knobs."""
        with self._lock:
            self._ring = None
            self._spool_dir_memo = None
            if self._spool is not None:
                try:
                    self._spool.close()
                except OSError:
                    pass
            self._spool = None
            self._spool_path = None
            self._spool_failed = False
            self._last_dump.clear()


FLIGHTREC = FlightRecorder()
flightrec_record = FLIGHTREC.record
flightrec_dump = FLIGHTREC.dump
flightrec_maybe_dump = FLIGHTREC.maybe_dump
flightrec_events = FLIGHTREC.events


# ---------------------------------------------------------------------------
# crash hooks (atexit + SIGTERM): best-effort dump on orderly-ish deaths;
# the JSONL spool covers SIGKILL, where nothing can run
# ---------------------------------------------------------------------------
_hooks_lock = threading.Lock()
_atexit_armed = [False]
_sigterm_armed = [False]


def _atexit_dump():
    try:
        FLIGHTREC.maybe_dump("atexit", min_interval_s=0.0)
    except Exception:
        pass


def install_crash_hooks():
    """Idempotent: register an atexit dump and a SIGTERM handler that
    dumps then re-raises the default disposition, while
    `MXNET_FLIGHTREC_DIR` is set (both would be no-ops without it; see
    the module docstring). The signal hook only installs from the main
    thread and only while SIGTERM still has the default handler (a user
    handler is never displaced); the two halves latch separately, so a
    first call from a worker thread (which can only arm atexit) does not
    block a later main-thread call from arming the signal hook."""
    if not FLIGHTREC._spool_dir():
        return
    with _hooks_lock:
        arm_atexit = not _atexit_armed[0]
        _atexit_armed[0] = True
        arm_sigterm = (not _sigterm_armed[0]
                       and threading.current_thread()
                       is threading.main_thread())
        if arm_sigterm:
            _sigterm_armed[0] = True
    if arm_atexit:
        import atexit
        atexit.register(_atexit_dump)
    if not arm_sigterm:
        return
    try:
        import signal

        if signal.getsignal(signal.SIGTERM) is not signal.SIG_DFL:
            return

        def _on_term(signum, frame):
            try:
                FLIGHTREC.record("signal", "SIGTERM")
                FLIGHTREC.maybe_dump("sigterm", min_interval_s=0.0)
            except Exception:
                pass
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, _on_term)
    except (ValueError, OSError):
        pass

