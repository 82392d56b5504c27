"""serve.fleet of the PyTorch port — multi-replica serving: supervisor,
SLO-aware router, replica-death failover and zero-downtime drain-and-swap.

Counterpart of `incubator_mxnet_tpu/serve/fleet.py`, same design:

    Fleet (this process)                      replica children
    ───────────────────                       ────────────────
    submit() ─► router ── EDF-aware ────────► serve.replica 0   engine
                │         least-loaded        serve.replica 1   engine
                │         dispatch            ...
    monitor ────┤  heartbeats / liveness
    supervisor ─┘  respawn / drain-and-swap

  * **Dispatch** (`fleet.dispatch` fault point): among SERVING replicas,
    the least-loaded (router in-flight count, then the replica's reported
    queue depth, then the lowest index); the remaining deadline budget is
    recomputed at every (re-)dispatch, and an EDF gate orders concurrent
    claims earliest-deadline-first.
  * **Prefix affinity**: the router remembers which replica last served
    each block-quantized prompt-prefix hash (`serve.prefix_cache.
    rolling_hash`, block = MXNET_SERVE_PREFIX_BLOCK) and prefers it while
    it is healthy (`fleet.affinity_hits`); a bounded LRU, a preference and
    never a constraint.
  * **Health** (`fleet.heartbeat`): pings every MXNET_FLEET_HEARTBEAT_MS;
    `heartbeat_misses` missed beats declare a replica hung (SIGKILL, then
    the death path); process exit is polled too.
  * **Failover**: a dead replica's in-flight requests re-enqueue onto
    survivors under a retry budget (MXNET_FLEET_RETRY_BUDGET); past it the
    original error surfaces, wrapped in `ReplicaDied`.
  * **Respawn** (`fleet.respawn`): bounded consecutive restarts (reset by
    the first reply after a respawn); past them the replica is `failed`
    and the fleet serves degraded.
  * **Drain-and-swap** (`fleet.swap`): `swap(spec)` rolls the replicas one
    at a time onto a new version-pinned spec, routing around the draining
    one; zero requests dropped.

Each child runs `python -m incubator_mxnet_tpu_torch.serve.replica` with
the repo on PYTHONPATH and logs to
`<workdir>/replica<i>.log`. The counters are the registry's `fleet`
stats group, each replica's state the `serve.replica_state{replica=i}`
gauge; a request is one trace: its `fleet.request` root context rides the
request message, and the replica's `serve.request` joins it. The compile
surface (`retraces_after_warmup`, `assert_no_retraces`) waits for ROADMAP
A3.
"""
from __future__ import annotations

import json
import logging
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future

import numpy as _np

from .. import fault as _fault
from ..base import MXNetError, get_env
from ..fault import _log_event
from ..telemetry import record_span, trace as _trace
from ..telemetry.registry import gauge, stats_group
from .batcher import (QueueFullError, RequestTimeout, ServeError,
                      ServerClosed)
from .prefix_cache import rolling_hash as _rolling_hash

logger = logging.getLogger("mx.serve.fleet")

__all__ = ["Fleet", "FleetError", "ReplicaDied", "FLEET_STATS",
           "fleet_stats", "REPLICA_STATES"]

_STATS_LOCK = threading.Lock()
FLEET_STATS = stats_group("fleet", {
    "replicas_live": 0,       # level: replicas currently SERVING
    "failovers": 0,           # replica-death events with in-flight work
    "retries": 0,             # request re-dispatches after a failure
    "respawns": 0,            # failure respawns (swap restarts excluded)
    "swaps": 0,               # completed rolling drain-and-swap operations
    "drain_ms": 0.0,          # cumulative replica drain time
    "profile_divergence": 0,  # hellos showing replicas of one fleet under
                              # different tune profiles
    "affinity_hits": 0,       # dispatches routed by prefix affinity
}, lock=_STATS_LOCK, help="serving-fleet supervisor/router counters")


def fleet_stats(reset=False):
    """Snapshot (optionally reset, atomically) of the process-wide fleet
    counters."""
    return FLEET_STATS.snapshot(reset=reset)


# replica lifecycle, the JAX package's codes, surfaced per replica on the
# serve.replica_state gauge
REPLICA_STATES = {"dead": 0, "spawning": 1, "serving": 2, "draining": 3,
                  "failed": 4}
_REPLICA_STATE = gauge(
    "serve.replica_state",
    help="fleet replica lifecycle (0 dead, 1 spawning, 2 serving, "
         "3 draining, 4 failed)",
    labels=("replica",))


class FleetError(ServeError):
    """Fleet-level failure (no serving replica, aborted swap, ...)."""


class ReplicaDied(FleetError):
    """A replica died; carries the index and the original cause (the
    error that surfaces when the retry budget is spent)."""

    def __init__(self, msg, replica=None, cause=None):
        super().__init__(msg)
        self.replica = replica
        self.cause = cause


# error kinds a replica forwards over the wire -> client-visible classes
_WIRE_ERRORS = {
    "RequestTimeout": RequestTimeout,
    "QueueFullError": QueueFullError,
    "ServerClosed": ServerClosed,
    "ServeError": ServeError,
}


class _FleetRequest:
    __slots__ = ("rid", "prompt", "max_new", "deadline_at", "future",
                 "attempts", "reroutes", "t_submit", "replica",
                 "first_error", "sampling", "prefix_hash", "ctx")

    def __init__(self, rid, prompt, max_new, deadline_at, sampling=None,
                 prefix_hash=None, ctx=None):
        self.rid = rid
        self.ctx = ctx                    # fleet.request root context
        self.prompt = prompt
        self.max_new = max_new
        self.deadline_at = deadline_at    # perf_counter deadline or None
        self.future = Future()
        self.attempts = 0                 # failed dispatch/serve attempts
        self.reroutes = 0                 # silent ReplicaDraining re-routes
        self.t_submit = time.perf_counter()
        self.replica = None
        self.first_error = None
        # sampling params ride the wire verbatim (and survive failover
        # re-dispatch — including the router-assigned seed, so a retried
        # sampled request draws the SAME tokens on the new replica)
        self.sampling = sampling or {}
        self.prefix_hash = prefix_hash    # affinity key (None = no prefix)

    def sort_key(self):
        """EDF for failover re-dispatch: earliest deadline first,
        deadline-less after every deadline-holder, FIFO among peers."""
        return (self.deadline_at is None,
                self.deadline_at if self.deadline_at is not None
                else self.t_submit,
                self.t_submit)


class _EDFGate:
    """Deadline-ordered admission to replica claiming.

    `_pick()` breaks load ties by index, and concurrent dispatch threads
    race it arbitrarily — so under contention a deadline-less request
    could claim the least-loaded replica ahead of one about to expire.
    The gate serializes the CLAIM step in earliest-deadline-first order
    (`_FleetRequest.sort_key`: deadline holders first, FIFO among
    deadline-less peers): every dispatching request registers, and only
    the tightest-deadline waiter may proceed to `_pick()`; everyone else
    blocks on the condition until the head leaves. Claims are quick
    (pick + one socket write), so this orders the queue without
    meaningfully serializing throughput — and it unifies admission with
    the EDF failover re-dispatch order `_async_dispatch` already uses.
    """

    def __init__(self):
        self._cv = threading.Condition()
        self._waiting = []

    def enter(self, freq):
        with self._cv:
            self._waiting.append(freq)
            self._cv.notify_all()

    def leave(self, freq):
        with self._cv:
            try:
                self._waiting.remove(freq)
            except ValueError:
                pass
            self._cv.notify_all()

    def wait_turn(self, freq, timeout=0.02):
        """True when `freq` is the tightest-deadline waiter right now;
        otherwise block (bounded) for the head to advance and report
        whether it is our turn yet. Callers loop — their loop re-checks
        the request's own deadline/closing state between waits, so a
        non-head request is never parked unboundedly."""
        with self._cv:
            head = min(self._waiting, key=_FleetRequest.sort_key,
                       default=None)
            if head is freq or head is None:
                return True
            self._cv.wait(timeout)
            head = min(self._waiting, key=_FleetRequest.sort_key,
                       default=None)
            return head is freq or head is None


class _Replica:
    """Supervisor-side handle for one replica child. `generation` guards
    against stale reader threads / late death reports after a respawn."""

    def __init__(self, index):
        self.index = index
        self._state = "dead"
        self.generation = 0
        self.proc = None
        self.sock = None
        self.wlock = threading.Lock()
        self.pid = None
        self.hello = {}
        self.pong = {}
        self.version = None
        self.metrics_port = None
        self.inflight = {}            # rid -> _FleetRequest (fleet lock)
        self.last_pong = time.perf_counter()
        self.missed = 0
        self.consecutive_restarts = 0
        self.first_error = None       # original death reason (resurfaced)
        self.swap_pending = False     # orderly drain-exit in progress
        self.ready_evt = threading.Event()
        self.drained_evt = threading.Event()

    @property
    def state(self):
        return self._state

    @state.setter
    def state(self, value):
        # every transition moves the replica's gauge
        self._state = value
        _REPLICA_STATE.labels(replica=self.index).set(REPLICA_STATES[value])
        self.served_since_spawn = 0


class Fleet:
    """Replica supervisor + front-door router. ::

        spec = {"version": "v1", "config": {...DecoderConfig...},
                "seed": 0, "engine": {"max_slots": 4}, "device": "cuda"}
        with serve.Fleet(spec, replicas=2) as fleet:
            toks = fleet.submit([3, 1, 4], max_new_tokens=8).result()
            fleet.swap(dict(spec, version="v2"))   # zero-downtime

    Knobs (constructor arg > MXNET_FLEET_* env > default): `replicas`,
    `heartbeat_ms`, `retry_budget`, `drain_timeout_ms`; plus
    `heartbeat_misses` (beats before hung) and `max_restarts` (bounded
    consecutive respawns per replica). The replicas inherit this
    process's environment. A spec without "device" runs its engines on
    the card."""

    def __init__(self, spec, *, replicas=None, heartbeat_ms=None,
                 retry_budget=None, drain_timeout_ms=None,
                 heartbeat_misses=3, max_restarts=3, workdir=None,
                 spawn_timeout=180.0, name="serve.fleet"):
        self.spec = dict(spec)
        self.version = str(self.spec.get("version", "v0"))
        self.name = name
        self.n = int(replicas if replicas is not None
                     else get_env("MXNET_FLEET_REPLICAS", 2, typ=int))
        if self.n < 1:
            raise FleetError("fleet needs at least one replica")
        hb = (heartbeat_ms if heartbeat_ms is not None
              else get_env("MXNET_FLEET_HEARTBEAT_MS", 500.0, typ=float))
        self.heartbeat_s = float(hb) / 1e3
        self.retry_budget = int(
            retry_budget if retry_budget is not None
            else get_env("MXNET_FLEET_RETRY_BUDGET", 2, typ=int))
        dt = (drain_timeout_ms if drain_timeout_ms is not None
              else get_env("MXNET_FLEET_DRAIN_TIMEOUT_MS", 30000.0,
                           typ=float))
        self.drain_timeout_s = float(dt) / 1e3
        self.heartbeat_misses = max(1, int(heartbeat_misses))
        self.max_restarts = max(0, int(max_restarts))
        self.spawn_timeout = float(spawn_timeout)
        self._workdir = workdir or tempfile.mkdtemp(prefix="mxfleet-")
        self._lock = threading.RLock()
        self._replicas = [_Replica(i) for i in range(self.n)]
        self._started = False
        self._closing = False
        self._listener = None
        self._port = None
        self._spec_path = None
        self._rid = [0]
        self._seed_counter = [0]          # router-level sampling seeds
        self._swap_lock = threading.Lock()
        self._monitor_thread = None
        # cap on how long a dispatch may wait for SOME replica to accept
        # (covers the respawn window when every replica died at once)
        self._dispatch_wait_s = max(30.0, self.drain_timeout_s)
        self._edf = _EDFGate()
        # prefix-affinity routing: block-quantized prefix hash -> replica
        # index that last served it. Bounded LRU under self._lock; the
        # block width mirrors the engines' prefix-cache granularity so
        # the router's key equals what a replica's cache could hit on.
        self._prefix_block = max(1, get_env("MXNET_SERVE_PREFIX_BLOCK",
                                            16, typ=int))
        self._affinity = OrderedDict()
        self._affinity_cap = 1024

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        """Bind the router socket, spawn every replica, wait for hellos."""
        if self._started:
            return self
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(("127.0.0.1", 0))
        listener.listen(self.n + 2)
        with self._lock:
            self._spec_path = self._write_spec(self.spec)
            self._listener = listener
            self._port = listener.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=f"{self.name}-accept").start()
        for h in self._replicas:
            self._spawn(h, self._spec_path)
        deadline = time.perf_counter() + self.spawn_timeout
        for h in self._replicas:
            left = deadline - time.perf_counter()
            if left <= 0 or not h.ready_evt.wait(timeout=left):
                self.close()
                raise FleetError(
                    f"replica {h.index} failed to report hello within "
                    f"{self.spawn_timeout:.0f}s (see "
                    f"{self._replica_log(h.index)})")
        self._started = True
        self._monitor_thread = threading.Thread(
            target=self._monitor, daemon=True, name=f"{self.name}-monitor")
        self._monitor_thread.start()
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    def close(self, timeout=30.0):
        """Stop the fleet: orderly `stop` to every replica, then kill
        stragglers. In-flight futures fail with ServerClosed."""
        with self._lock:
            if self._closing:
                return
            self._closing = True
            handles = list(self._replicas)
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        for h in handles:
            try:
                self._send(h, {"type": "stop"})
            except OSError:
                pass
        deadline = time.perf_counter() + timeout
        for h in handles:
            if h.proc is None:
                continue
            try:
                h.proc.wait(timeout=max(0.1,
                                        deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                h.proc.kill()
                try:
                    h.proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    pass
            with self._lock:
                doomed = list(h.inflight.values())
                h.inflight.clear()
                h.state = "dead"
                if h.sock is not None:
                    try:
                        h.sock.close()
                    except OSError:
                        pass
                    h.sock = None
            for freq in doomed:
                _fail_future(freq, ServerClosed("fleet closed"))
        self._update_live()

    # -- spawning ----------------------------------------------------------
    def _write_spec(self, spec):
        os.makedirs(self._workdir, exist_ok=True)
        path = os.path.join(self._workdir,
                            f"spec_{spec.get('version', 'v0')}.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        return path

    def _replica_log(self, index):
        return os.path.join(self._workdir, f"replica{index}.log")

    def _spawn(self, h, spec_path):
        """Launch one replica child (state -> spawning). The child's env
        is inherited verbatim — MXNET_COMPILE_CACHE_DIR for the warm
        start, MXNET_METRICS_PORT for the derived metrics port."""
        with self._lock:
            h.generation += 1
            h.state = "spawning"
            h.ready_evt.clear()
            h.drained_evt.clear()
            h.hello = {}
            h.pong = {}
            h.served_since_spawn = 0
            h.missed = 0
        repo = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = repo + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH")
            else "")
        cmd = [sys.executable, "-m", "incubator_mxnet_tpu_torch.serve.replica",
               "--connect", str(self._port), "--replica", str(h.index),
               "--spec", spec_path]
        log = open(self._replica_log(h.index), "ab")
        try:
            h.proc = subprocess.Popen(cmd, env=env,
                                      stdout=log, stderr=log,
                                      stdin=subprocess.DEVNULL)
        finally:
            log.close()
        logger.info("fleet: spawned replica %d pid %d (%s)", h.index,
                    h.proc.pid, os.path.basename(spec_path))

    def _accept_loop(self):
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._handshake, args=(conn,),
                             daemon=True,
                             name=f"{self.name}-reader").start()

    def _handshake(self, conn):
        try:
            conn.settimeout(self.spawn_timeout)
            rf = conn.makefile("r", encoding="utf-8", newline="\n")
            hello = json.loads(rf.readline())
            if hello.get("type") != "hello":
                conn.close()
                return
            i = int(hello["replica"])
            if not 0 <= i < self.n:
                conn.close()
                return
        except (OSError, ValueError):
            try:
                conn.close()
            except OSError:
                pass
            return
        conn.settimeout(None)
        h = self._replicas[i]
        with self._lock:
            h.sock = conn
            h.hello = hello
            h.pid = hello.get("pid")
            h.version = hello.get("version")
            h.metrics_port = hello.get("metrics_port")
            h.last_pong = time.perf_counter()
            h.missed = 0
            h.state = "serving"
            gen = h.generation
        self._update_live()
        self._check_profile_divergence()
        logger.info("fleet: replica %d serving version %s "
                    "(pid %s, metrics port %s, warmup %.3fs, profile %s)",
                    i, h.version, h.pid, h.metrics_port,
                    hello.get("warmup_s") or 0.0,
                    hello.get("profile_hash") or "-")
        h.ready_evt.set()
        self._reader(h, rf, gen)

    # -- replica I/O -------------------------------------------------------
    def _send(self, h, msg):
        with self._lock:
            sock = h.sock
        if sock is None:
            raise OSError(f"replica {h.index} has no connection")
        data = (json.dumps(msg) + "\n").encode("utf-8")
        with h.wlock:
            sock.sendall(data)

    def _reader(self, h, rf, gen):
        try:
            for line in rf:
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue
                self._on_message(h, gen, msg)
        except OSError:
            pass
        with self._lock:
            stale = gen != h.generation
        if not stale:
            self._on_replica_down(h, gen, "connection lost")

    def _on_message(self, h, gen, msg):
        t = msg.get("type")
        if t == "pong":
            with self._lock:
                if gen != h.generation:
                    return
                h.pong = msg
                h.last_pong = time.perf_counter()
                h.missed = 0
            return
        if t == "drained":
            with _STATS_LOCK:
                FLEET_STATS["drain_ms"] += float(msg.get("drain_ms", 0.0))
            h.drained_evt.set()
            return
        if t in ("reply", "error"):
            with self._lock:
                if gen != h.generation:
                    return          # a failover already re-owns these rids
                freq = h.inflight.pop(msg.get("id"), None)
                if freq is not None and t == "reply":
                    # a served request proves the respawn healthy: reset
                    # the consecutive-restart budget and the stored death
                    # cause (PR-9 protocol)
                    h.served_since_spawn += 1
                    h.consecutive_restarts = 0
                    h.first_error = None
            if freq is None:
                return
            if t == "reply":
                self._resolve(h, freq, msg)
            else:
                self._on_wire_error(h, freq, msg)

    def _resolve(self, h, freq, msg):
        toks = _np.asarray(msg.get("tokens", []), dtype=_np.int32)
        if freq.future.set_running_or_notify_cancel():
            freq.future.set_result(toks)
        if freq.ctx is not None and _trace._profiler_running():
            now = time.perf_counter()
            record_span("fleet.request", (now - freq.t_submit) * 1e6,
                        ts_us=freq.t_submit * 1e6, cat="fleet",
                        ctx=freq.ctx, replica=h.index,
                        attempts=freq.attempts + 1, tokens=int(toks.size))

    def _on_wire_error(self, h, freq, msg):
        kind = msg.get("kind", "ServeError")
        text = msg.get("message", "")
        if kind == "ReplicaDraining":
            # the routed-around drain signal: silent re-dispatch, never
            # client-visible, never billed against the retry budget
            freq.reroutes += 1
            if freq.reroutes > self.n + self.retry_budget + 2:
                _fail_future(freq, FleetError(
                    f"no admitting replica after {freq.reroutes} "
                    f"re-routes (fleet draining?)"))
                return
            self._async_dispatch([freq])
            return
        err = _WIRE_ERRORS.get(kind, ServeError)(
            f"replica {h.index}: {text}")
        _fail_future(freq, err)

    # -- submission / dispatch --------------------------------------------
    def submit(self, prompt_tokens, max_new_tokens=16, deadline_ms=None,
               temperature=0.0, top_k=0, top_p=1.0, seed=None):
        """Enqueue one generation request onto the fleet; returns a
        Future of the generated np.int32 token ids. Sampling params pass
        through to the replica engine; a sampled request without a seed
        gets a ROUTER-assigned one, so a failover re-dispatch replays
        the exact same draw sequence on the surviving replica."""
        if not self._started:
            raise FleetError("Fleet.start() (or `with fleet:`) first")
        if self._closing:
            raise ServerClosed("fleet is closed")
        prompt = _np.asarray(prompt_tokens, dtype=_np.int32).ravel()
        if prompt.size < 1:
            raise ServeError("prompt must have at least one token")
        if max_new_tokens < 1:
            raise ServeError("max_new_tokens must be >= 1")
        temperature = float(temperature)
        if temperature < 0.0:
            raise ServeError("temperature must be >= 0")
        if not 0.0 < float(top_p) <= 1.0:
            raise ServeError(f"top_p must be in (0, 1], got {top_p}")
        sampling = {}
        if temperature > 0.0:
            sampling["temperature"] = temperature
            if int(top_k):
                sampling["top_k"] = int(top_k)
            if float(top_p) != 1.0:
                sampling["top_p"] = float(top_p)
            if seed is None:
                with self._lock:
                    seed = self._seed_counter[0]
                    self._seed_counter[0] += 1
            sampling["seed"] = int(seed)
        ctx = _trace.request_root("fleet.request")
        with self._lock:
            self._rid[0] += 1
            rid = self._rid[0]
        deadline_at = (time.perf_counter() + deadline_ms / 1e3
                       if deadline_ms is not None else None)
        # affinity key: hash of the longest block-quantized prefix a
        # replica's cache could actually hit on ((plen-1)//block blocks —
        # one suffix token must remain to prefill). None = too short.
        nblocks = (int(prompt.size) - 1) // self._prefix_block
        phash = (_rolling_hash(prompt[:nblocks * self._prefix_block])
                 if nblocks >= 1 else None)
        freq = _FleetRequest(rid, prompt, int(max_new_tokens),
                             deadline_at, sampling=sampling,
                             prefix_hash=phash, ctx=ctx)
        self._dispatch(freq)
        return freq.future

    def generate(self, prompt_tokens, max_new_tokens=16, timeout=None,
                 deadline_ms=None, temperature=0.0, top_k=0, top_p=1.0,
                 seed=None):
        """submit() + wait."""
        return self.submit(prompt_tokens, max_new_tokens,
                           deadline_ms=deadline_ms,
                           temperature=temperature, top_k=top_k,
                           top_p=top_p, seed=seed).result(timeout=timeout)

    def _pick(self, exclude=(), prefer=None):
        """Least-loaded SERVING replica: router-side in-flight count,
        then replica-reported queue depth, then lowest index. `prefer`
        (the prefix-affinity target) wins outright when it is among the
        healthy candidates — affinity beats load balance because a row
        copy from a warm prefix cache is cheaper than any prefill."""
        with self._lock:
            cands = [h for h in self._replicas
                     if h.state == "serving" and h.sock is not None
                     and h.index not in exclude]
            if not cands:
                return None
            if prefer is not None:
                for h in cands:
                    if h.index == prefer:
                        return h
            return min(cands, key=lambda h: (
                len(h.inflight),
                h.pong.get("waiting", 0) + h.pong.get("running", 0),
                h.index))

    def _dispatch(self, freq, exclude=()):
        """Place one request (dispatch, or re-dispatch after failover /
        drain re-route), EDF-gated: among requests concurrently waiting
        to claim a replica, the tightest deadline claims first. Retries
        alternate replicas under the budget."""
        self._edf.enter(freq)
        try:
            self._dispatch_inner(freq, exclude)
        finally:
            self._edf.leave(freq)

    def _dispatch_inner(self, freq, exclude=()):
        exclude = set(exclude)
        wait_deadline = time.perf_counter() + self._dispatch_wait_s
        while True:
            if freq.future.done():
                return
            remaining_ms = None
            if freq.deadline_at is not None:
                left = freq.deadline_at - time.perf_counter()
                if left <= 0:
                    _fail_future(freq, RequestTimeout(
                        f"deadline expired after "
                        f"{(time.perf_counter() - freq.t_submit) * 1e3:.1f}"
                        f"ms before a replica accepted the request"))
                    return
                remaining_ms = max(1.0, left * 1e3)
            if not self._edf.wait_turn(freq):
                continue            # not the tightest deadline waiting
            prefer = None
            if freq.prefix_hash is not None:
                with self._lock:
                    prefer = self._affinity.get(freq.prefix_hash)
            h = self._pick(exclude, prefer=prefer)
            if h is None:
                if exclude:
                    exclude = set()     # wrap around before giving up
                    continue
                if self._closing or not self._respawn_possible():
                    _fail_future(freq, self._terminal_error())
                    return
                if time.perf_counter() > wait_deadline:
                    _fail_future(freq, FleetError(
                        f"no serving replica within "
                        f"{self._dispatch_wait_s:.0f}s"))
                    return
                time.sleep(0.02)        # a respawn/drain window; re-check
                continue
            try:
                _fault.inject("fleet.dispatch")
                msg = {"type": "request", "id": freq.rid,
                       "prompt": freq.prompt.tolist(),
                       "max_new": freq.max_new}
                msg.update(freq.sampling)
                if freq.ctx is not None:
                    msg["trace"] = freq.ctx.to_dict()
                if remaining_ms is not None:
                    msg["deadline_ms"] = remaining_ms
                with self._lock:
                    if h.state != "serving" or h.sock is None:
                        continue
                    h.inflight[freq.rid] = freq
                    freq.replica = h.index
                self._send(h, msg)
                if freq.prefix_hash is not None:
                    with self._lock:
                        self._affinity[freq.prefix_hash] = h.index
                        self._affinity.move_to_end(freq.prefix_hash)
                        while len(self._affinity) > self._affinity_cap:
                            self._affinity.popitem(last=False)
                    if prefer == h.index:
                        with _STATS_LOCK:
                            FLEET_STATS["affinity_hits"] += 1
                return
            except (OSError, MXNetError, TimeoutError) as e:
                with self._lock:
                    h.inflight.pop(freq.rid, None)
                if not self._count_retry(freq, e, where="fleet.dispatch"):
                    return
                exclude.add(h.index)
                if len(exclude) >= self.n:
                    exclude = set()

    def _async_dispatch(self, freqs):
        """(Re-)dispatch off the calling thread — reader and monitor
        threads must never block in the dispatch wait loop."""
        freqs = sorted(freqs, key=_FleetRequest.sort_key)   # EDF order

        def run():
            for freq in freqs:
                exclude = ({freq.replica} if freq.replica is not None
                           else set())
                self._dispatch(freq, exclude=exclude)
        threading.Thread(target=run, daemon=True,
                         name=f"{self.name}-redispatch").start()

    def _count_retry(self, freq, err, where):
        """`fault.retrying` semantics for the router: bounded attempts
        with structured fault-logger records; the ORIGINAL error surfaces
        when the budget is spent. Returns True when a retry is allowed."""
        freq.attempts += 1
        if freq.first_error is None:
            freq.first_error = err
        if freq.attempts > self.retry_budget:
            _log_event("fault.retry_exhausted", point=where,
                       attempts=freq.attempts,
                       error=repr(freq.first_error))
            _fail_future(freq, ReplicaDied(
                f"request failed after {freq.attempts} attempt(s); "
                f"original error: {freq.first_error}",
                replica=freq.replica, cause=freq.first_error))
            return False
        with _STATS_LOCK:
            FLEET_STATS["retries"] += 1
        _log_event("fault.retry", point=where, attempt=freq.attempts,
                   error=repr(err), sleep=0)
        return True

    def _respawn_possible(self):
        with self._lock:
            return any(h.state in ("spawning", "serving", "draining",
                                   "dead")
                       for h in self._replicas)

    def _terminal_error(self):
        with self._lock:
            causes = {h.index: repr(h.first_error)
                      for h in self._replicas if h.first_error is not None}
        return FleetError(
            f"no replica can serve (all failed); original errors: "
            f"{causes or 'none recorded'}")

    # -- failure detection / failover / respawn ---------------------------
    def _on_replica_down(self, h, gen, reason):
        """Single funnel for replica death: socket EOF, process exit, or
        missed heartbeats. Idempotent per generation."""
        with self._lock:
            if gen != h.generation or h.state in ("dead", "failed"):
                return
            h.generation += 1          # invalidate reader + late reports
            h.state = "dead"
            sock, h.sock = h.sock, None
            swap_exit = h.swap_pending
            doomed = list(h.inflight.values())
            h.inflight.clear()
            cause = ReplicaDied(f"replica {h.index} {reason}",
                                replica=h.index)
            if h.first_error is None:
                h.first_error = cause
        self._update_live()
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        if self._closing:
            for freq in doomed:
                _fail_future(freq, ServerClosed("fleet closed"))
            return
        logger.warning("fleet: replica %d down (%s), %d in-flight",
                       h.index, reason, len(doomed))
        _log_event("fleet.replica_down", replica=h.index, reason=reason,
                   inflight=len(doomed), swap=swap_exit)
        if doomed:
            with _STATS_LOCK:
                FLEET_STATS["failovers"] += 1
            # every failover hop bills the retry budget; requests past it
            # surface the ORIGINAL death error (fault.retrying semantics)
            retryable = [freq for freq in doomed
                         if self._count_retry(freq, cause,
                                              where="fleet.failover")]
            if retryable:
                self._async_dispatch(retryable)
        if not swap_exit:
            threading.Thread(target=self._respawn, args=(h,),
                             daemon=True,
                             name=f"{self.name}-respawn").start()

    def _respawn(self, h):
        """Warm respawn with the PR-9 bounded-consecutive-restarts
        protocol. Runs on its own thread, outside every lock."""
        while not self._closing:
            with self._lock:
                h.consecutive_restarts += 1
                n = h.consecutive_restarts
            if n > self.max_restarts:
                with self._lock:
                    h.state = "failed"
                logger.error(
                    "fleet: replica %d exceeded %d consecutive restarts; "
                    "marking failed. Original error: %r", h.index,
                    self.max_restarts, h.first_error)
                _log_event("fleet.restart_exhausted", replica=h.index,
                           restarts=n - 1, error=repr(h.first_error))
                return
            try:
                _fault.inject("fleet.respawn")
            except Exception as e:
                logger.warning("fleet: respawn of replica %d failed "
                               "(attempt %d): %s", h.index, n, e)
                continue
            with _STATS_LOCK:
                FLEET_STATS["respawns"] += 1
            try:
                self._spawn(h, self._spec_path)
            except OSError as e:
                with self._lock:
                    if h.first_error is None:
                        h.first_error = e
                continue
            if h.ready_evt.wait(timeout=self.spawn_timeout):
                return
            # never said hello: kill and bill another consecutive restart
            if h.proc is not None:
                h.proc.kill()
            with self._lock:
                h.state = "dead"
                h.generation += 1

    def _monitor(self):
        """Liveness + heartbeat sweep. Process-exit polling catches idle
        deaths within one beat; missed pongs catch hangs."""
        seq = 0
        while not self._closing:
            time.sleep(self.heartbeat_s)
            if self._closing:
                return
            seq += 1
            for h in list(self._replicas):
                with self._lock:
                    state, gen = h.state, h.generation
                if state in ("failed", "dead", "spawning"):
                    continue
                proc = h.proc
                if proc is not None and proc.poll() is not None:
                    self._on_replica_down(
                        h, gen, f"process exited rc={proc.returncode}")
                    continue
                if state != "serving":
                    continue            # draining: drain path owns it
                try:
                    _fault.inject("fleet.heartbeat")
                    self._send(h, {"type": "ping", "seq": seq})
                    age = time.perf_counter() - h.last_pong
                    if age > self.heartbeat_s * 1.5:
                        h.missed += 1
                    else:
                        h.missed = 0
                except (OSError, MXNetError, TimeoutError) as e:
                    h.missed += 1
                    logger.warning(
                        "fleet: heartbeat to replica %d failed "
                        "(miss %d/%d): %s", h.index, h.missed,
                        self.heartbeat_misses, e)
                if h.missed >= self.heartbeat_misses:
                    logger.warning(
                        "fleet: replica %d missed %d heartbeats; "
                        "declaring hung", h.index, h.missed)
                    if h.proc is not None:
                        h.proc.kill()
                    self._on_replica_down(
                        h, gen,
                        f"missed {h.missed} heartbeats (hang/SIGSTOP)")

    # -- drain-and-swap ----------------------------------------------------
    def swap(self, spec=None, version=None):
        """Rolling zero-downtime upgrade: drain-and-swap every replica
        onto a new version-pinned spec, one at a time, routing traffic
        around the draining replica. Zero dropped requests: resident
        requests finish before the restart; a drain-timeout hard-stop
        hands its leftovers to the failover path."""
        if spec is None:
            if version is None:
                raise FleetError("swap() needs a spec or a version")
            spec = dict(self.spec, version=version)
        spec = dict(spec)
        new_version = str(spec.get("version", "v0"))
        if not self._started:
            raise FleetError("Fleet.start() first")
        with self._swap_lock:
            path = self._write_spec(spec)
            # new spec becomes the respawn target immediately: a replica
            # that dies mid-swap already comes back on the new version
            with self._lock:
                self._spec_path = path
            t_swap = time.perf_counter()
            for h in list(self._replicas):
                with self._lock:
                    state = h.state
                if state == "failed":
                    continue
                try:
                    _fault.inject("fleet.swap")
                except Exception as e:
                    raise FleetError(
                        f"swap to {new_version!r} aborted at replica "
                        f"{h.index}: {e}") from e
                self._swap_one(h, path, new_version)
            self.spec = spec
            self.version = new_version
            with _STATS_LOCK:
                FLEET_STATS["swaps"] += 1
            logger.info("fleet: rolling swap to version %s complete "
                        "(%.1fms)", new_version,
                        (time.perf_counter() - t_swap) * 1e3)

    def _swap_one(self, h, spec_path, new_version):
        with self._lock:
            if h.state != "serving":
                return                  # death path already respawns new
            h.state = "draining"
            h.swap_pending = True
            h.drained_evt.clear()
            gen = h.generation
        self._update_live()
        try:
            self._send(h, {"type": "drain",
                           "timeout_ms": self.drain_timeout_s * 1e3})
        except OSError:
            pass                        # died mid-send; down path runs
        if not h.drained_evt.wait(timeout=self.drain_timeout_s + 5.0):
            logger.warning("fleet: replica %d drain timed out; "
                           "hard-stopping (failover absorbs leftovers)",
                           h.index)
            if h.proc is not None:
                h.proc.kill()
        proc = h.proc
        if proc is not None:
            try:
                proc.wait(timeout=30.0)
            except subprocess.TimeoutExpired:
                proc.kill()
        # the child's exit lands in _on_replica_down (reader EOF or the
        # monitor's poll) which, seeing swap_pending, fails over any
        # leftovers but leaves the respawn to us
        t0 = time.perf_counter()
        while True:
            with self._lock:
                if h.state in ("dead", "failed"):
                    break
            if time.perf_counter() - t0 > 30.0:
                self._on_replica_down(h, gen, "drain exit not observed")
                break
            time.sleep(0.01)
        with self._lock:
            h.swap_pending = False
            h.consecutive_restarts = 0
            h.first_error = None
        self._spawn(h, spec_path)
        if not h.ready_evt.wait(timeout=self.spawn_timeout):
            raise FleetError(
                f"replica {h.index} failed to come back on version "
                f"{new_version!r} within {self.spawn_timeout:.0f}s")

    # -- introspection -----------------------------------------------------
    def _update_live(self):
        with self._lock:
            live = sum(1 for h in self._replicas if h.state == "serving")
        with _STATS_LOCK:
            FLEET_STATS["replicas_live"] = live

    def stats(self):
        """Plain-data snapshot: per-replica state + the fleet counters."""
        with self._lock:
            reps = [{
                "replica": h.index, "state": h.state, "pid": h.pid,
                "version": h.version, "metrics_port": h.metrics_port,
                "inflight": len(h.inflight),
                "consecutive_restarts": h.consecutive_restarts,
                "warmup_s": h.hello.get("warmup_s"),
                "profile_hash": h.hello.get("profile_hash"),
                "prefix_hits": h.pong.get("prefix_hits"),
            } for h in self._replicas]
        out = {"version": self.version, "replicas": reps}
        out.update(fleet_stats())
        return out

    def _check_profile_divergence(self):
        """A fleet must be homogeneously tuned: every serving replica's
        hello-reported deployment-profile hash should agree (None =
        untuned, which is homogeneous too). More than one distinct hash
        means some replica found a different — or stale — profile on
        disk; bill `fleet.profile_divergence` and log the structured
        event so operators see it the moment the odd replica hellos."""
        with self._lock:
            hashes = sorted({h.hello.get("profile_hash")
                             for h in self._replicas
                             if h.state == "serving"
                             and h.hello.get("profile_hash")})
        if len(hashes) > 1:
            with _STATS_LOCK:
                FLEET_STATS["profile_divergence"] += 1
            _log_event("fleet.profile_divergence", hashes=hashes)
            return True
        return False

    def retraces_after_warmup(self):
        """The compile surface of the JAX fleet: the port's engines compile
        no programs yet (ROADMAP A3)."""
        raise MXNetError("Fleet.retraces_after_warmup: the compile "
                         "surface is not ported yet (ROADMAP A3)")

    def assert_no_retraces(self):
        """The compile surface of the JAX fleet (ROADMAP A3)."""
        raise MXNetError("Fleet.assert_no_retraces: the compile surface "
                         "is not ported yet (ROADMAP A3)")


def _fail_future(freq, exc):
    if freq.future.set_running_or_notify_cancel():
        freq.future.set_exception(exc)
