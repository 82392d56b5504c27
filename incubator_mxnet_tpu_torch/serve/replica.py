"""serve.replica of the PyTorch port — one fleet worker process.

Counterpart of `incubator_mxnet_tpu/serve/replica.py`. `serve.Fleet`
spawns it as

    python -m incubator_mxnet_tpu_torch.serve.replica \\
        --connect <router-port> --replica <index> --spec <spec.json>

and it speaks newline-delimited JSON to the router over a localhost TCP
socket. The spec file is the version-pinned model manifest: `config` (a
`DecoderConfig`), `seed`, `version`, `engine` (ContinuousEngine knobs) and
`device` (default "cuda"; without a card the replica fails to start, it
never serves on the CPU unless the spec says "cpu"); `stub: true` selects
a torch-free stand-in engine for protocol tests.

Protocol (replica -> router unless noted), the JAX package's:

  hello      first message: replica index, pid, version, the bound
             /metrics port, warmup_s, profile_hash
  request    (router ->) prompt / max_new / deadline_ms / sampling;
             answered by exactly one `reply` or `error`
  reply      generated token ids (+ serving version)
  error      typed failure (`kind` is the exception class name);
             kind=ReplicaDraining is the routed-around drain signal
  ping/pong  (router ->) / (replica ->) heartbeat; pong carries the queue
             depth (the least-loaded routing signal), the draining flag
             and the prefix-cache hits
  drain      (router ->) stop admitting, finish resident requests,
             answer `drained`, exit 0
  stop       (router ->) hard close and exit

On drain or stop the replica logs its kernel launches
(`ops.kernels.launch_counts_by_dtype()`) as one line,
`replica <i> launches <json>`, in its log (launch counters are per
process). The metrics port is `MXNET_METRICS_PORT + replica index`. The
compile counters of the JAX protocol (`compile_cache_size`, `retraces`)
are null: the port's engine compiles nothing (ROADMAP A3).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import socket
import sys
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as _np

from ..base import get_env
from ..telemetry import trace as _trace
from .batcher import ReplicaDraining, ServerClosed

logger = logging.getLogger("mx.serve.fleet")

__all__ = ["main", "derive_metrics_port"]


def derive_metrics_port(base, replica_index):
    """Per-replica /metrics port: base + replica index (None when no base
    is configured); the hello carries the port actually bound."""
    if not base:
        return None
    return int(base) + int(replica_index)


def _start_metrics(replica_index):
    """Bind this replica's derived metrics port; returns the bound port
    (None when MXNET_METRICS_PORT is unset or the port is taken)."""
    from .metrics import ensure_metrics_server
    base = get_env("MXNET_METRICS_PORT", typ=int)
    port = derive_metrics_port(base, replica_index)
    if port is None:
        return None
    try:
        srv = ensure_metrics_server(port)
    except OSError as e:
        logger.warning("replica %d: metrics port %d unavailable: %s",
                       replica_index, port, e)
        return None
    bound = srv.server_address[1]
    logger.info("replica %d: serving /metrics on port %d "
                "(MXNET_METRICS_PORT base %s + replica index %d)",
                replica_index, bound, base, replica_index)
    return bound


class _StubEngine:
    """Stand-in engine for fleet protocol tests: resolves each request
    after a fixed delay with a deterministic token pattern of (prompt,
    version). The ContinuousEngine surface the replica loop touches."""

    def __init__(self, spec):
        self.version = str(spec.get("version", "v0"))
        self._delay_s = float(spec.get("stub_delay_ms", 5.0)) / 1e3
        self.warmup_s = 0.0
        self._vtag = sum(self.version.encode()) % 997
        self._cv = threading.Condition()
        self._q = deque()
        self._closing = False
        self._drain = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="stub-engine")
        self._thread.start()

    def prefix_hit_count(self):
        return 0

    @property
    def draining(self):
        return self._closing and self._drain and self._thread.is_alive()

    def queue_depth(self):
        with self._cv:
            return len(self._q), 0

    def submit(self, prompt_tokens, max_new_tokens=16, deadline_ms=None,
               **sampling):
        prompt = _np.asarray(prompt_tokens, dtype=_np.int64).ravel()
        fut = Future()
        with self._cv:
            if self._closing:
                if self._drain and self._thread.is_alive():
                    raise ReplicaDraining("stub engine is draining")
                raise ServerClosed("stub engine is closed")
            self._q.append((time.perf_counter() + self._delay_s,
                            prompt, int(max_new_tokens), fut))
            self._cv.notify()
        return fut

    def _loop(self):
        while True:
            with self._cv:
                while not self._q and not self._closing:
                    self._cv.wait()
                if not self._q and self._closing:
                    return
                due, prompt, max_new, fut = self._q.popleft()
            delay = due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            base = int(prompt.sum()) % 997
            toks = _np.asarray(
                [(base * 31 + i + self._vtag) % 97 for i in range(max_new)],
                dtype=_np.int32)
            if fut.set_running_or_notify_cancel():
                fut.set_result(toks)

    def begin_drain(self):
        with self._cv:
            self._closing = True
            self._drain = True
            self._cv.notify_all()

    def close(self, drain=True, timeout=30.0):
        with self._cv:
            self._closing = True
            self._drain = drain
            pending = [] if drain else list(self._q)
            if not drain:
                self._q.clear()
            self._cv.notify_all()
        for _, _, _, fut in pending:
            if fut.set_running_or_notify_cancel():
                fut.set_exception(
                    ServerClosed("stub engine closed before completion"))
        self._thread.join(timeout=timeout)


def _resolve_profile(spec):
    """Activate the deployment profile for this replica's model, if one
    exists: explicit `spec["profile"]` path > ``MXNET_TUNE_PROFILE`` >
    lookup by (model, hardware) fingerprint under the profile dir.
    Returns the applied profile hash (reported in the hello so the Fleet
    can detect divergent tunings) or None — a mismatched or corrupt
    profile falls back loudly inside tune.profile and the replica boots
    on env/defaults; tuning must never keep a replica down. A stub passes
    its declared `profile_hash` through."""
    if spec.get("stub"):
        return spec.get("profile_hash")
    try:
        from ..tune import profile as _tprof
        model_fp = _tprof.model_fingerprint(spec.get("config", {}))
        path = spec.get("profile") or os.environ.get("MXNET_TUNE_PROFILE")
        if path:
            prof = _tprof.DeploymentProfile.load(path)
        else:
            prof = _tprof.lookup(model_fp)
        if prof is not None and _tprof.activate(prof, model_fp=model_fp,
                                                source="replica"):
            return prof.profile_hash
    except Exception as e:  # noqa: BLE001 — boot anyway, on defaults
        logger.warning("deployment profile unavailable (%s); replica "
                       "starts on env/defaults", e)
    return None


def _build_engine(spec):
    """Engine from a version-pinned spec: the stub, or a CachedDecoder +
    ContinuousEngine on the spec's device (default: the card)."""
    if spec.get("stub"):
        return _StubEngine(spec)
    from .continuous import (CachedDecoder, ContinuousEngine,
                             DecoderConfig)
    cfg = DecoderConfig(**spec.get("config", {}))
    model = CachedDecoder(cfg, seed=int(spec.get("seed", 0)),
                          device=spec.get("device", "cuda"))
    eng = ContinuousEngine(model, **spec.get("engine", {}))
    eng.start()
    return eng


def _log_launches(replica):
    """One log line of this process's kernel launches by (kernel, type)."""
    from ..ops import kernels
    counts = {f"{k}:{d}": n
              for (k, d), n in sorted(kernels.launch_counts_by_dtype()
                                      .items())}
    logger.info("replica %d launches %s", replica, json.dumps(counts))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="serve.replica")
    ap.add_argument("--connect", type=int, required=True,
                    help="router listen port on 127.0.0.1")
    ap.add_argument("--replica", type=int, required=True)
    ap.add_argument("--spec", required=True,
                    help="version-pinned model spec JSON path")
    args = ap.parse_args(argv)
    logging.basicConfig(
        stream=sys.stderr, level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    with open(args.spec) as f:
        spec = json.load(f)
    version = str(spec.get("version", "v0"))

    metrics_port = _start_metrics(args.replica)
    profile_hash = _resolve_profile(spec)
    eng = _build_engine(spec)

    sock = socket.create_connection(("127.0.0.1", args.connect),
                                    timeout=60)
    sock.settimeout(None)
    rfile = sock.makefile("r", encoding="utf-8", newline="\n")
    wlock = threading.Lock()

    def send(msg):
        data = (json.dumps(msg) + "\n").encode("utf-8")
        try:
            with wlock:
                sock.sendall(data)
        except OSError:
            pass            # router gone; the reader loop will see EOF

    send({"type": "hello", "replica": args.replica, "pid": os.getpid(),
          "version": version, "metrics_port": metrics_port,
          "warmup_s": eng.warmup_s, "compile_cache_size": None,
          "profile_hash": profile_hash})

    drain_started = threading.Event()
    done = threading.Event()

    def _finish_drain(timeout_s):
        t0 = time.perf_counter()
        eng.close(drain=True, timeout=timeout_s)
        _log_launches(args.replica)
        send({"type": "drained", "replica": args.replica,
              "version": version,
              "drain_ms": round((time.perf_counter() - t0) * 1e3, 3)})
        done.set()
        # the router's reader sees EOF after `drained`
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def _on_done(rid, fut):
        try:
            toks = fut.result()
        except Exception as e:  # typed serve errors and unexpected alike
            send({"type": "error", "id": rid,
                  "kind": type(e).__name__, "message": str(e)})
        else:
            send({"type": "reply", "id": rid, "version": version,
                  "tokens": [int(t) for t in toks]})

    for line in rfile:
        try:
            msg = json.loads(line)
        except ValueError:
            continue
        t = msg.get("type")
        if t == "request":
            rid = msg.get("id")
            # rejoin the router's trace: the engine's serve.request root,
            # minted inside submit(), becomes a child of fleet.request
            ctx = _trace.TraceContext.from_dict(msg.get("trace") or {})
            token = _trace.attach(ctx) if ctx is not None else None
            sampling = {k: msg[k]
                        for k in ("temperature", "top_k", "top_p", "seed")
                        if k in msg}
            try:
                fut = eng.submit(msg.get("prompt"),
                                 msg.get("max_new", 16),
                                 deadline_ms=msg.get("deadline_ms"),
                                 **sampling)
            except Exception as e:
                send({"type": "error", "id": rid,
                      "kind": type(e).__name__, "message": str(e)})
            else:
                fut.add_done_callback(
                    lambda f, rid=rid: _on_done(rid, f))
            finally:
                if token is not None:
                    _trace.detach(token)
        elif t == "ping":
            waiting, running = eng.queue_depth()
            send({"type": "pong", "seq": msg.get("seq"),
                  "replica": args.replica, "version": version,
                  "waiting": waiting, "running": running,
                  "draining": bool(getattr(eng, "draining", False)),
                  "retraces": None, "compile_cache_size": None,
                  "prefix_hits": eng.prefix_hit_count()})
        elif t == "drain":
            if not drain_started.is_set():
                drain_started.set()
                eng.begin_drain()
                timeout_s = float(msg.get("timeout_ms", 30000.0)) / 1e3
                threading.Thread(target=_finish_drain,
                                 args=(timeout_s,), daemon=True,
                                 name="replica-drain").start()
        elif t == "stop":
            break

    if drain_started.is_set():
        done.wait(timeout=5.0)
        return 0
    try:
        eng.close(drain=False, timeout=5.0)
    finally:
        _log_launches(args.replica)
    return 0


if __name__ == "__main__":
    sys.exit(main())
