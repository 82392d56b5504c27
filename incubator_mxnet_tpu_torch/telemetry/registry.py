"""mx.telemetry registry of the PyTorch port: one process-wide metrics
surface.

Counterpart of `incubator_mxnet_tpu/telemetry/registry.py`, kept as the
port's own copy (the port imports nothing of the JAX package). Typed
`Counter` / `Gauge` / `Histogram` metrics with labels, one lock
discipline, one `snapshot(reset=...)`, and JSON and Prometheus-text
exposition; for the same observations the text is the JAX package's,
byte for byte (names, labels, bucket edges, `_fmt`'s number format).

Two metric tiers:

  * `Counter`/`Gauge`/`Histogram` objects, registered by name and mutated
    under the one registry lock: everything off the per-op hot path
    (spans, serving, step timelines, memory).
  * `StatsGroup`, a dict subclass that adopts a module's counter dict
    (`serve`, `feed`, `io.imagerec`, `dispatch`, `fused`, ...) without
    changing its hot path: `d[k] += 1` stays a plain dict write under the
    owner's lock (or the GIL where the owner documents it lock-free). The
    group adds an atomic `snapshot(reset=...)` and registry membership,
    so `telemetry.snapshot()` and `prometheus_text()` see every counter
    of the process.

Lock discipline: `Registry._lock` guards registration, object-metric
mutation and snapshot assembly. A group's snapshot/reset takes its owner
lock, never the registry lock, so the only cross-lock order is
registry -> group.

This module imports neither torch nor numpy.
"""
from __future__ import annotations

import json as _json
import math as _math
import threading

__all__ = ["Counter", "Gauge", "Histogram", "StatsGroup", "Registry",
           "REGISTRY", "counter", "gauge", "histogram", "stats_group",
           "snapshot", "snapshot_json", "prometheus_text",
           "DEFAULT_BUCKETS"]

# histogram upper bounds, microsecond-oriented (span durations): 1us..10s
DEFAULT_BUCKETS = (1.0, 10.0, 100.0, 1e3, 1e4, 1e5, 1e6, 1e7)


def _prom_name(name):
    """`serve.batch.duration_us` -> `mx_serve_batch_duration_us`."""
    return "mx_" + name.replace(".", "_")


def _prom_label_value(v):
    """Escape a label value per the 0.0.4 exposition spec: backslash,
    double-quote, and newline — one malformed value must not invalidate
    the whole scrape."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _prom_labels(labels, values):
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_prom_label_value(v)}"'
                     for k, v in zip(labels, values))
    return "{" + inner + "}"


class _Metric:
    """Base: a named metric family with optional label dimensions."""

    kind = "untyped"

    def __init__(self, name, help="", labels=(), _registry=None):
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self._registry = _registry
        self._children = {}      # label-value tuple -> child state

    def _lock(self):
        return self._registry._lock

    def labels(self, **kv):
        """Bound view for one label-value combination."""
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"metric {self.name} has labels {self.label_names}, "
                f"got {tuple(kv)}")
        key = tuple(str(kv[k]) for k in self.label_names)
        return _Bound(self, key)

    def _slot(self, key):
        slot = self._children.get(key)
        if slot is None:
            slot = self._children[key] = self._new_slot()
        return slot


class _Bound:
    """A metric bound to concrete label values; proxies the mutators."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric, key):
        self._metric = metric
        self._key = key

    def inc(self, n=1):
        self._metric._inc(self._key, n)

    def dec(self, n=1):
        self._metric._inc(self._key, -n)

    def set(self, v):
        self._metric._set(self._key, v)

    def observe(self, v):
        self._metric._observe(self._key, v)

    def get(self):
        return self._metric._get(self._key)


class Counter(_Metric):
    """Monotonically increasing count. `inc(n)` with n >= 0."""

    kind = "counter"

    def _new_slot(self):
        return [0.0]

    def _inc(self, key, n=1):
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock():
            self._slot(key)[0] += n

    def _get(self, key):
        with self._lock():
            return self._slot(key)[0]

    def inc(self, n=1):
        self._inc((), n)

    def get(self):
        return self._get(())


class Gauge(_Metric):
    """Point-in-time value; survives `snapshot(reset=True)` (a reset
    zeroes flows, not levels)."""

    kind = "gauge"

    def _new_slot(self):
        return [0.0]

    def _inc(self, key, n=1):
        with self._lock():
            self._slot(key)[0] += n

    def _set(self, key, v):
        with self._lock():
            self._slot(key)[0] = float(v)

    def _get(self, key):
        with self._lock():
            return self._slot(key)[0]

    def inc(self, n=1):
        self._inc((), n)

    def dec(self, n=1):
        self._inc((), -n)

    def set(self, v):
        self._set((), v)

    def get(self):
        return self._get(())


class Histogram(_Metric):
    """Distribution over fixed upper-bound buckets (+Inf implicit):
    per-bucket cumulative counts, sum, count, min, max."""

    kind = "histogram"

    def __init__(self, name, help="", labels=(), buckets=DEFAULT_BUCKETS,
                 _registry=None):
        super().__init__(name, help, labels, _registry=_registry)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def _new_slot(self):
        # [bucket_counts..., +Inf], count, sum, min, max
        return {"buckets": [0] * (len(self.buckets) + 1),
                "count": 0, "sum": 0.0,
                "min": float("inf"), "max": float("-inf")}

    def _observe(self, key, v):
        v = float(v)
        with self._lock():
            s = self._slot(key)
            i = len(self.buckets)
            for j, ub in enumerate(self.buckets):
                if v <= ub:
                    i = j
                    break
            s["buckets"][i] += 1
            s["count"] += 1
            s["sum"] += v
            if v < s["min"]:
                s["min"] = v
            if v > s["max"]:
                s["max"] = v

    def observe(self, v):
        self._observe((), v)

    def _get(self, key):
        with self._lock():
            s = self._slot(key)
            return dict(s, buckets=list(s["buckets"]))

    def get(self):
        return self._get(())


class StatsGroup(dict):
    """A legacy `*_STATS` counter dict adopted into the registry.

    Subclasses dict and overrides NOTHING on the read/write path, so the
    owning module's hot-path contract (`d[k] += 1` under its own lock, or
    lock-free under the GIL where documented) is unchanged to the byte.
    Adds atomic `snapshot(reset=...)` (the owner-lock-guarded copy+zero the
    three bespoke `*_stats()` functions used to hand-roll) and registry
    membership: the group's keys surface in `telemetry.snapshot()` as
    `<family>.<key>` and in Prometheus text as `mx_<family>_<key>`.

    Reset restores each value to `type(value)()` — ints to 0, floats to
    0.0 — preserving the per-key numeric type like the originals did.
    """

    def __init__(self, family, initial, lock=None, help=""):
        super().__init__(initial)
        self.family = family
        self.help = help
        # lock=None: mutation relies on the GIL (owner documents why);
        # snapshot still needs SOME mutual exclusion against reset, so a
        # private lock guards the snapshot+zero step either way.
        self._owner_lock = lock if lock is not None else threading.Lock()
        self._initial_types = {k: type(v) for k, v in initial.items()}

    def snapshot(self, reset=False):
        """Atomic copy (and optional zero) under the owner lock: no
        increment is ever lost between the copy and the reset."""
        with self._owner_lock:
            snap = dict(self)
            if reset:
                for k in self:
                    self[k] = self._initial_types.get(k, int)()
        return snap


class Registry:
    """Name -> metric. get-or-create constructors are type-checked: asking
    for an existing name with a different kind/labels is a bug, not a
    silent second family."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics = {}        # name -> _Metric
        self._groups = {}         # family -> StatsGroup

    # -- registration ---------------------------------------------------
    def _get_or_create(self, cls, name, help, labels, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(m).__name__}{m.label_names}")
                return m
            m = cls(name, help=help, labels=labels, _registry=self, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labels=()):
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name, help="", labels=()):
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=(), buckets=DEFAULT_BUCKETS):
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def stats_group(self, family, initial, lock=None, help=""):
        """Adopt (or return the already-adopted) legacy counter dict."""
        with self._lock:
            g = self._groups.get(family)
            if g is not None:
                return g
            g = StatsGroup(family, initial, lock=lock, help=help)
            self._groups[family] = g
            return g

    def names(self):
        """Every registered metric name, object metrics and group keys."""
        with self._lock:
            out = sorted(self._metrics)
            for fam, g in sorted(self._groups.items()):
                out.extend(f"{fam}.{k}" for k in g)
        return out

    # -- exposition -----------------------------------------------------
    def snapshot(self, reset=False):
        """Flat {name: value} over the whole surface. Counter values are
        numbers; labeled metrics key as `name{a=x,b=y}`; histograms map to
        a {count,sum,min,max,mean} dict. `reset=True` zeroes counters,
        histograms, and group counters (gauges are levels — they keep
        their value)."""
        out = {}
        with self._lock:
            for name, m in sorted(self._metrics.items()):
                for key in sorted(m._children):
                    slot = m._children[key]
                    full = name + _prom_labels(m.label_names, key) \
                        if m.label_names else name
                    if m.kind == "histogram":
                        mean = slot["sum"] / slot["count"] \
                            if slot["count"] else 0.0
                        out[full] = {
                            "count": slot["count"],
                            "sum": slot["sum"],
                            "mean": mean,
                            "min": slot["min"] if slot["count"] else 0.0,
                            "max": slot["max"] if slot["count"] else 0.0,
                        }
                        if reset:
                            m._children[key] = m._new_slot()
                    else:
                        out[full] = slot[0]
                        if reset and m.kind == "counter":
                            slot[0] = 0.0
            groups = list(self._groups.items())
        # group snapshots take each owner lock OUTSIDE the registry lock
        # order registry -> group is the only order used anywhere
        for fam, g in sorted(groups):
            for k, v in g.snapshot(reset=reset).items():
                out[f"{fam}.{k}"] = v
        return out

    def snapshot_json(self, reset=False):
        return _json.dumps(self.snapshot(reset=reset), sort_keys=True)

    def prometheus_text(self):
        """Prometheus text exposition format 0.0.4 of the whole surface."""
        lines = []
        with self._lock:
            metrics = sorted(self._metrics.items())
            groups = sorted(self._groups.items())
        for name, m in metrics:
            pname = _prom_name(name)
            if m.help:
                lines.append(f"# HELP {pname} {m.help}")
            lines.append(f"# TYPE {pname} {m.kind}")
            with self._lock:
                # deep-copy slot state under the lock: a concurrent
                # observe() mutates buckets/count/sum as separate writes,
                # and a lock-free read could emit a histogram whose count
                # disagrees with its +Inf cumulative bucket
                if m.kind == "histogram":
                    children = [
                        (key, dict(slot, buckets=list(slot["buckets"])))
                        for key, slot in sorted(m._children.items())]
                else:
                    children = [(key, list(slot))
                                for key, slot in sorted(m._children.items())]
            for key, slot in children:
                lab = _prom_labels(m.label_names, key)
                if m.kind == "histogram":
                    cum = 0
                    for ub, c in zip(m.buckets, slot["buckets"]):
                        cum += c
                        le = _prom_labels(
                            m.label_names + ("le",), key + (_fmt(ub),))
                        lines.append(f"{pname}_bucket{le} {cum}")
                    cum += slot["buckets"][-1]
                    le = _prom_labels(m.label_names + ("le",),
                                      key + ("+Inf",))
                    lines.append(f"{pname}_bucket{le} {cum}")
                    lines.append(f"{pname}_sum{lab} {_fmt(slot['sum'])}")
                    lines.append(f"{pname}_count{lab} {slot['count']}")
                else:
                    lines.append(f"{pname}{lab} {_fmt(slot[0])}")
        for fam, g in groups:
            if g.help:
                lines.append(f"# HELP {_prom_name(fam)} {g.help}")
            for k, v in g.snapshot().items():
                lines.append(f"{_prom_name(fam + '.' + k)} {_fmt(v)}")
        return "\n".join(lines) + "\n"

    def _reset_all_for_tests(self):
        """Test hook: zero every metric including gauges and label sets."""
        with self._lock:
            for m in self._metrics.values():
                m._children.clear()
        for g in list(self._groups.values()):
            g.snapshot(reset=True)


def _fmt(v):
    if isinstance(v, float):
        if not _math.isfinite(v):
            # Prometheus spells non-finite values +Inf/-Inf/NaN; one bad
            # series must not crash the whole exposition
            return "+Inf" if v > 0 else ("-Inf" if v < 0 else "NaN")
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    return str(v)


# the process-global registry — the single pane of glass
REGISTRY = Registry()

# module-level conveniences bound to the global registry
counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
stats_group = REGISTRY.stats_group
snapshot = REGISTRY.snapshot
snapshot_json = REGISTRY.snapshot_json
prometheus_text = REGISTRY.prometheus_text
