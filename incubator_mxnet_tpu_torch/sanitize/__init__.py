"""mx.sanitize of the PyTorch port — opt-in runtime checks of the in-place
programs' contracts.

Counterpart of `incubator_mxnet_tpu/sanitize/`, with its surface, error
classes and modes, armed the same way through ``MXNET_SANITIZE`` (a comma
list, e.g. ``MXNET_SANITIZE=donation,retrace``, or ``all``; an unknown
mode raises). Everything is off by default at zero cost:
`maybe_wrap_donated` returns the program itself when no mode is armed.
The wrapper reads the live mode set on every call.

``donation`` — in-place aliasing
    The JAX package donates a program's buffers to XLA and swaps in its
    outputs; the port's programs update the caller's tensors in place and
    return no slabs (the KV pool is never reallocated while it serves).
    So a "donated" argument here is one the program updates in place, and
    the wrapper raises :class:`DonationViolation`, naming the argument,
    the program and the call, in two cases:

      * before the call, a donated argument overlaps the storage of
        another argument of the same call (a write through one would
        change the other in the middle of the program: the hazard XLA
        refuses for a buffer donated twice);
      * after the call, a donated argument no longer owns the storage it
        came in with, or its `_version` did not advance: the program
        wrote a copy where it should have updated in place, and the
        caller's buffer is stale.

    Passing the same live tensor again after an in-place update is not a
    violation (in JAX it is a use after donate): nothing is deleted, and
    there is no poison registry, since no program of the port replaces a
    buffer it was given.

``retrace`` — the recompile sentinel
    A wrapped program's `_cache_size()` is the number of distinct argument
    signatures it has run: the (shape, dtype, device) of each tensor leaf,
    the type name of every other leaf, and the program's key — one entry
    per program variant a CUDA-graph capture would have to hold
    (`counted` keeps that count, with or without this package's modes).
    :func:`arm` snapshots every tracked program; :func:`poll` raises
    :class:`RetraceViolation` naming a program that grew, or a new program
    variant that ran after arm, with the signature drift. The engine arms
    after warmup and polls once a decode wave; `steady_state()` wraps any
    other region.

``slot`` — the canary row
    :class:`SlotCanary` claims one pool slot, poisons its KV row with a
    sentinel (`KVCachePool.poison_slot`: codes 1 and the sentinel as
    scales on an int8 pool), and `check()` probes three positions of it
    every decode wave, pipelined one wave deep: it queues this wave's
    compare on the device and reads the previous wave's boolean, so the
    wave gets no extra synchronisation. A write that escapes the slot
    masks fails with :class:`SlotCanaryError` at most one wave late.

Every violation also lands in the flight recorder
(`telemetry.flightrec_record`, and a dump when MXNET_FLIGHTREC_DIR is
set).
"""
from __future__ import annotations

import contextlib
import os
import threading
import weakref

from ..base import MXNetError

__all__ = [
    "DonationViolation", "RetraceViolation", "SlotCanaryError",
    "modes", "enabled", "scope", "maybe_wrap_donated", "arm", "poll",
    "steady_state", "tracked_programs", "SlotCanary", "clear",
]

_VALID_MODES = ("donation", "retrace", "slot")


class DonationViolation(MXNetError):
    """A program's in-place ("donated") argument was aliased by another
    argument of the call, or was not updated in place."""


class RetraceViolation(MXNetError):
    """A program ran a new argument signature (or a new program variant
    ran) inside an armed steady-state region."""


class SlotCanaryError(MXNetError):
    """The poisoned canary KV row was overwritten — slot isolation is
    broken."""


# ---------------------------------------------------------------------------
# mode handling
# ---------------------------------------------------------------------------
_override = None          # scope() test hook; beats the env when not None
_olock = threading.Lock()


def modes():
    """The active mode set (frozenset of {'donation','retrace','slot'})."""
    if _override is not None:
        return _override
    raw = os.environ.get("MXNET_SANITIZE", "")
    if not raw:
        return frozenset()
    if raw.strip() == "all":
        return frozenset(_VALID_MODES)
    out = set()
    for piece in raw.split(","):
        piece = piece.strip()
        if not piece:
            continue
        if piece not in _VALID_MODES:
            raise MXNetError(
                f"MXNET_SANITIZE: unknown mode {piece!r} "
                f"(valid: {', '.join(_VALID_MODES)}, or 'all')")
        out.add(piece)
    return frozenset(out)


def enabled(mode):
    return mode in modes()


@contextlib.contextmanager
def scope(spec):
    """Arm modes for a block regardless of the env (test hook):
    ``with sanitize.scope("donation,retrace"): ...``"""
    global _override
    new = (frozenset(_VALID_MODES) if spec.strip() == "all"
           else frozenset(p.strip() for p in spec.split(",") if p.strip()))
    for m in new:
        if m not in _VALID_MODES:
            raise MXNetError(f"sanitize.scope: unknown mode {m!r}")
    with _olock:
        prev, _override = _override, new
    try:
        yield
    finally:
        with _olock:
            _override = prev


def _flightrec(kind, name, **fields):
    """Record the violation in the flight recorder and (when
    MXNET_FLIGHTREC_DIR is set) leave a black-box dump, so a contract
    breach names itself on disk even if the raising process dies."""
    try:
        from ..telemetry import flightrec_maybe_dump, flightrec_record
        flightrec_record(kind, name, **fields)
        flightrec_maybe_dump(reason=f"{kind}:{name}")
    except Exception:
        pass                     # diagnostics must never mask the error


def _leaves(tree):
    from torch.utils._pytree import tree_leaves
    return tree_leaves(tree)


def _tensor_leaves(tree):
    import torch
    return [x for x in _leaves(tree) if isinstance(x, torch.Tensor)]


# ---------------------------------------------------------------------------
# donation mode: in-place aliasing
# ---------------------------------------------------------------------------
def _extent(t):
    """(storage address, first byte, end byte) of the bytes `t` can
    reach, or None for an empty tensor."""
    if t.numel() == 0:
        return None
    size = t.element_size()
    last = sum((n - 1) * abs(s) for n, s in zip(t.shape, t.stride()))
    base = t.untyped_storage().data_ptr()
    start = base + t.storage_offset() * size
    return base, start, start + (last + 1) * size


def _check_aliasing(args, donated, prog_name, call):
    """Raise DonationViolation when a donated argument's storage overlaps
    another argument's (before the program writes anything)."""
    by_storage = {}
    for i, a in enumerate(args):
        for t in _tensor_leaves(a):
            e = _extent(t)
            if e is not None:
                by_storage.setdefault(e[0], []).append((i, e[1], e[2]))
    for spans in by_storage.values():
        for n, (i, lo, hi) in enumerate(spans):
            if i not in donated:
                continue
            j = next((a for m, (a, lo2, hi2) in enumerate(spans)
                      if m != n and lo2 < hi and lo < hi2), None)
            if j is None:
                continue
            _flightrec("sanitize.donation", prog_name, arg=i, other=j,
                       call=call)
            raise DonationViolation(
                f"donated argument {i} of `{prog_name}` (call {call}) "
                f"shares storage with argument {j}: the program updates "
                f"argument {i} in place, so a write through it would "
                f"change argument {j} in the middle of the call — pass "
                f"separate buffers")


def _donated_state(args, donated):
    """[(position, tensor, storage address, version)] of the donated
    tensor leaves, taken before the call."""
    out = []
    for pos in donated:
        if pos < len(args):
            for t in _tensor_leaves(args[pos]):
                out.append((pos, t, t.untyped_storage().data_ptr(),
                            t._version))
    return out


def _check_updated(state, prog_name, call):
    """Raise DonationViolation when a donated leaf changed storage or was
    not written in place by the call."""
    for pos, t, ptr, version in state:
        if t.untyped_storage().data_ptr() != ptr:
            why = "no longer owns the storage it came in with"
        elif t._version == version:
            why = ("was not written in place (its version did not "
                   "advance: the program wrote a copy, and the caller's "
                   "buffer is stale)")
        else:
            continue
        _flightrec("sanitize.donation", prog_name, arg=pos, call=call)
        raise DonationViolation(
            f"donated argument {pos} of `{prog_name}` (call {call}) {why}"
            f" — a program that writes through `.data` or a raw pointer "
            f"bumps the version with "
            f"`torch.autograd.graph.increment_version`")


# ---------------------------------------------------------------------------
# retrace mode: the recompile sentinel
# ---------------------------------------------------------------------------
_tracked = weakref.WeakSet()     # every _SanitizedProgram ever built
_tracked_version = 0             # bumped per new program (cheap "did a
_arm_epoch = 0                   # new variant appear" check in poll)
_arm_version = -1
_armed_snapshot = []             # [(weakref(prog), size, sig)] at arm
_alock = threading.Lock()


def _signature(args, key=None):
    """A call's signature: (shape, dtype, device) per tensor leaf, the
    type name of every other leaf, and the program's key."""
    import torch
    sig = []
    for leaf in _leaves(args):
        if isinstance(leaf, torch.Tensor):
            sig.append((tuple(leaf.shape), str(leaf.dtype),
                        str(leaf.device)))
        else:
            sig.append(type(leaf).__name__)
    return (key,) + tuple(sig) if key is not None else tuple(sig)


class _Counted:
    """A program with its signature count: `_cache_size()` is the number
    of distinct call signatures it has run (where a jitted program counts
    its compiled variants), `_last_sig` the latest."""

    def __init__(self, fn, key=None):
        self._fn = fn
        self._key = key
        self._sigs = set()
        self._last_sig = None

    def __call__(self, *args, **kwargs):
        sig = _signature((args, kwargs), self._key)
        self._sigs.add(sig)
        self._last_sig = sig
        return self._fn(*args, **kwargs)

    def _cache_size(self):
        return len(self._sigs)


def counted(fn, key=None):
    """`fn` with its signature count (`_cache_size()`), whatever modes are
    armed: the zero-retrace observable of the port's programs."""
    return _Counted(fn, key)


def tracked_programs():
    return list(_tracked)


def arm():
    """Snapshot every tracked program's signature count; later growth —
    or a NEW program running — is a RetraceViolation. The engine calls
    this after warmup (re-arming re-baselines everything, so a second
    engine's warmup in the same process is not a false trip)."""
    global _arm_epoch, _arm_version, _armed_snapshot
    with _alock:
        _arm_epoch += 1
        _arm_version = _tracked_version
        _armed_snapshot = [
            (weakref.ref(prog), prog._cache_size(), prog._last_sig)
            for prog in _tracked]


def _retrace_error(prog, size, sig, cur, where, is_new):
    _flightrec("sanitize.retrace", prog.name, armed=size, now=cur,
               where=where)
    grew = (f"is a NEW program variant run after arm "
            f"({cur} signature(s))" if is_new else
            f"ran {cur - size} new signature(s) after arm "
            f"({size} -> {cur})")
    last = prog._last_sig
    raise RetraceViolation(
        f"`{prog.name}` {grew}"
        + (f" in {where}" if where else "")
        + (f"; armed-call signature {sig} vs last call {last}"
           if sig != last else
           "; argument signatures are identical"))


def poll(where=""):
    """Raise RetraceViolation if any tracked program ran a new signature
    since the last `arm()`, or a new program variant ran after it. No-op
    until armed. Steady-path cost is one int compare per armed program;
    the new-variant scan only runs when a program was built since arm."""
    if _arm_epoch == 0:
        return
    for ref, size, sig in _armed_snapshot:
        prog = ref()
        if prog is None or size < 0:
            continue
        cur = prog._cache_size()
        if cur > size:
            _retrace_error(prog, size, sig, cur, where, is_new=False)
    if _tracked_version != _arm_version:
        with _alock:
            armed = {ref() for ref, _, _ in _armed_snapshot}
            progs = [p for p in _tracked if p not in armed]
        for prog in progs:
            cur = prog._cache_size()
            if cur > 0:
                _retrace_error(prog, 0, None, cur, where, is_new=True)


@contextlib.contextmanager
def steady_state(where="steady-state"):
    """Arm on entry, poll on exit: any new signature inside the region
    raises. Wrap an engine or training steady loop."""
    arm()
    yield
    poll(where=where)


def clear():
    """Drop all sanitizer state (armed snapshots) — test isolation hook."""
    global _arm_epoch, _arm_version, _armed_snapshot
    with _alock:
        _armed_snapshot = []
        _arm_epoch = 0
        _arm_version = -1


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------
class _SanitizedProgram:
    """Transparent shim over one in-place program. A program without a
    signature count gets one (`counted`), so the sentinel sees every
    wrapped program; every other attribute forwards."""

    def __init__(self, fn, donate_argnums, name):
        global _tracked_version
        if not hasattr(fn, "_cache_size"):
            fn = counted(fn)
        self._fn = fn
        self._donated = tuple(int(p) for p in donate_argnums)
        self.name = name
        self._calls = 0
        with _alock:
            _tracked.add(self)
            _tracked_version += 1

    def __call__(self, *args, **kwargs):
        active = modes()
        self._calls += 1
        state = None
        if "donation" in active:
            _check_aliasing(args, self._donated, self.name, self._calls)
            state = _donated_state(args, self._donated)
        out = self._fn(*args, **kwargs)
        if state is not None:
            _check_updated(state, self.name, self._calls)
        return out

    @property
    def _last_sig(self):
        return getattr(self._fn, "_last_sig", None)

    def _cache_size(self):
        try:
            return int(self._fn._cache_size())
        except Exception:
            return -1

    def __getattr__(self, item):
        return getattr(self._fn, item)

    def __repr__(self):
        return f"<sanitized {self.name} donate={self._donated}>"


def maybe_wrap_donated(fn, donate_argnums, name):
    """Wrap an in-place program when any sanitizer mode is armed at build
    time; otherwise return `fn` unchanged (zero overhead off).

    `donate_argnums` are the positions the program updates in place. The
    wrapper checks the LIVE mode set on every call, so a program built
    inside `sanitize.scope(...)` (or with MXNET_SANITIZE set) reacts to
    mode changes without rebuilding."""
    if not modes():
        return fn
    return _SanitizedProgram(fn, donate_argnums, name)


# ---------------------------------------------------------------------------
# slot mode: the canary row
# ---------------------------------------------------------------------------
class SlotCanary:
    """One claimed-and-poisoned KV pool slot, checked every decode wave.

    The decode program runs over ALL pool rows as lanes; the canary slot
    is never handed to a request, so its lane is permanently inactive and
    writes into the garbage row — if the sentinel row ever changes, a
    program wrote through the slot masks. `rearm()` re-poisons it (after a
    failed wave, or after a caller wrote the slab wholesale)."""

    def __init__(self, pool, value=1e9):
        import torch
        self.pool = pool
        self.value = float(value)
        self.slot = pool.claim()
        self.waves = 0
        self._arm()
        # row start, middle and tail catch both offset and full-row
        # overwrites
        L = pool.max_len
        self._probe_idx = torch.as_tensor(sorted({0, L // 2, L - 1}),
                                          device=pool.device)
        # codes on an int8 pool (poison_slot writes code 1, the sentinel
        # as scale); the slab's own rounding of the sentinel otherwise
        self._expect = 1 if pool.quantized else self.value
        self._expect_t = torch.full((), self._expect, dtype=pool.k.dtype,
                                    device=pool.device)
        self._pending = None

    def _arm(self):
        self.pool.poison_slot(self.slot, self.value)

    def rearm(self):
        """Re-poison the canary row; a pending probe of the old row is
        dropped."""
        self._arm()
        self._pending = None

    def _probe(self):
        """One device boolean: does the canary row still hold the
        sentinel at the probe positions of layer 0, in both slabs?"""
        idx, e = self._probe_idx, self._expect_t
        return ((self.pool.k[self.slot, 0, idx] == e).all()
                & (self.pool.v[self.slot, 0, idx] == e).all())

    def check(self, where="decode wave"):
        """Probe the canary row; raise SlotCanaryError when it lost its
        sentinel. PIPELINED one wave deep: each call queues this wave's
        probe and reads the PREVIOUS wave's result, which the device has
        finished long since, so the read does not stall the wave that
        issued it (detection surfaces at most one wave late)."""
        self.waves += 1
        pending, self._pending = self._pending, self._probe()
        if pending is None or bool(pending):
            return
        self._pending = None
        # slow path (violation only): name the slab and what we found
        for nm, slab in (("k", self.pool.k), ("v", self.pool.v)):
            got = slab[self.slot, 0, self._probe_idx]
            if not bool((got == self._expect_t).all()):
                _flightrec("sanitize.slot", nm, slot=self.slot,
                           where=where, waves=self.waves)
                raise SlotCanaryError(
                    f"canary KV slot {self.slot} ({nm} slab) was "
                    f"overwritten at {where} (wave {self.waves}): "
                    f"expected sentinel {self._expect}, found "
                    f"{got.float().flatten()[:4].tolist()} — a program "
                    f"wrote outside its slot masks")
        raise SlotCanaryError(
            f"canary KV slot {self.slot} failed its probe at {where} "
            f"(wave {self.waves})")

    def release(self):
        self.pool.free(self.slot)
