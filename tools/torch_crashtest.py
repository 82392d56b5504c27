#!/usr/bin/env python
"""Crash-consistency check of the PyTorch port: a real SIGKILL, then a
resume in a fresh process that must end bit-equal to an uninterrupted run.

The counterpart of `tools/crashtest.py`'s basic mode. It spawns a training
subprocess driven by `incubator_mxnet_tpu_torch.fault.run_resilient`,
SIGKILLs it through the fault-injection spec (`MXNET_FAULT_SPEC`), restarts
it with injection disarmed, and checks that the restarted run's final state
equals an uninterrupted reference run's, bit for bit, and that the killed
run left no partial step visible (`checkpoint.latest_step` names the last
committed step; the resume collects the `.tmp-*` leftovers).

    python tools/torch_crashtest.py [--device cuda|cpu] [--model quad|lm]
        [--steps 14] [--ckpt-every 3] [--kill-at N] [--kill-in step|save]
        [--dir DIR] [--seed 0]

`--kill-in step` kills at the N-th step (`resilient.step:<N>:kill`);
`--kill-in save` kills inside the N-th save, after its data is written and
before its commit (`checkpoint.save:<N>:kill` for the npz format,
`checkpoint.save_sharded:<N>:kill` for the per-leaf format). Both kinds run
when `--kill-in both` (the default). Models: `quad`, a float32 tensor under
a deterministic descent, checkpointed as npz (the JAX tool's basic mode);
`lm`, the flagship transformer LM's AdamW step (`models.transformer`) on a
fixed batch per step index, checkpointed in the per-leaf sharded format
(params and both Adam moments), at the width `--lm-*` sets (default: a
small one; on the card the full width is `--lm-vocab 32000 --lm-d 768
--lm-heads 12 --lm-ff 3072 --lm-seq 2048`). On the card the children run
with TF32 off and deterministic algorithms on.

The uninterrupted run and the killed runs start together, then the
resumes together (each child its own process, sharing only the card).
Prints `parity OK` and exits 0 when every kind holds. The flight-recorder,
sanitize, OOM, elastic and fleet modes of `tools/crashtest.py` wait for the
port's telemetry (ROADMAP A11), mesh (A10) and fleet (A8).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 600           # each round of children


def _lm_config(args):
    from incubator_mxnet_tpu_torch.models import transformer as tf
    return tf.TransformerConfig(
        vocab_size=args.lm_vocab, num_layers=args.lm_layers,
        d_model=args.lm_d, num_heads=args.lm_heads, d_ff=args.lm_ff,
        max_seq_len=args.lm_seq, dtype=args.lm_dtype)


def _child(args):
    """Training subprocess: run_resilient over the chosen model; writes the
    final state (flat numpy arrays) and the run's accounting to
    `<dir>/final.npz` and `<dir>/final.json`."""
    if args.device == "cuda":
        # before the first cuBLAS handle: deterministic workspaces
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, REPO)
    import math

    import numpy as np
    import torch
    from incubator_mxnet_tpu_torch import checkpoint, fault

    torch.set_num_threads(1)          # one reduction order in every child
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.use_deterministic_algorithms(True, warn_only=True)

    if args.model == "quad":
        g = torch.Generator().manual_seed(args.seed)
        init = {"w": torch.randn(16, generator=g).to(dev)}

        def step_fn(state, step):
            w = torch.as_tensor(state["w"], device=dev)
            loss = (w * w).mean()
            return {"w": w * (1.0 - 0.05) + 0.01 * math.cos(step)}, loss
        sharded = False
    else:
        from incubator_mxnet_tpu_torch.models import transformer as tf
        cfg = _lm_config(args)
        params = tf.init_params(args.seed, cfg, device=dev)
        mu, nu = tf.init_opt_state(params)
        init = {"params": params, "mu": mu, "nu": nu}
        train = tf.make_train_step(cfg)

        def step_fn(state, step):
            r = np.random.RandomState(args.seed * 100003 + step)
            tokens = torch.from_numpy(r.randint(
                0, cfg.vocab_size, (args.lm_batch, args.lm_seq + 1))
                .astype(np.int32)).to(dev)
            p, (m, v), loss = train(state["params"],
                                    (state["mu"], state["nu"]),
                                    {"tokens": tokens}, step)
            return {"params": p, "mu": m, "nu": v}, loss
        sharded = True

    t0 = time.perf_counter()
    run = fault.run_resilient(step_fn, init, args.dir, args.steps,
                              ckpt_every=args.ckpt_every, sharded=sharded,
                              keep_last=3)
    flat = {k: checkpoint._host(v)
            for k, v in checkpoint._flatten(run.state).items()}
    np.savez(os.path.join(args.dir, "final.npz"), **flat)
    with open(os.path.join(args.dir, "final.json"), "w") as f:
        json.dump({"resumed_from": run.resumed_from,
                   "saved_steps": run.saved_steps,
                   "seconds": time.perf_counter() - t0}, f)
    return 0


def _start(args, d, spec=None):
    """Start one child (the subprocess.Popen); `spec` arms its faults."""
    cmd = [sys.executable, os.path.abspath(__file__), "--child",
           "--dir", d] + _passthrough(args)
    env = dict(os.environ)
    env.pop("MXNET_FAULT_SPEC", None)
    if spec:
        env["MXNET_FAULT_SPEC"] = spec
    if args.device == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _wait(procs, timeout):
    """Wait for every child (killing all of them past `timeout` seconds);
    returns [(returncode, stdout, stderr, seconds)] in order."""
    t0 = time.perf_counter()
    out = []
    try:
        for p in procs:
            left = max(1.0, timeout - (time.perf_counter() - t0))
            so, se = p.communicate(timeout=left)
            out.append((p.returncode, so, se, time.perf_counter() - t0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _passthrough(args):
    out = []
    for k in ("device", "model", "steps", "ckpt_every", "seed", "lm_vocab", "lm_layers", "lm_d", "lm_heads", "lm_ff",
              "lm_seq", "lm_batch", "lm_dtype"):
        out += ["--" + k.replace("_", "-"), str(getattr(args, k))]
    return out


def _final(d):
    import numpy as np
    with np.load(os.path.join(d, "final.npz")) as f:
        arrays = {k: f[k].copy() for k in f.files}
    with open(os.path.join(d, "final.json")) as f:
        return arrays, json.load(f)


def _check(result, what):
    code, so, se, _ = result
    if code != 0:
        sys.stdout.write(so)
        sys.stderr.write(se)
        raise SystemExit(f"{what} failed with exit code {code}")


def _kill_spec(args, kind):
    """(MXNET_FAULT_SPEC, the step that must stay committed) of a kind."""
    n = args.kill_at
    if kind == "step":
        return (f"resilient.step:{n}:kill",
                ((n - 1) // args.ckpt_every) * args.ckpt_every)
    point = "checkpoint.save" if args.model == "quad" \
        else "checkpoint.save_sharded"
    n = max(1, n // args.ckpt_every)
    return f"{point}:{n}:kill", (n - 1) * args.ckpt_every


def _after_kill(root, kind, spec, committed, result):
    """Check what a killed child left: SIGKILLed, the last committed step
    visible and nothing newer."""
    sys.path.insert(0, REPO)
    from incubator_mxnet_tpu_torch import checkpoint
    d = os.path.join(root, f"kill-{kind}")
    code, so, se, took = result
    if code != -signal.SIGKILL:
        sys.stdout.write(so)
        sys.stderr.write(se)
        raise SystemExit(f"the {kind} kill ({spec}) did not SIGKILL the "
                         f"child: exit code {code}")
    seen = checkpoint.latest_step(d)
    seen = 0 if seen is None else seen
    partial = sorted(x for x in os.listdir(d) if x.startswith("."))
    print(f"[{kind}] {spec}: SIGKILLed (seen {took:.2f} s after the "
          f"start); latest committed step {seen} (expected {committed}); "
          f"partial leftovers {partial}")
    if seen != committed:
        raise SystemExit(f"a partial step is visible: latest_step {seen}, "
                         f"expected {committed}")
    return took


def _after_resume(root, kind, spec, committed, result, ref, killed_s):
    """Check a resumed child: resumed from the committed step, no partial
    save left, the final state bit-equal to the uninterrupted run's."""
    import numpy as np
    d = os.path.join(root, f"kill-{kind}")
    _check(result, f"the resume after the {kind} kill")
    got, info = _final(d)
    left = [x for x in os.listdir(d) if x.startswith(".tmp-")
            or (x.startswith(".") and x.endswith(".tmp"))]
    if (info["resumed_from"] or 0) != committed:
        raise SystemExit(f"resumed from {info['resumed_from']}, expected "
                         f"{committed}")
    if left:
        raise SystemExit(f"the resume left partial saves {left}")
    parted = [k for k in ref if not np.array_equal(ref[k], got[k])]
    if sorted(got) != sorted(ref) or parted:
        raise SystemExit(f"the resumed state differs from the "
                         f"uninterrupted run's in {parted[:5]}")
    print(f"[{kind}] resumed from step {info['resumed_from']} (seen "
          f"{result[3]:.2f} s after the resumes' start; the run itself "
          f"{info['seconds']:.2f} s): {len(ref)} arrays bit-equal to the "
          f"uninterrupted run's")
    return {"kind": kind, "spec": spec, "committed": committed,
            "resumed_from": info["resumed_from"], "killed_s": killed_s,
            "resumed_s": result[3], "run_s": info["seconds"],
            "arrays": len(ref), "bit_equal": True}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--model", default="quad", choices=("quad", "lm"))
    ap.add_argument("--steps", type=int, default=14)
    ap.add_argument("--ckpt-every", type=int, default=3)
    ap.add_argument("--kill-at", type=int, default=8)
    ap.add_argument("--kill-in", default="both",
                    choices=("step", "save", "both"))
    ap.add_argument("--dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lm-vocab", type=int, default=256)
    ap.add_argument("--lm-layers", type=int, default=2)
    ap.add_argument("--lm-d", type=int, default=32)
    ap.add_argument("--lm-heads", type=int, default=4)
    ap.add_argument("--lm-ff", type=int, default=64)
    ap.add_argument("--lm-seq", type=int, default=16)
    ap.add_argument("--lm-batch", type=int, default=2)
    ap.add_argument("--lm-dtype", default="float32")
    ap.add_argument("--json", default=None,
                    help="also write the records to this file")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return _child(args)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("torch_crashtest: --device cuda needs a CUDA card",
                  file=sys.stderr)
            return 2
    if not 1 <= args.kill_at <= args.steps:
        ap.error("--kill-at must be within 1..--steps")
    root = args.dir or tempfile.mkdtemp(prefix="torch_crashtest-")
    os.makedirs(root, exist_ok=True)
    kinds = ("step", "save") if args.kill_in == "both" else (args.kill_in,)
    specs = {k: _kill_spec(args, k) for k in kinds}
    try:
        # the uninterrupted run and every killed run at once, then every
        # resume at once: the children share nothing but the card
        first = _wait([_start(args, os.path.join(root, "ref"))]
                      + [_start(args, os.path.join(root, f"kill-{k}"),
                                specs[k][0]) for k in kinds],
                      CHILD_TIMEOUT_S)
        _check(first[0], "the uninterrupted run")
        ref, info = _final(os.path.join(root, "ref"))
        print(f"[ref] {args.steps} steps of {args.model} on {args.device} "
              f"uninterrupted in {first[0][3]:.2f} s (the run itself "
              f"{info['seconds']:.2f} s), saves at {info['saved_steps']}")
        killed = {k: _after_kill(root, k, *specs[k], r)
                  for k, r in zip(kinds, first[1:])}
        second = _wait([_start(args, os.path.join(root, f"kill-{k}"))
                        for k in kinds], CHILD_TIMEOUT_S)
        records = [_after_resume(root, k, *specs[k], r, ref, killed[k])
                   for k, r in zip(kinds, second)]
    finally:
        if args.dir is None:
            shutil.rmtree(root, ignore_errors=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
    print("parity OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
