"""mx.tune.measure of the PyTorch port — the subprocess-isolated trial
runner.

Counterpart of `incubator_mxnet_tpu/tune/measure.py`, on the JAX
package's workloads and sizes. One measurement = one child process
(`python -m incubator_mxnet_tpu_torch.tune.measure --phase P --knobs JSON
--device D`), spawned by `tune.search` with a **scrubbed** environment
(`space.scrubbed_env`) so the knob assignment under test arrives ONLY
through argv and lands as explicit constructor arguments. The child
prints exactly one JSON line on stdout:

    {"phase": ..., "ok": true, "score": <float>, "unit": ..., "device": ...,
     "launches": {"<kernel>:<dtype>": n, ...}, ...}

and exits non-zero with ``"ok": false`` on any failure, so a crashing or
hanging configuration is a failed *trial* with a recorded reason, never a
failed sweep. `launches` are the port's kernel launches during the
measurement (`ops.kernels.launch_counts_by_dtype()` deltas): the paged
attention kernel in `serve_decode`, the scale/shift/activation apply and
the average pool's forward and backward in `train_fused` on the card.

Each phase measures the knobs the catalog declares for it, on a small
deterministic workload (seeded `np.random.RandomState`). Scores are
throughputs — higher is better for every phase. `device` is the card
(`cuda`, the default) or `cpu`.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _merge(knobs, phase):
    """Catalog defaults for `phase` overlaid with the trial assignment."""
    from . import space
    asn = space.default_assignment(phase)
    for k, v in (knobs or {}).items():
        if k in asn:
            asn[k] = space.knob(k).validate(v)
    return asn


def _scope(device):
    """The `with` scope that makes `device` current for the port's entry
    points (arrays, blocks, iterators made without a device)."""
    import torch
    from .. import device as _device
    dev = torch.device(device)
    if dev.type == "cuda":
        return _device.gpu(dev.index or 0)
    return _device.cpu()


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase runners — each returns {"score": float, "unit": str, ...detail}
# ---------------------------------------------------------------------------
def _measure_serve_decode(knobs, scale, device):
    """Continuous-engine closed-loop decode throughput (tokens/s)."""
    import numpy as np
    from .. import serve

    cfg = dict(vocab=64, embed=32, layers=2, heads=4, head_dim=8,
               max_len=64)
    model = serve.CachedDecoder(serve.DecoderConfig(**cfg), seed=3,
                                device=device)
    n = 12 if scale == "quick" else 48
    rng = np.random.RandomState(7)
    work = [(rng.randint(1, 64, size=rng.randint(2, 9)).tolist(),
             int(rng.randint(4, 13))) for _ in range(n)]

    ms = knobs["serve.max_slots"]
    pl = knobs["serve.prefill_lanes"]
    if pl is not None:
        pl = min(int(pl), int(ms))   # lanes can never exceed slots
    eng = serve.ContinuousEngine(
        model, max_slots=ms, prefill_lanes=pl,
        decode_steps=knobs["serve.decode_steps"],
        draft_tokens=knobs["serve.draft_tokens"],
        kv_dtype=knobs["serve.kv_dtype"])
    eng.start()
    try:
        # warmup: every program run once + one slot churn before timing
        for p, m in work[:2]:
            eng.generate(p, m, timeout=120)
        t0 = time.perf_counter()
        futs = [eng.submit(p, m) for p, m in work]
        toks = sum(len(f.result(timeout=300)) for f in futs)
        dt = time.perf_counter() - t0
        retraces = eng.assert_no_retraces()
    finally:
        eng.close()
    return {"score": round(toks / dt, 2), "unit": "tokens_per_sec",
            "tokens": toks, "retraces": retraces}


def _measure_train_fused(knobs, scale, device):
    """Fused-train-step throughput (images/s) on the tiny conv net."""
    import numpy as np
    from .. import gluon
    from .. import numpy as mxnp
    from .. import optimizer as opt_mod
    from ..gluon.contrib import FusedTrainStep

    layout = knobs["train.conv_layout"]
    axis = 3 if layout == "NHWC" else 1
    bs = 16
    with _scope(device):
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Conv2D(8, 3, padding=1, layout=layout),
                gluon.nn.BatchNorm(axis=axis), gluon.nn.Activation("relu"),
                gluon.nn.GlobalAvgPool2D(layout=layout),
                gluon.nn.Flatten(), gluon.nn.Dense(10))
        net.initialize()
        net.hybridize()
        shape = (bs, 8, 8, 3) if layout == "NHWC" else (bs, 3, 8, 8)
        rng = np.random.RandomState(5)
        xs = [mxnp.array(rng.uniform(-1, 1, shape).astype(np.float32))
              for _ in range(2)]
        ys = [mxnp.array(rng.randint(0, 10, (bs,))) for _ in range(2)]
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        net(xs[0])
        opt = opt_mod.create("sgd", learning_rate=0.05, momentum=0.9,
                             rescale_grad=1.0 / bs)
        step = FusedTrainStep(
            net, lambda n_, a, b: loss_fn(n_(a), b).sum(), opt,
            remat=knobs["train.remat"], donate=knobs["train.donate"])
        first = list(net.collect_params().values())[0]
        warm, iters = (3, 8) if scale == "quick" else (4, 24)
        for i in range(warm):
            step(xs[i % 2], ys[i % 2])
        first.data().cpu()
        t0 = time.perf_counter()
        for i in range(iters):
            step(xs[i % 2], ys[i % 2])
        first.data().cpu()
        dt = time.perf_counter() - t0
    return {"score": round(bs * iters / dt, 2),
            "unit": "images_per_sec", "iters": iters}


def _measure_io_pipeline(knobs, scale, device):
    """ImageRecordIter end-to-end decode throughput (images/s)."""
    import io as _io
    import tempfile
    import numpy as np
    try:
        from PIL import Image
    except Exception as e:  # pragma: no cover - both hosts have PIL
        raise RuntimeError(f"io_pipeline needs PIL: {e!r}")
    from .. import io as mxio
    from .. import recordio

    n, size = (48, 48) if scale == "quick" else (192, 64)
    rng = np.random.RandomState(0)
    with tempfile.TemporaryDirectory(prefix="mxtune-io-") as d:
        rec = os.path.join(d, "tune.rec")
        w = recordio.MXRecordIO(rec, "w")
        for i in range(n):
            yy, xx = np.mgrid[0:size, 0:size]
            base = 127 + 80 * np.sin(yy / 7.0 + i) + 40 * np.cos(xx / 5.0)
            img = np.clip(np.stack([base, base * 0.8, base * 1.1], -1)
                          + rng.randn(size, size, 3) * 12,
                          0, 255).astype(np.uint8)
            buf = _io.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG", quality=85)
            w.write(recordio.pack(
                recordio.IRHeader(0, float(i % 10), i, 0), buf.getvalue()))
        w.close()

        def _epoch(it):
            seen = 0
            for b in it:
                seen += int(b.data[0].shape[0])
                _ = float(b.label[0][0, 0])
            it.reset()
            return seen

        it = mxio.ImageRecordIter(
            path_imgrec=rec, data_shape=(32, 32, 3), batch_size=16,
            shuffle=False, rand_crop=True, resize=40, round_batch=False,
            workers=knobs["io.workers"], lookahead=knobs["io.lookahead"],
            shm_mb=knobs["io.shm_mb"], device=device)
        try:
            _epoch(it)                           # warm epoch (page cache)
            epochs = 2 if scale == "quick" else 4
            t0 = time.perf_counter()
            total = sum(_epoch(it) for _ in range(epochs))
            dt = time.perf_counter() - t0
        finally:
            close = getattr(it, "close", None)
            if close:
                close()
    return {"score": round(total / dt, 2), "unit": "images_per_sec",
            "images": total}


def _measure_serve_batch(knobs, scale, device):
    """Static-batcher request throughput (requests/s) over a bucket set."""
    import threading
    import numpy as np
    import torch
    from .. import serve

    rng = np.random.RandomState(11)
    w = torch.as_tensor(rng.randn(8, 16).astype(np.float32),
                        device=device)
    model = serve.CallableModel(lambda x: torch.tanh(x @ w),
                                knobs["serve.batch_buckets"],
                                [((8,), "float32")], device=device)
    n_threads, per = (4, 12) if scale == "quick" else (8, 40)
    rows = [rng.randn(8).astype(np.float32)
            for _ in range(n_threads * per)]
    with serve.Server(model, batch_timeout_ms=1.0,
                      name="tune.batch") as srv:
        for r in rows[:4]:                       # warm the submit path
            srv.predict(r)
        done = []
        lock = threading.Lock()

        def client(tid):
            for i in range(per):
                y = srv.predict(rows[tid * per + i])
                with lock:
                    done.append(y.shape)

        t0 = time.perf_counter()
        ts = [threading.Thread(target=client, args=(t,))
              for t in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        dt = time.perf_counter() - t0
    return {"score": round(len(done) / dt, 2),
            "unit": "requests_per_sec", "requests": len(done)}


def _measure_dispatch(knobs, scale, device):
    """Eager-dispatch op throughput (ops/s) under the bulk size (the port
    records it and bulks nothing)."""
    from .. import engine
    from .. import numpy as mxnp

    prev = engine.set_bulk_size(knobs["dispatch.bulk_size"])
    try:
        x = mxnp.ones((64, 64), device=device)
        n_ops, reps = (300, 3) if scale == "quick" else (1000, 5)

        def chain():
            y = x
            for _ in range(n_ops):
                y = y + 1.0
            return y.asnumpy()

        chain()                                  # warm the dispatch path
        t0 = time.perf_counter()
        for _ in range(reps):
            chain()
        dt = time.perf_counter() - t0
    finally:
        engine.set_bulk_size(prev)
    return {"score": round(n_ops * reps / dt, 2), "unit": "ops_per_sec"}


RUNNERS = {
    "serve_decode": _measure_serve_decode,
    "train_fused": _measure_train_fused,
    "io_pipeline": _measure_io_pipeline,
    "serve_batch": _measure_serve_batch,
    "dispatch": _measure_dispatch,
}


def run_phase(phase, knobs=None, scale="quick", device="cuda"):
    """In-process measurement (the child's body; also direct-callable) on
    `device`. Adds `device` and `launches`, the port's kernel launches
    during the measurement by "<kernel>:<dtype>"."""
    if phase not in RUNNERS:
        raise ValueError(f"unknown measure phase {phase!r} "
                         f"(have: {sorted(RUNNERS)})")
    from ..device import resolve_device
    from ..ops import kernels
    dev = resolve_device(device)
    before = kernels.launch_counts_by_dtype()
    res = RUNNERS[phase](_merge(knobs, phase), scale, str(dev))
    _sync(dev)
    after = kernels.launch_counts_by_dtype()
    res["device"] = str(dev)
    res["launches"] = {f"{k}:{d}": n - before.get((k, d), 0)
                       for (k, d), n in sorted(after.items())
                       if n != before.get((k, d), 0)}
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mx.tune.measure")
    ap.add_argument("--phase", required=True)
    ap.add_argument("--knobs", default="{}",
                    help="JSON knob assignment (explicit args, not env)")
    ap.add_argument("--scale", default="quick",
                    choices=("quick", "full"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    try:
        res = run_phase(args.phase, json.loads(args.knobs), args.scale,
                        args.device)
    except BaseException as e:  # noqa: BLE001 — the reason IS the result
        print(json.dumps({"phase": args.phase, "ok": False,
                          "error": f"{type(e).__name__}: {e}"}))
        return 1
    res.update(phase=args.phase, ok=True,
               elapsed_s=round(time.perf_counter() - t0, 3))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
