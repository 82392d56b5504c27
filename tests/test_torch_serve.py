"""PyTorch port: the dynamic-batching `serve.Server` held against the JAX
package's on the same traffic.

Both packages serve the same `CallableModel` function, a small MLP whose
weights come from numpy with a seed (jnp in the JAX package, torch on the
CPU in the port), and get the same rows. Checked: the bucket each burst
takes and the replies (1e-5 relative and absolute: float32 sums of 6 and
16 terms in another order), `pick_bucket`, the typed errors of every
overload path, the SERVE_STATS deltas, the pad-row mask, the three fault
points and the Prometheus metric names.
"""
import time
from concurrent.futures import wait

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import fault as jfault, serve as jserve
from incubator_mxnet_tpu_torch import fault as tfault, serve as tserve

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
DIM, HID, OUT = 6, 16, 3
BUCKETS = (1, 2, 4, 8)
# a burst of k requests submitted back to back is one batch: the batch
# timeout (from its first request) outlasts the submits
BURST_TIMEOUT_MS = 300.0
BURSTS = (1, 3, 2, 4, 5, 8, 7)


def _weights(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(DIM, HID).astype(np.float32) * 0.5,
            rng.randn(HID).astype(np.float32) * 0.1,
            rng.randn(HID, OUT).astype(np.float32) * 0.5)


def _mlp_models(buckets=BUCKETS):
    w1, b1, w2 = _weights()

    def jfn(x):
        import jax.numpy as jnp
        return jnp.tanh(jnp.maximum(x @ w1 + b1, 0.0) @ w2)

    t1, tb1, t2 = (torch.from_numpy(a) for a in (w1, b1, w2))

    def tfn(x):
        return torch.tanh(torch.relu(x @ t1 + tb1) @ t2)

    spec = [((DIM,), "float32")]
    return (jserve.CallableModel(jfn, buckets, spec),
            tserve.CallableModel(tfn, buckets, spec, device="cpu"))


def _rows(n, dim=DIM, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.rand(dim).astype(np.float32) for _ in range(n)]


def _bursts(serve_mod, model):
    """Serve BURSTS one after another; the replies, the buckets run and
    the server's stats."""
    outs = []
    with serve_mod.Server(model, batch_timeout_ms=BURST_TIMEOUT_MS) as srv:
        for k in BURSTS:
            futs = [srv.submit(x) for x in _rows(k, seed=k)]
            outs += [f.result(timeout=60) for f in futs]
        st = srv.stats()
    return outs, st


def test_bucket_choices_and_replies_match_the_jax_server():
    jm, tm = _mlp_models()
    jbefore, tbefore = jserve.stats(), tserve.stats()
    jouts, jst = _bursts(jserve, jm)
    touts, tst = _bursts(tserve, tm)
    for j, t in zip(jouts, touts):
        assert isinstance(t, np.ndarray) and t.shape == (OUT,)
        np.testing.assert_allclose(t, np.asarray(j), rtol=RTOL, atol=ATOL)
    assert tst["batch_occupancy"] == jst["batch_occupancy"]
    assert set(tst["batch_occupancy"]) == {1, 2, 4, 8}
    for k in ("requests", "replies", "batches", "padded_rows",
              "programs_compiled"):
        assert tst[k] == jst[k], k
    # the process-wide counters moved by the same amounts
    jafter, tafter = jserve.stats(), tserve.stats()
    for k in ("requests", "replies", "batches", "padded_rows",
              "programs_compiled", "rejected", "shed", "timeouts",
              "errors"):
        assert tafter[k] - tbefore[k] == jafter[k] - jbefore[k], k
    assert tst["compile_cache_size"] == len(BUCKETS)


@pytest.mark.parametrize("buckets", [(1, 2, 4), (1, 2, 4, 8, 16, 32),
                                     (3, 7, 40), (5,)])
def test_pick_bucket_matches_for_0_to_40(buckets):
    for n in range(41):
        assert tserve.pick_bucket(n, buckets) == \
            jserve.pick_bucket(n, buckets), n


def _reject(serve_mod, fault_mod, model):
    srv = serve_mod.Server(model, max_queue=2, batch_timeout_ms=50.0,
                           overload_policy="reject").start()
    try:
        admitted, kinds = [], set()
        with fault_mod.scope("serve.execute:*:stall:0.15"):
            for x in _rows(20):
                try:
                    admitted.append(srv.submit(x))
                except serve_mod.QueueFullError as e:
                    kinds.add((type(e).__name__, e.policy))
        srv.close(drain=True)
        served = sum(f.exception() is None for f in admitted)
        rejected = 20 - len(admitted)
        assert srv.stats()["rejected"] == rejected
        return kinds, rejected > 0, served > 0
    finally:
        srv.close()


def _shed(serve_mod, fault_mod, model):
    srv = serve_mod.Server(model, max_queue=2, batch_timeout_ms=50.0,
                           overload_policy="shed").start()
    try:
        with fault_mod.scope("serve.execute:*:stall:0.15"):
            futs = [srv.submit(x) for x in _rows(12)]
        srv.close(drain=True)
        shed = [f.exception() for f in futs
                if isinstance(f.exception(), serve_mod.QueueFullError)]
        assert srv.stats()["shed"] == len(shed)
        return ({(type(e).__name__, e.policy) for e in shed}, bool(shed),
                any(f.exception() is None for f in futs))
    finally:
        srv.close()


def _deadline(serve_mod, fault_mod, model):
    srv = serve_mod.Server(model, batch_timeout_ms=1.0).start()
    try:
        with fault_mod.scope("serve.execute:1:stall:0.25"):
            f1 = srv.submit(np.ones(DIM, np.float32))
            time.sleep(0.02)
            f2 = srv.submit(np.ones(DIM, np.float32), deadline_ms=50)
            wait([f1, f2], timeout=30)
        return (type(f2.exception()).__name__, f1.exception() is None,
                srv.stats()["timeouts"])
    finally:
        srv.close()


def _closed(serve_mod, fault_mod, model):
    srv = serve_mod.Server(model).start()
    srv.close()
    with pytest.raises(serve_mod.ServerClosed) as e:
        srv.submit(np.ones(DIM, np.float32))
    return type(e.value).__name__


def _no_drain(serve_mod, fault_mod, model):
    srv = serve_mod.Server(model, batch_timeout_ms=100.0,
                           max_queue=64).start()
    with fault_mod.scope("serve.execute:*:stall:0.2"):
        futs = [srv.submit(x) for x in _rows(6)]
        srv.close(drain=False)
    wait(futs, timeout=30)
    return {type(f.exception()).__name__ for f in futs
            if f.exception() is not None}


@pytest.mark.parametrize("scenario", [_reject, _shed, _deadline, _closed,
                                      _no_drain],
                         ids=lambda f: f.__name__.strip("_"))
def test_typed_overload_errors_match(scenario):
    jm, tm = _mlp_models()
    want = scenario(jserve, jfault, jm)
    got = scenario(tserve, tfault, tm)
    assert got == want


def test_pad_rows_never_leak_into_replies():
    """fn maps a zero pad row to 5.0: a leaked pad row would show."""
    def tfn(x):
        return x * 2.0 + 5.0

    model = tserve.CallableModel(tfn, (4,), [((3,), "float32")],
                                 device="cpu")
    with tserve.Server(model, batch_timeout_ms=1.0) as srv:
        xs = _rows(7, dim=3, seed=21)
        outs = [srv.predict(x, timeout=30) for x in xs]
    for x, o in zip(xs, outs):
        assert o.shape == (3,)
        np.testing.assert_allclose(o, x * 2.0 + 5.0, rtol=1e-6)
    assert srv.stats()["padded_rows"] > 0


def test_batch_reducing_output_fails_typed():
    model = tserve.CallableModel(lambda x: x.sum(0), (2,),
                                 [((3,), "float32")], device="cpu")
    with tserve.Server(model, batch_timeout_ms=1.0) as srv:
        f = srv.submit(np.ones(3, np.float32))
        with pytest.raises(tserve.ServeError, match="pad"):
            f.result(timeout=30)
        assert srv.stats()["errors"] == 1


def _fault_run(serve_mod, fault_mod, model, spec):
    """One request under `spec`, then a clean one; (error class names,
    the clean reply, errors, replies)."""
    with serve_mod.Server(model, batch_timeout_ms=1.0) as srv:
        names = []
        with fault_mod.scope(spec):
            try:
                srv.submit(np.ones(DIM, np.float32)).result(timeout=30)
            except Exception as e:          # noqa: BLE001 - compared
                names.append(type(e).__name__)
        ok = srv.predict(np.full(DIM, 0.5, np.float32), timeout=30)
        st = srv.stats()
    return names, np.asarray(ok), st["errors"], st["replies"]


@pytest.mark.parametrize("spec", ["serve.enqueue:1:ioerror",
                                  "serve.execute:1:error",
                                  "serve.reply:1:error"])
def test_fault_points_match(spec):
    jm, tm = _mlp_models()
    jnames, jok, jerr, jrep = _fault_run(jserve, jfault, jm, spec)
    tnames, tok, terr, trep = _fault_run(tserve, tfault, tm, spec)
    assert tnames == jnames and len(tnames) == 1
    assert (terr, trep) == (jerr, jrep)
    np.testing.assert_allclose(tok, jok, rtol=RTOL, atol=ATOL)


def test_input_validation_and_bfloat16_rows():
    jm, tm = _mlp_models()
    with tserve.Server(tm) as srv:
        with pytest.raises(tserve.ServeError, match="sample shape"):
            srv.submit(np.zeros((2, DIM), np.float32))
        with pytest.raises(tserve.ServeError, match="takes 1 inputs"):
            srv.submit(np.zeros(DIM, np.float32), np.zeros(DIM, np.float32))
    # a bfloat16 row travels as float32 on the host, bfloat16 inside
    seen = []

    def fn(x):
        seen.append(x.dtype)
        return x * 2.0

    model = tserve.CallableModel(fn, (1, 2), [((3,), "bfloat16")],
                                 device="cpu")
    with tserve.Server(model, batch_timeout_ms=2.0) as srv:
        x = _rows(1, dim=3)[0]
        o = srv.predict(x, timeout=30)
    assert o.dtype == np.float32 and torch.bfloat16 in seen
    np.testing.assert_allclose(o, x * 2.0, rtol=2 ** -8)


def _names(text):
    out = set()
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name = line.split("{")[0].split(" ")[0]
        if name.startswith(("mx_serve_", "mx_prefix_", "mx_fleet_")) \
                and "{" not in line:
            out.add(name)
        elif name.startswith("mx_server_"):
            out.add(name)
    return out


def test_metrics_text_names_match_the_jax_package():
    jm, tm = _mlp_models()
    texts = []
    for serve_mod, model in ((jserve, jm), (tserve, tm)):
        with serve_mod.Server(model, batch_timeout_ms=1.0,
                              name="mlp") as srv:
            wait([srv.submit(x) for x in _rows(5)], timeout=30)
            texts.append((serve_mod.metrics_text(), srv.metrics_text()))
    (jtext, jsrv), (ttext, tsrv) = texts
    assert _names(ttext) == _names(jtext)
    assert _names(tsrv) == _names(jsrv)
    assert "mx_serve_replies" in _names(ttext)
    assert 'mx_server_queue_depth{server="mlp"}' in tsrv


def test_metrics_server_serves_the_text():
    import urllib.request
    srv = tserve.start_metrics_server(0)
    try:
        port = srv.server_address[1]
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                      timeout=10).read().decode()
        assert "mx_serve_requests" in body and "mx_fleet_swaps" in body
    finally:
        srv.shutdown()
        srv.server_close()


def test_warmup_runs_on_the_batcher_thread_and_its_error_raises():
    """Every bucket runs once on the thread that serves the batches (its
    library handles are its own) before start() returns; a warm-up that
    fails raises from start() and leaves the server unstarted."""
    import threading
    threads = []

    def fn(x):
        threads.append(threading.current_thread().name)
        return x * 2.0

    model = tserve.CallableModel(fn, (1, 2), [((3,), "float32")],
                                 device="cpu")
    with tserve.Server(model, name="warm") as srv:
        assert threads == ["warm-batcher"] * 2
        assert srv.stats()["programs_compiled"] == 2
        srv.predict(np.ones(3, np.float32), timeout=30)
    assert set(threads) == {"warm-batcher"}

    def bad(x):
        raise ValueError("no warm-up")

    srv = tserve.Server(tserve.CallableModel(bad, (1,), [((3,), "float32")],
                                             device="cpu"))
    with pytest.raises(ValueError, match="no warm-up"):
        srv.start()
    with pytest.raises(tserve.ServeError, match="start"):
        srv.submit(np.ones(3, np.float32))
