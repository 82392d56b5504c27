"""PyTorch port: `io.DeviceFeed` / `prefetch_to_device` / `PrefetchingIter`
on the CPU — order, depth, the source's exception re-raised in the
consumer, restarts of transient errors within their budget, close/reset,
and the CPU alias copy (a numpy buffer the source rewrites is copied, never
aliased) — each against the JAX package's feed over the same source where
both run. Values are exact."""
import threading
import time

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import io as jio
from incubator_mxnet_tpu_torch import MXNetError, NDArray
from incubator_mxnet_tpu_torch import io as tio

torch.set_num_threads(1)


def _source(n=6):
    rng = np.random.RandomState(0)
    return [(rng.randn(3, 4).astype(np.float32), np.int32(i))
            for i in range(n)]


def _values(batches):
    return [(np.asarray(x.asnumpy()), int(np.asarray(y.asnumpy())))
            for x, y in batches]


def test_order_and_values_match_the_jax_packages_feed():
    src = _source()
    want = _values(jio.DeviceFeed(iter(src), depth=2))
    feed = tio.DeviceFeed(iter(src), depth=2, device="cpu")
    got = list(feed)
    assert all(isinstance(x, NDArray) and x._t.device.type == "cpu"
               for x, _ in got)
    for (a, i), (b, j) in zip(want, _values(got)):
        np.testing.assert_array_equal(a, b)
        assert i == j
    assert len(got) == len(want) == 6


def test_nested_batches_keep_their_structure():
    from collections import namedtuple
    P = namedtuple("P", "x y")
    src = [{"a": [np.ones(2, np.float32), P(np.zeros(1), "tag")], "b": 3}]
    (got,) = list(tio.DeviceFeed(iter(src), device="cpu"))
    assert isinstance(got["a"][1], P) and got["a"][1].y == "tag"
    assert got["b"] == 3
    np.testing.assert_array_equal(got["a"][0].asnumpy(), [1.0, 1.0])


def test_depth_bounds_the_batches_staged_ahead():
    pulled = []

    def gen():
        for i in range(20):
            pulled.append(i)
            yield np.full(2, i, np.float32)

    feed = tio.DeviceFeed(gen(), depth=3, device="cpu")
    it = iter(feed)
    first = next(it)
    time.sleep(0.3)
    # one consumed, depth buffered, one more fetched while the feeder waits
    assert len(pulled) <= 1 + 3 + 1
    assert first.asnumpy()[0] == 0
    feed.close()
    with pytest.raises(MXNetError, match=">= 1"):
        tio.DeviceFeed(iter([]), depth=0, device="cpu")


def test_the_sources_exception_is_reraised_in_the_consumer():
    def gen():
        yield np.zeros(2, np.float32)
        raise ValueError("bad shard")

    tio.feed_stats(reset=True)
    feed = tio.DeviceFeed(gen(), device="cpu")
    it = iter(feed)
    next(it)
    with pytest.raises(ValueError, match="bad shard"):
        next(it)
    with pytest.raises(StopIteration):     # stays exhausted
        next(it)
    assert tio.feed_stats()["failures"] == 1


class _Flaky:
    """A source whose fetches fail with OSError `fails` times in a row
    before each batch (a flaky file system): the retry re-fetches, so no
    batch is lost."""

    def __init__(self, n, fails):
        self.n, self.fails = n, fails

    def __iter__(self):
        self.i = 0
        self.left = self.fails
        return self

    def __next__(self):
        if self.i >= self.n:
            raise StopIteration
        if self.left:
            self.left -= 1
            raise OSError("transient")
        self.left = self.fails
        self.i += 1
        return np.full(1, self.i, np.float32)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_transient_errors_restart_within_the_budget(pkg):
    kw = {} if pkg == "jax" else {"device": "cpu"}
    mod = jio if pkg == "jax" else tio
    got = [float(b.asnumpy()[0]) for b in
           mod.DeviceFeed(_Flaky(4, 2), max_restarts=2, **kw)]
    assert got == [1.0, 2.0, 3.0, 4.0]
    with pytest.raises(OSError, match="transient"):
        list(mod.DeviceFeed(_Flaky(4, 3), max_restarts=2, **kw))


def test_prefetching_iter_restarts_and_reraises():
    class Src(jio.DataIter if False else tio.DataIter):
        def __init__(self):
            super().__init__(2)
            self.calls = 0

        def __iter__(self):
            return self

        def next(self):
            self.calls += 1
            if self.calls == 2:
                raise OSError("once")
            if self.calls > 4:
                raise StopIteration
            return tio.DataBatch([self.calls], [0])

    it = tio.PrefetchingIter(Src(), max_restarts=1)
    assert [b.data[0] for b in it] == [1, 3, 4]
    with pytest.raises(MXNetError, match="exactly ONE"):
        tio.PrefetchingIter([Src(), Src()])


def test_close_and_reset():
    class Resettable:
        batch_size = 2

        def __init__(self):
            self.resets = 0

        def __iter__(self):
            return iter([np.zeros(2, np.float32)] * 3)

        def __len__(self):
            return 3

        def reset(self):
            self.resets += 1

    src = Resettable()
    feed = tio.DeviceFeed(src, device="cpu")
    assert len(feed) == 3 and feed.batch_size == 2
    it = iter(feed)
    next(it)
    feed.reset()
    assert src.resets == 1 and feed._thread is None
    assert len(list(feed)) == 3           # a fresh epoch after the reset
    assert len(list(feed)) == 3           # and another
    feed.close()
    feed.close()                          # idempotent
    assert threading.active_count() < 50


def test_cpu_feed_copies_a_buffer_the_source_rewrites():
    buf = np.zeros(4, np.float32)

    def gen():
        for i in range(3):
            buf[:] = i                    # the same buffer, rewritten
            yield buf

    tio.feed_stats(reset=True)
    got = [b.asnumpy().copy() for b in list(tio.DeviceFeed(gen(), depth=3,
                                                           device="cpu"))]
    # every batch kept the values it had when staged
    assert [g[0] for g in got] == [0.0, 1.0, 2.0]
    st = tio.feed_stats()
    assert st["host_transfers"] == 3 and st["batches_consumed"] == 3


def test_maybe_device_put_counts_each_case():
    tio.feed_stats(reset=True)
    t = torch.ones(2)
    assert tio.maybe_device_put(t, "cpu") is t
    a = np.ones(2, np.float32)
    out = tio.maybe_device_put(a, "cpu")
    a[:] = 5
    assert out.tolist() == [1.0, 1.0]
    st = tio.feed_stats()
    assert st["device_put_skipped"] == 1 and st["host_transfers"] == 1


def test_mesh_placement_names_its_queue():
    with pytest.raises(MXNetError, match="A10"):
        tio.DeviceFeed(iter([]), sharding=object(), device="cpu")
    with pytest.raises(MXNetError, match="A10"):
        tio.prefetch_to_device(iter([]), sharding=object(), device="cpu")
    with pytest.raises(MXNetError, match="cuda"):
        next(iter(tio.DeviceFeed(iter([np.zeros(1)]))))   # the card


def test_feed_over_an_ndarray_iter_stages_databatches():
    from incubator_mxnet_tpu_torch import cpu
    x = np.arange(20, dtype=np.float32).reshape(10, 2)
    y = np.arange(10, dtype=np.float32)
    with cpu():
        src = tio.NDArrayIter(x, y, batch_size=4, last_batch_handle="pad")
        got = list(tio.prefetch_to_device(src, size=2, device="cpu"))
    want = list(jio.NDArrayIter(x, y, batch_size=4,
                                last_batch_handle="pad"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert isinstance(g, tio.DataBatch) and g.pad == w.pad
        np.testing.assert_array_equal(g.data[0].asnumpy(),
                                      w.data[0].asnumpy())
        np.testing.assert_array_equal(g.label[0].asnumpy(),
                                      w.label[0].asnumpy())
