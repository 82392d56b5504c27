"""Estimator of the PyTorch port: a Keras-like fit loop with event
handlers.

Counterpart of `incubator_mxnet_tpu/gluon/contrib/estimator.py` (≙
python/mxnet/gluon/contrib/estimator/{estimator,event_handler}.py):
`Estimator.fit` with train / validation data, the event taxonomy
(TrainBegin / EpochBegin / BatchBegin / BatchEnd / EpochEnd / TrainEnd)
and the built-in handlers: StoppingHandler, MetricHandler,
ValidationHandler, LoggingHandler, CheckpointHandler, StepTimelineHandler
and EarlyStoppingHandler, with the JAX package's defaults, priorities and
event order. A batch is one `autograd.record()` forward and loss, a
backward from the loss's mean and `trainer.step(batch size)`.

Wiring: MXNET_PREFETCH_TO_DEVICE routes the loader through
`io.DeviceFeed` unless it feeds the device already or opted out;
MXNET_TELEMETRY (default on) attaches a `StepTimelineHandler(
auto_flops=False)` unless one is passed. Checkpoints are the JAX
package's files (`{prefix}-epoch{N}.params.npz`, `.states`,
`{prefix}-best.json`), saved under `fault.retrying` at the
`estimator.checkpoint` fault point, and load into either package.
"""
from __future__ import annotations

import logging
import os
import time

import numpy as _np

from .. import metric as metric_mod
from ..trainer import Trainer

__all__ = ["Estimator", "EventHandler", "TrainBegin", "TrainEnd",
           "EpochBegin", "EpochEnd", "BatchBegin", "BatchEnd",
           "StoppingHandler", "MetricHandler", "ValidationHandler",
           "LoggingHandler", "CheckpointHandler", "EarlyStoppingHandler",
           "StepTimelineHandler"]


class EventHandler:
    pass


class TrainBegin(EventHandler):
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd(EventHandler):
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin(EventHandler):
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd(EventHandler):
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin(EventHandler):
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd(EventHandler):
    def batch_end(self, estimator, *args, **kwargs):
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop at max_epoch/max_batch (≙ event_handler.StoppingHandler)."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.current_batch = 0
        self.current_epoch = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        # a CheckpointHandler resume fast-forwards the epoch budget so a
        # 10-epoch fit interrupted after 7 runs 3 more, not 10
        self.current_epoch = getattr(estimator, "_resume_epoch", 0)
        if self.max_epoch and self.current_epoch >= self.max_epoch:
            estimator.stop_training = True

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.max_batch and self.current_batch >= self.max_batch:
            estimator.stop_training = True

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.max_epoch and self.current_epoch >= self.max_epoch:
            estimator.stop_training = True


class MetricHandler(EpochBegin, BatchEnd):
    """Reset per epoch, update per batch (≙ event_handler.MetricHandler)."""

    def __init__(self, metrics, priority=-1000):
        self.metrics = metrics
        self.priority = priority

    def epoch_begin(self, estimator, *args, **kwargs):
        for m in self.metrics:
            m.reset()

    def batch_end(self, estimator, pred=None, label=None, loss=None,
                  **kwargs):
        for m in self.metrics:
            if isinstance(m, metric_mod.Loss):
                m.update(None, loss)
            else:
                m.update(label, pred)


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    """Run validation on a cadence (≙ event_handler.ValidationHandler)."""

    def __init__(self, val_data, eval_fn, epoch_period=1, batch_period=None,
                 priority=-1000):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.priority = priority
        self.current_batch = 0
        self.current_epoch = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and self.current_batch % self.batch_period == 0:
            self.eval_fn(self.val_data)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self.eval_fn(self.val_data)


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchEnd):
    """≙ event_handler.LoggingHandler."""

    def __init__(self, log_interval="epoch", metrics=None, priority=-3000):
        self.log_interval = log_interval
        self.metrics = metrics or []
        self.priority = priority
        self.batch_index = 0
        self.current_epoch = 0
        self.logger = logging.getLogger("estimator")

    def train_begin(self, estimator, *args, **kwargs):
        self.train_start = time.time()
        self.logger.info("Training begin")

    def train_end(self, estimator, *args, **kwargs):
        self.logger.info("Training done in %.1fs",
                         time.time() - self.train_start)

    def epoch_begin(self, estimator, *args, **kwargs):
        self.batch_index = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.batch_index += 1
        if self.log_interval != "epoch" and \
                self.batch_index % int(self.log_interval) == 0:
            self._log()

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        self._log()

    def _log(self):
        msgs = [f"[epoch {self.current_epoch} batch {self.batch_index}]"]
        for m in self.metrics:
            name, value = m.get()
            msgs.append(f"{name}={value:.4f}"
                        if isinstance(value, float) else f"{name}={value}")
        self.logger.info(" ".join(msgs))


class CheckpointHandler(TrainBegin, BatchEnd, EpochEnd):
    """Periodic + best-only checkpointing (≙ event_handler.CheckpointHandler)."""

    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 verbose=0, save_best=False, mode="auto", epoch_period=1,
                 batch_period=None, max_checkpoints=5,
                 resume_from_checkpoint=False):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.save_best = save_best
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.current_epoch = 0
        self.current_batch = 0
        if mode == "auto":
            mode = "min" if monitor is not None and \
                "loss" in monitor.get()[0] else "max"
        self.mode = mode
        self.best = _np.inf if mode == "min" else -_np.inf
        self.resume_from_checkpoint = resume_from_checkpoint

    def train_begin(self, estimator, *args, **kwargs):
        os.makedirs(self.model_dir, exist_ok=True)
        if self.resume_from_checkpoint:
            self._resume(estimator)

    def _resume(self, estimator):
        """Load the newest epoch checkpoint in model_dir (params + trainer
        states) so an interrupted fit continues instead of restarting."""
        import re
        pat = re.compile(
            re.escape(self.model_prefix) + r"-epoch(\d+)\.params\.npz$")
        found = [(int(m.group(1)), m.group(0))
                 for m in map(pat.match, sorted(os.listdir(self.model_dir)))
                 if m]
        if not found:
            return
        epoch, name = max(found)
        path = os.path.join(self.model_dir, name)
        estimator.net.load_parameters(path)
        if estimator.trainer is not None and os.path.exists(path + ".states"):
            estimator.trainer.load_states(path + ".states")
        self.current_epoch = epoch
        estimator._resume_epoch = epoch  # StoppingHandler shortens the run
        best_meta = os.path.join(self.model_dir,
                                 f"{self.model_prefix}-best.json")
        if self.save_best and os.path.exists(best_meta):
            import json
            with open(best_meta) as f:
                self.best = json.load(f)["value"]
        estimator.logger.info("resumed from checkpoint %s (epoch %d)",
                              path, epoch)

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and self.current_batch % self.batch_period == 0:
            self._save(estimator, f"batch{self.current_batch}")

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self._save(estimator, f"epoch{self.current_epoch}")

    def _save(self, estimator, tag):
        # retried: a transient I/O failure must not kill a long fit, and the
        # atomic writes underneath guarantee no torn checkpoint either way
        from ... import fault as _fault

        @_fault.retrying(max_attempts=3, name="estimator.checkpoint")
        def _write():
            _fault.inject("estimator.checkpoint")
            if self.save_best and self.monitor is not None:
                _, value = self.monitor.get()
                improved = (value < self.best if self.mode == "min"
                            else value > self.best)
                if improved:
                    estimator.net.save_parameters(os.path.join(
                        self.model_dir,
                        f"{self.model_prefix}-best.params.npz"))
                    # persist the best value so a resumed fit does not
                    # clobber the best file with a worse model
                    import json
                    with _fault.atomic_output(
                            os.path.join(self.model_dir,
                                         f"{self.model_prefix}-best.json"),
                            mode="w") as f:
                        json.dump({"value": float(value),
                                   "mode": self.mode}, f)
                    # only after the write lands: a failed save must retry
                    # as still-improved, not silently skip the best file
                    self.best = value
            path = os.path.join(self.model_dir,
                                f"{self.model_prefix}-{tag}.params.npz")
            estimator.net.save_parameters(path)
            if estimator.trainer is not None:
                estimator.trainer.save_states(path + ".states")
        _write()


class StepTimelineHandler(TrainBegin, BatchBegin, BatchEnd, TrainEnd):
    """Per-step time attribution for a fit loop (telemetry.StepTimeline).

    Every batch runs inside a `telemetry.span("train.step")`, diffing the
    DeviceFeed stall clock and the kvstore allreduce clock around it, so
    after (and during) the run `estimator.step_timeline` answers "where
    did step time go" — data-stall vs compute vs (overlapped) H2D staging
    vs allreduce — plus a live-counter MFU when FLOPs are known.

    `flops_per_batch`: FLOPs of one train step. Default: on the first
    batch, count the forward's FLOPs over a real call
    (`telemetry.block_fwd_flops`) and use the conventional 3x (fwd + 2x
    bwd). Pass `flops_per_batch=None, auto_flops=False` to skip MFU.
    `peak_flops`: denominator; default `telemetry.device_peak_flops()`
    (None on CPU — MFU is then omitted rather than wrong).

    Attached automatically by `Estimator.fit` when `MXNET_TELEMETRY` is on
    (the default) unless the caller already passed one."""

    def __init__(self, flops_per_batch=None, peak_flops=None,
                 auto_flops=True, priority=-2000):
        self.flops_per_batch = flops_per_batch
        self.peak_flops = peak_flops
        self.auto_flops = auto_flops
        self.priority = priority
        self._tl = None
        self._step_cm = None
        # deferred-shape nets resolve on the FIRST forward, so the first
        # batch_begin can't cost-count yet — retry a few batches before
        # giving up on MFU for the run
        self._flops_tries = 3

    def train_begin(self, estimator, *args, **kwargs):
        from ... import telemetry
        self._close_step()       # a prior fit's exception-leaked step
        self._tl = telemetry.StepTimeline(
            flops_per_step=self.flops_per_batch,
            peak_flops=self.peak_flops)
        estimator.step_timeline = None

    def _close_step(self):
        if self._step_cm is not None:
            self._step_cm.__exit__(None, None, None)
            self._step_cm = None

    def batch_begin(self, estimator, batch=None, **kwargs):
        if self._tl is None:
            return
        # a step left open by an exception mid-batch (fit propagates, so
        # batch_end never fired) is closed here — the failed batch's time
        # is attributed and the span stack stays balanced
        self._close_step()
        if self.auto_flops and self._tl.flops_per_step is None \
                and batch is not None:
            # one counted forward per fit (memoized per net and batch
            # signature)
            try:
                from ... import telemetry
                x = batch[0] if isinstance(batch, (tuple, list)) else batch
                self._tl.flops_per_step = 3.0 * telemetry.block_fwd_flops(
                    estimator.net, x)
            except Exception:
                self._flops_tries -= 1
                if self._flops_tries <= 0:
                    self.auto_flops = False   # bounded: stop retrying
        self._step_cm = self._tl.step()
        self._step_cm.__enter__()

    def batch_end(self, estimator, *args, **kwargs):
        self._close_step()
        estimator.step_timeline = self._tl.report()

    def train_end(self, estimator, *args, **kwargs):
        self._close_step()
        if self._tl is not None and self._tl.steps:
            estimator.step_timeline = self._tl.report()
            estimator.logger.info("step timeline: %s",
                                  estimator.step_timeline)


class EarlyStoppingHandler(TrainBegin, EpochEnd, TrainEnd):
    """≙ event_handler.EarlyStoppingHandler."""

    def __init__(self, monitor, min_delta=0, patience=0, mode="auto",
                 baseline=None):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        if mode == "auto":
            mode = "min" if "loss" in monitor.get()[0] else "max"
        self.mode = mode
        self.baseline = baseline
        self.wait = 0
        self.best = _np.inf if mode == "min" else -_np.inf
        self.stopped_epoch = 0
        self.current_epoch = 0

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        _, value = self.monitor.get()
        if not isinstance(value, (int, float)) or _np.isnan(value):
            return
        improved = (value < self.best - self.min_delta if self.mode == "min"
                    else value > self.best + self.min_delta)
        if improved:
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = self.current_epoch
                estimator.stop_training = True


class Estimator:
    """≙ gluon.contrib.estimator.Estimator."""

    def __init__(self, net, loss, train_metrics=None, val_metrics=None,
                 trainer=None, context=None, device=None,
                 evaluation_loss=None):
        self.net = net
        self.loss = loss
        self.train_metrics = train_metrics or [metric_mod.Accuracy()]
        if not isinstance(self.train_metrics, (list, tuple)):
            self.train_metrics = [self.train_metrics]
        self.train_metrics = list(self.train_metrics)
        self.train_metrics.append(metric_mod.Loss("train_loss"))
        self.val_metrics = val_metrics or [
            metric_mod.create(type(m).__name__.lower())
            for m in self.train_metrics[:-1]]
        self.trainer = trainer or Trainer(net.collect_params(), "adam",
                                          {"learning_rate": 1e-3})
        self.evaluation_loss = evaluation_loss or loss
        self.stop_training = False
        self.logger = logging.getLogger("mxnet.estimator")
        self._resume_epoch = 0
        # written by StepTimelineHandler: per-step time attribution +
        # (when FLOPs are known) live-counter MFU for the last fit()
        self.step_timeline = None

    # ------------------------------------------------------------------
    def evaluate(self, val_data):
        from ... import autograd
        for m in self.val_metrics:
            m.reset()
        for batch in val_data:
            x, y = batch[0], batch[1]
            with autograd.predict_mode():
                pred = self.net(x)
            for m in self.val_metrics:
                m.update(y, pred)
        return {m.get()[0]: m.get()[1] for m in self.val_metrics}

    def fit(self, train_data, val_data=None, epochs=None, event_handlers=None,
            batches=None, batch_axis=0):
        from ... import autograd
        from ...base import get_env
        if epochs is None and batches is None:
            epochs = 1
        # MXNET_PREFETCH_TO_DEVICE: route batches through io.DeviceFeed so
        # host data prep + H2D for batch N+1 overlap batch N's step (the
        # feed re-iterates per epoch like any loader); skip when the loader
        # already feeds device batches (DeviceFeed, opted-in DataLoader) or
        # EXPLICITLY opted out (DataLoader(prefetch_to_device=False))
        if get_env("MXNET_PREFETCH_TO_DEVICE", False, typ=bool) and \
                not getattr(train_data, "_feeds_device", False) and \
                not getattr(train_data, "_prefetch_opt_out", False):
            from ...io.device_feed import DeviceFeed
            train_data = DeviceFeed(train_data, batch_axis=batch_axis)
        handlers = list(event_handlers or [])
        handlers.append(StoppingHandler(epochs, batches))
        handlers.append(MetricHandler(self.train_metrics))
        # step-timeline attribution (MXNET_TELEMETRY, default on): spans +
        # stall/compute split are near-free; MFU needs FLOPs, so the
        # auto-attached handler skips the extra cost-analysis compile —
        # pass StepTimelineHandler(auto_flops=True) (or flops_per_batch=)
        # to get mfu in estimator.step_timeline
        if get_env("MXNET_TELEMETRY", True, typ=bool) and \
                not any(isinstance(h, StepTimelineHandler)
                        for h in handlers):
            handlers.append(StepTimelineHandler(auto_flops=False))
        if val_data is not None:
            handlers.append(ValidationHandler(
                val_data, self.evaluate))
        handlers.sort(key=lambda h: getattr(h, "priority", 0))
        self.stop_training = False
        # stale resume state from a previous fit() must not shorten this
        # one; a CheckpointHandler resume re-sets it during train_begin
        self._resume_epoch = 0

        def emit(kind, **kw):
            for h in handlers:
                fn = getattr(h, kind, None)
                if fn is not None:
                    fn(self, **kw)

        emit("train_begin")
        while not self.stop_training:
            emit("epoch_begin")
            for batch in train_data:
                if self.stop_training:
                    break
                x, y = batch[0], batch[1]
                emit("batch_begin", batch=batch)
                with autograd.record():
                    pred = self.net(x)
                    loss = self.loss(pred, y)
                    loss_scalar = loss.mean()
                loss_scalar.backward()
                batch_size = x.shape[batch_axis]
                self.trainer.step(batch_size)
                emit("batch_end", pred=pred, label=y, loss=loss_scalar)
            emit("epoch_end")
        emit("train_end")
        return self
