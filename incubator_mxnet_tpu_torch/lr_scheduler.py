"""Learning-rate schedulers of the PyTorch port.

Counterpart of `incubator_mxnet_tpu/lr_scheduler.py`, rule for rule: the
port keeps its own copy of this host-side arithmetic. `LRScheduler` (with
linear or constant warmup), `FactorScheduler`, `MultiFactorScheduler`,
`PolyScheduler` and `CosineScheduler`; a scheduler maps the optimizer's
update count to a learning rate (`optimizer.Optimizer(lr_scheduler=...)`).
"""
from __future__ import annotations

import math

from .base import MXNetError

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0.0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        if warmup_mode not in ("linear", "constant"):
            raise MXNetError(f"invalid warmup_mode {warmup_mode!r}")
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        if self.warmup_mode == "linear":
            increase = ((self.warmup_final_lr - self.warmup_begin_lr)
                        * num_update / max(self.warmup_steps, 1))
            return self.warmup_begin_lr + increase
        return self.warmup_begin_lr

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        return self.base_lr


class FactorScheduler(LRScheduler):
    """lr *= factor every `step` updates (never below `stop_factor_lr`)."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0.0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if step < 1:
            raise MXNetError("step must be >= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0
        self._cur_lr = base_lr

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while num_update > self.count + self.step:
            self.count += self.step
            self._cur_lr = max(self._cur_lr * self.factor, self.stop_factor_lr)
        return self._cur_lr


class MultiFactorScheduler(LRScheduler):
    def __init__(self, step, factor=1.0, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0.0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not all(step[i] < step[i + 1] for i in range(len(step) - 1)):
            raise MXNetError("steps must be increasing")
        self.step = step
        self.factor = factor

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        lr = self.base_lr
        for s in self.step:
            if num_update > s:
                lr *= self.factor
        return lr


class PolyScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0.0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.power = pwr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = max_update - warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update >= self.max_update:
            return self.final_lr
        frac = (num_update - self.warmup_steps) / max(self.max_steps, 1)
        return (self.final_lr + (self.base_lr - self.final_lr)
                * pow(1 - frac, self.power))


class CosineScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0.0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = max_update - warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update >= self.max_update:
            return self.final_lr
        frac = (num_update - self.warmup_steps) / max(self.max_steps, 1)
        return (self.final_lr + (self.base_lr - self.final_lr)
                * (1 + math.cos(math.pi * frac)) / 2)
