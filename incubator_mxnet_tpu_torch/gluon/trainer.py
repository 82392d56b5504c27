"""`gluon.Trainer` of the PyTorch port: applies an optimizer to a net's
Parameters from the gradients a backward left in them.

Counterpart of `incubator_mxnet_tpu/gluon/trainer.py`::

    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    with autograd.record():
        loss = loss_fn(net(x), y)
    autograd.backward(loss)
    trainer.step(batch_size)      # gradients / batch_size, then the update

`step` rescales the gradients by 1 / batch_size (times the
`rescale_grad` given), skips Parameters with grad_req "null", and refuses
a gradient no backward refreshed since the last step unless
`ignore_stale_grad`. A sparse-gradient Embedding's weight
(`nn.Embedding(sparse_grad=True)`) gets the touched-rows update: the
optimizer's own rule on the rows its recorded forwards touched since the
last update, gathered with their gradient and state rows and scattered
back; untouched rows get no weight decay and no momentum aging (MXNet's
lazy update). One card needs no reduction: `kvstore` None, "local"
or "device" reduces nothing; a distributed store ("dist_*") raises until
the port has several processes (ROADMAP A10). `save_states` writes the
JAX package's pickle layout, so either package loads the other's file.
"""
from __future__ import annotations

import pickle

import torch

from .. import autograd
from .. import optimizer as opt_mod
from ..base import MXNetError
from ..fault import atomic_output
from .parameter import Parameter

__all__ = ["Trainer"]

_LOCAL_STORES = ("local", "device")


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore=None, compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, dict):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("params must be the dict from "
                             "net.collect_params() or a list")
        self._params = []
        for p in params:
            if not isinstance(p, Parameter):
                raise MXNetError(f"invalid parameter {p!r}")
            self._params.append(p)
        if kvstore not in (None, False) + _LOCAL_STORES:
            if isinstance(kvstore, str) and kvstore.startswith("dist"):
                raise MXNetError(
                    f"kvstore {kvstore!r} reduces across processes, which "
                    f"the port does not run yet (ROADMAP A10); on one card "
                    f"use kvstore=None, 'local' or 'device'")
            raise MXNetError(f"kvstore {kvstore!r} is not supported by the "
                             f"port (None, 'local' or 'device')")
        if compression_params:
            raise MXNetError("compression_params requires a distributed "
                             "kvstore (ROADMAP A10)")
        if update_on_kvstore:
            raise MXNetError("update_on_kvstore needs a distributed kvstore "
                             "(ROADMAP A10)")
        optimizer_params = optimizer_params or {}
        self._scale = optimizer_params.get("rescale_grad", 1.0)
        self._init_optimizer(optimizer, optimizer_params)
        self._states = [None] * len(self._params)
        self._states_created = [False] * len(self._params)

    def _init_optimizer(self, optimizer, optimizer_params):
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params and set(optimizer_params) != {"rescale_grad"}:
                raise MXNetError("optimizer_params must be None when "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
        else:
            self._optimizer = opt_mod.create(optimizer, **optimizer_params)
        self._optimizer.param_dict = dict(enumerate(self._params))

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    # ------------------------------------------------------------------
    def step(self, batch_size, ignore_stale_grad=False):
        """Normalize the gradients by `batch_size`, reduce them (nothing
        to reduce on one card) and update every Parameter."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Reduce the gradients across devices: one card has nothing to
        reduce."""

    def update(self, batch_size, ignore_stale_grad=False):
        """`step` without the reduction."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        items = []
        for i, p in enumerate(self._params):
            if p.grad_req == "null" or p._data is None:
                continue
            var = autograd.variable(p._data)
            if var is not None and not var.fresh:
                if ignore_stale_grad:
                    # a skipped weight's touched rows must not carry over
                    # into a later update
                    p._last_tokens = None
                    continue
                raise MXNetError(
                    f"gradient of parameter {p.name} has not been updated by "
                    "backward since the last step; set ignore_stale_grad=True "
                    "to skip such parameters")
            if not self._states_created[i]:
                self._states[i] = \
                    self._optimizer.create_state_multi_precision(i, p._data)
                self._states_created[i] = True
            items.append((i, p._data, p.grad(), self._states[i]))
        for i, w, g, s in items:
            p = self._params[i]
            if p._sparse_grad and p._last_tokens is not None:
                self._row_sparse_update(i, p, s)
            else:
                self._optimizer.update_multi_precision(i, w, g, s)
        for _, w, _, _ in items:
            autograd.variable(w).fresh = False

    def _row_sparse_update(self, i, p, state):
        """The optimizer's rule on the unique touched rows of `p` (sorted,
        found on the device): weight, gradient and every weight-shaped
        state gathered, updated, scattered back."""
        tokens, p._last_tokens = p._last_tokens, None
        w, g = p._data, p.grad()
        idx = torch.unique(torch.cat([t.reshape(-1).to(w.device, torch.int64)
                                      for t in tokens]))
        rows = w.shape[0]

        def gather(s):
            if isinstance(s, (tuple, list)):
                return type(s)(gather(x) for x in s)
            if isinstance(s, torch.Tensor) and s.dim() and s.shape[0] == rows:
                return s[idx]
            return s

        def scatter(s, r):
            if isinstance(s, (tuple, list)):
                for a, b in zip(s, r):
                    scatter(a, b)
            elif isinstance(s, torch.Tensor) and s is not r:
                s.index_copy_(0, idx, r)

        with torch.no_grad():
            w_rows, s_rows = w[idx], gather(state)
            self._optimizer.update_multi_precision(i, w_rows, g[idx], s_rows)
            w.index_copy_(0, idx, w_rows)
            scatter(state, s_rows)

    def _mark_consumed(self):
        for p in self._params:
            var = autograd.variable(p._data) if p._data is not None else None
            if var is not None:
                var.fresh = False
            # a skipped update drops the touched rows with the gradient
            p._last_tokens = None

    # ------------------------------------------------------------------
    def save_states(self, fname):
        """Write the optimizer's update counts and states (numpy, by
        parameter index) as the JAX package's pickle, atomically."""
        payload = {
            "num_update": self._optimizer.num_update,
            "index_count": dict(self._optimizer._index_update_count),
            "states": {i: opt_mod.state_to_numpy(s)
                       for i, s in enumerate(self._states)
                       if self._states_created[i]},
        }
        with atomic_output(fname) as f:
            pickle.dump(payload, f)

    def load_states(self, fname):
        """Read a file `save_states` (of either package) wrote; each state
        goes to its Parameter's device."""
        with open(fname, "rb") as f:
            payload = pickle.load(f)
        self._optimizer.num_update = payload["num_update"]
        self._optimizer._index_update_count = dict(payload["index_count"])
        for i, s in payload["states"].items():
            i = int(i)
            p = self._params[i]
            dev = p._data.device if p._data is not None else None
            self._states[i] = opt_mod.state_from_numpy(s, dev)
            self._states_created[i] = True
