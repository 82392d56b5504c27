"""Random state of the PyTorch port: one seeded `torch.Generator` per
device, which the ops that draw (dropout) take explicitly.

Counterpart of `incubator_mxnet_tpu/random.py` (`seed`, and `next_key` as
`generator`). PyTorch's generators do not give `jax.random`'s numbers from
the same seed, so tests that compare the two packages feed both the same
values or run without dropout.
"""
from __future__ import annotations

import torch

__all__ = ["seed", "generator"]

_STATE = {"seed": 0, "gens": {}}


def seed(seed_state=0):
    """Seed every device's generator afresh (≙ `mx.random.seed`)."""
    _STATE["seed"] = int(seed_state)
    _STATE["gens"] = {}


def generator(device):
    """The generator of `device`, made from the seed at first use."""
    dev = torch.device(device)
    key = (dev.type, dev.index if dev.index is not None else 0)
    gen = _STATE["gens"].get(key)
    if gen is None:
        gen = torch.Generator(device=torch.device(*key) if dev.type == "cuda"
                              else dev)
        gen.manual_seed(_STATE["seed"])
        _STATE["gens"][key] = gen
    return gen
