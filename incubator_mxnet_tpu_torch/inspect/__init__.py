"""mx.inspect of the PyTorch port: memory observability and the roofline
offender report.

Counterpart of `incubator_mxnet_tpu/inspect/__init__.py`:
  * `inspect.memory`: the census, leak checks and OOM forensics;
  * `inspect.roofline`: the cost model (`classify`, `load_calibration`,
    `callable_cost`, and `kernel_cost`, the flops and bytes of one launch
    of each hand-written kernel);
  * `inspect.report`: `inspect_step(step, *args)` runs a step and ranks
    the units it launched (the port's kernel launches and aten ops)
    against the card's roofline, with each unit's device time from
    `torch.profiler` in measured mode; `render_markdown`, `dump_json`.

    from incubator_mxnet_tpu_torch import inspect as mxinspect
    report = mxinspect.inspect_step(step, x, y, measured=True)
    print(mxinspect.render_markdown(report))

CLI: `python tools/torch_offenders.py --model resnet18 --json out.json`.
Knobs: `MXNET_INSPECT_TOP_K`, `MXNET_INSPECT_MEASURED`,
`MXNET_INSPECT_CALIB`. The HLO parser (`inspect/hlo.py`) has no
counterpart: the port lowers no program, and `lower_any`,
`inspect_compiled`, `inspect_hlo_text` and `cost_analysis_summary` raise.

The roofline and report names load at first use, as the JAX package loads
its inspect package: importing them registers the MXNET_INSPECT_* knobs and
the `inspect.*` metrics.
"""
from __future__ import annotations

import importlib

from . import memory
from .memory import (memory_plan, plan_from_compiled, assert_donation,
                     collective_memory_plans, active_plans, note_plan,
                     tag, register, current_tag, registered_count, census,
                     census_diff, leakcheck, live_bytes, MemoryLeakError,
                     is_oom_error, on_oom, oom_report, dump_oom,
                     install_oom_hook)

_LAZY = {
    "roofline": ("roofline", None), "report": ("report", None),
    "classify": ("roofline", "classify"),
    "load_calibration": ("roofline", "load_calibration"),
    "callable_cost": ("roofline", "callable_cost"),
    "kernel_cost": ("roofline", "kernel_cost"),
    "cost_analysis_summary": ("roofline", "cost_analysis_summary"),
    "inspect_step": ("report", "inspect_step"),
    "inspect_compiled": ("report", "inspect_compiled"),
    "inspect_hlo_text": ("report", "inspect_hlo_text"),
    "render_markdown": ("report", "render_markdown"),
    "lower_any": ("report", "lower_any"),
    "class_name": ("report", "class_name"),
    "dump_json": ("report", "dump_json"),
}

__all__ = [
    "memory", "roofline", "report",
    "classify", "load_calibration", "callable_cost", "kernel_cost",
    "cost_analysis_summary", "inspect_step", "inspect_compiled",
    "inspect_hlo_text", "render_markdown", "lower_any", "class_name",
    "dump_json",
    "memory_plan", "plan_from_compiled", "assert_donation",
    "collective_memory_plans", "active_plans", "note_plan",
    "tag", "register", "current_tag", "registered_count", "census",
    "census_diff", "leakcheck", "live_bytes", "MemoryLeakError",
    "is_oom_error", "on_oom", "oom_report", "dump_oom",
    "install_oom_hook",
]


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    mod, attr = _LAZY[name]
    m = importlib.import_module(f"{__name__}.{mod}")
    return m if attr is None else getattr(m, attr)
