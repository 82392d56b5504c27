"""mx.inspect of the PyTorch port: memory observability.

Counterpart of `incubator_mxnet_tpu/inspect/__init__.py`, its memory half
(`inspect.memory`: the census, leak checks and OOM forensics). The
roofline profiler and its report (`inspect/roofline.py`,
`inspect/report.py`) are the tooling half of ROADMAP A11; the HLO parser
(`inspect/hlo.py`) has no PyTorch counterpart.
"""
from __future__ import annotations

from . import memory
from .memory import (memory_plan, plan_from_compiled, assert_donation,
                     collective_memory_plans, active_plans, note_plan,
                     tag, register, current_tag, registered_count, census,
                     census_diff, leakcheck, live_bytes, MemoryLeakError,
                     is_oom_error, on_oom, oom_report, dump_oom,
                     install_oom_hook)

__all__ = [
    "memory",
    "memory_plan", "plan_from_compiled", "assert_donation",
    "collective_memory_plans", "active_plans", "note_plan",
    "tag", "register", "current_tag", "registered_count", "census",
    "census_diff", "leakcheck", "live_bytes", "MemoryLeakError",
    "is_oom_error", "on_oom", "oom_report", "dump_oom",
    "install_oom_hook",
]
