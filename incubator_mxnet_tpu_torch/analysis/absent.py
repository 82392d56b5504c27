"""What the port deliberately leaves out of the documented surface.

The registry-consistency pass holds the port against the JAX package's
docs (docs/ENV_VARS.md, docs/RESILIENCE.md, docs/OBSERVABILITY.md). Each
knob, fault point, metric and census owner named there that the port does
not serve is listed here, with the queue that brings it (ROADMAP.md §A)
or the reason it stays out. The pass counts a listed name as accounted
for, and reports an entry as stale once the port serves the name or no
doc row names it any more. Only the keys are read by the pass; the values
are for people.
"""

_A10 = ("A10 (distributed over torch.distributed): the port has no "
        "kvstore, launcher or elastic trainer yet")
_A10_KNOB = ("A10: a knob of the multi-process launcher, kvstore or "
             "elastic trainer, which the port does not have yet")
_A1 = ("A1 (the port's benchmark): a knob of the JAX package's bench.py "
       "harness; the port has no benchmark harness yet")
_A3 = ("A3 (the serving compile fields): the port's KV pool carves its "
       "slabs without the JAX package's kvpool.* group or census owner")
_PARITY = ("registered in the JAX package's env table for the "
           "reference's parity and read nowhere there; the port's "
           "base.py registers only the flags it reads")
_NO_BULK = ("absent by design: the port dispatches every op eagerly "
            "through torch, with no op bulking (ops/segment.py, a "
            "deliberate difference) and no jit, so there is no key, jit, "
            "vjp, aval, amp-wrap or replay cache and no segment to flush")

ABSENT_ENV = {
    "MXNET_COORDINATOR": _A10_KNOB,
    "MXNET_NUM_PROCESSES": _A10_KNOB,
    "MXNET_PROCESS_ID": _A10_KNOB,
    "MXNET_KVSTORE_BIGARRAY_BOUND": _A10_KNOB,
    "MXNET_KVSTORE_BARRIER_TIMEOUT": _A10_KNOB,
    "MXNET_KV_BARRIER_TIMEOUT": _A10_KNOB,
    "MXNET_ELASTIC_COLLECTIVE_TIMEOUT": _A10_KNOB,
    "MXNET_ELASTIC_COLLECTIVE_RETRIES": _A10_KNOB,
    "MXNET_BENCH_PHASE_TIMEOUT": _A1,
    "MXNET_BENCH_FAULT_PHASE": _A1,
    "MXNET_DISPATCH_JIT": (
        "not ported: it switches the JAX package's compiled-kernel fast "
        "path of the eager dispatcher, and the port has no jit "
        "(ops.registry.set_dispatch_jit is not ported either, ROADMAP A5)"),
    "MXNET_USE_FUSION": (
        "not ported: the kill switch of the JAX package's fused tier; the "
        "port took it out so that no knob can move the main path off its "
        "kernels B1-B3 (ROADMAP A5)"),
    "MXNET_FUSION_INTERPRET": (
        "not ported: it runs the JAX package's Pallas kernels in "
        "interpret mode; the port's CUDA kernels have no interpret mode "
        "and a CPU tensor takes the plain version (ROADMAP A5)"),
    "MXNET_BULK_DONATE": (
        "not ported: it donates buffers of bulked-segment programs, and "
        "the port has neither bulking nor donation (ROADMAP A5)"),
    "MXNET_EXEC_BULK_EXEC_TRAIN": _PARITY,
    "MXNET_SAFE_ACCUMULATION": _PARITY,
    "MXNET_PROFILER_MODE": _PARITY,
    "MXNET_PROFILER_AUTOSTART": _PARITY,
    "MXNET_STORAGE_FALLBACK_LOG_VERBOSE": _PARITY,
}

ABSENT_POINTS = {
    "kvstore.push": _A10,
    "kvstore.pull": _A10,
    "kvstore.collective": _A10,
    "kvstore.reduce_scatter": _A10,
    "kvstore.allgather": _A10,
    "elastic.resume": _A10,
    "elastic.step": _A10,
    "elastic.loss": _A10,
    "engine.flush": (
        "deliberate: kept in fault.POINTS but never fires, since the "
        "port's engine runs every op eagerly with no bulked segment to "
        "flush (test_engine_flush_never_fires)"),
}

ABSENT_METRICS = {
    "dispatch.bulked": _NO_BULK,
    "dispatch.fast_path": _NO_BULK,
    "dispatch.key_cache_hit": _NO_BULK,
    "dispatch.key_cache_miss": _NO_BULK,
    "dispatch.jit_cache_hit": _NO_BULK,
    "dispatch.jit_cache_miss": _NO_BULK,
    "dispatch.vjp_cache_hit": _NO_BULK,
    "dispatch.vjp_cache_miss": _NO_BULK,
    "dispatch.vjp_trace": _NO_BULK,
    "dispatch.amp_wrap_cache_hit": _NO_BULK,
    "dispatch.amp_wrap_cache_miss": _NO_BULK,
    "dispatch.replay_cache_hit": _NO_BULK,
    "dispatch.replay_cache_miss": _NO_BULK,
    "dispatch.aval_cache_hit": _NO_BULK,
    "dispatch.aval_cache_miss": _NO_BULK,
    "dispatch.segment_flush": _NO_BULK,
    "kvpool.claims": _A3,
    "kvpool.frees": _A3,
    "kvpool.exhausted": _A3,
    "kvpool.slab_bytes": _A3,
    "kvstore.allreduce_us": _A10,
    "kvstore.allreduce_buckets": _A10,
    "kvstore.allreduce_bytes": _A10,
    "kvstore.reduce_scatter_us": _A10,
    "kvstore.reduce_scatter_buckets": _A10,
    "kvstore.reduce_scatter_bytes": _A10,
    "kvstore.allgather_us": _A10,
    "kvstore.allgather_buckets": _A10,
    "kvstore.allgather_bytes": _A10,
    "elastic.steps": _A10,
    "elastic.resumes": _A10,
    "elastic.mesh_shrinks": _A10,
    "elastic.skipped_nonfinite": _A10,
    "elastic.collective_retries": _A10,
    "elastic.resume_latency_us": _A10,
    "elastic.mem_per_replica_bytes": _A10,
    "elastic.dp": _A10,
}

ABSENT_OWNERS = {
    "kv_pool": _A3,
    "decoder_params": (
        "A3: the continuous engine's weights are not registered with the "
        "census yet; they come with the serving compile fields"),
    "train_step": (
        "A2 (captured steps): the JAX package registers its compiled "
        "FusedTrainStep's state; the port's step compiles no program"),
    "optimizer_shards": (
        "A10: the ZeRO-sharded optimizer state (optimizer/sharded.py) "
        "needs several cards"),
    "elastic_params": _A10,
}
