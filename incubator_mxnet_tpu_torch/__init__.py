"""incubator_mxnet_tpu_torch: the PyTorch/CUDA port of incubator_mxnet_tpu.

The JAX package `incubator_mxnet_tpu` is the reference; this package
follows its layout and names module by module, imports `torch` and never
JAX or the JAX package. Its entry points run on the card (`cuda`) unless
the caller passes `device="cpu"`. Every TPU (Pallas) kernel on a ported
path is a hand-written CUDA kernel here (`ops/csrc/`), built with `nvcc`
at first use.

Ported so far:
  * greedy continuous-batching serving (`serve`) on the paged-attention
    CUDA kernel;
  * ResNet v1 training through `gluon.contrib.FusedTrainStep`
    (`gluon.model_zoo.vision.resnet50_v1(layout="NHWC")`,
    `gluon.loss.SoftmaxCrossEntropyLoss`, `optimizer.SGD` with MXNet's
    momentum rule, `amp` bf16 autocast with the JAX package's op lists),
    whose fused tier runs on the CUDA kernels for the scale/shift/
    activation apply pass and the NHWC average pool's forward and
    backward;
  * transformer encoders and decoders (`gluon.nn.MultiHeadAttention`,
    `TransformerEncoderCell`, `TransformerDecoderCell`,
    `PositionalEmbedding`, `Embedding`, `LayerNorm`, `Dropout`), trained
    through `FusedTrainStep` with `optimizer.Adam`/`AdamW`, whose flash
    attention (`ops.attention.flash_attention`) runs on the CUDA kernels
    for the forward, the forward with log-sum-exp and the backward's dq
    and dk/dv sweeps;
  * the imperative training loop: `autograd` (record / pause scopes,
    `backward`, `grad`, grad_req write / add / null), `gluon.Parameter`
    with deferred initialization, `gluon.Trainer`, `lr_scheduler`, the
    JAX package's 18 optimizer rules, and float16 AMP with dynamic loss
    scaling (`amp.init("float16")`, `amp.scale_loss`); every CUDA kernel
    takes float32, bfloat16 and float16;
  * the Gluon script surface: every initializer (`initializer.Xavier`,
    `MSRAPrelu`, `Orthogonal`, `Mixed`, ...), every loss, `metric` (also
    `gluon.metric`), `gluon.utils`, `Block` with forward hooks and
    `summary`, the rest of `gluon.nn`, ResNet v2 and MobileNet v1/v2 with
    `get_model`, and `gluon.contrib.FusedInferStep`;
  * SSD300 detection (`ops.contrib`, the NMS sweep kernel), the rest of the
    vision zoo, `FusedTrainStep(remat=...)` and sparse `Embedding`;
  * the array frontend, MXNet 2.0's primary API: `NDArray` (a wrapper
    over one `torch.Tensor`), `np` (`mx.np`, with `np.linalg` and
    `np.random`), `npx` (`mx.npx`: the NN ops, the kernel ops over the
    CUDA kernels, control flow), `nd` (the legacy namespace), `cpu()`,
    `gpu()`, `tpu()` and `Device` / `Context` (`context`), `engine`,
    `waitall()` and `seed()`, every op dispatched through
    `ops.registry.invoke` with AMP by op name;
  * the input path: `recordio`, `io` (`ImageRecordIter` over a decode pool
    of native threads or shared-memory worker processes, `DeviceFeed`,
    `NDArrayIter`, `CSVIter`), `gluon.data` (datasets, samplers,
    `DataLoader`, vision datasets and transforms), and the card half of
    the image augment (`npx.fused_image_augment`, a CUDA kernel);
  * crash-consistent training: `fault` (injection points, retry,
    watchdog, `run_resilient`), `checkpoint` (the JAX package's npz and
    manifest, the port's own per-leaf sharded format), and the flagship
    transformer LM (`models.transformer`: a functional AdamW step that
    never writes its inputs);
  * deployment: `HybridBlock.export` (a `torch.export` program whose
    fused-tier kernels are custom-op nodes, the weights in `.params.npz`),
    `deploy.ExportedModel`, `gluon.SymbolBlock`, the dynamic-batching
    `serve.Server` over `serve.BucketedModel` / `CallableModel`, and
    `serve.Fleet`, a router over replica processes (`serve.replica`) with
    failover, respawn and a rolling swap;
  * observability: `telemetry` (the metrics registry every module's
    counters live in, spans, request tracing, the flight recorder,
    `StepTimeline` with MFU), `profiler` (Chrome traces merged with
    `torch.profiler`'s CUDA kernel records) and `inspect.memory` (the
    attributed census, leak checks, OOM dumps);
  * `tune` (the knob catalog, deployment profiles and the sweep) and
    `sanitize` (the in-place check, the recompile sentinel and the slot
    canary), loaded at first use (`mx.tune`, `mx.sanitize`) as the JAX
    package loads them, so the `tune` counters register when a knob site
    or a caller first needs them;
  * the Faster-RCNN / R-FCN op tail (`npx.roi_align`, `bilinear_resize2d`,
    `proposal`, whose sweep runs on the NMS kernels under the proposal
    op's IoU, `deformable_convolution`, `psroi_pooling`), the local
    pretrained-weight store (`gluon.model_zoo.model_store`, reading the
    zoo's `.npz` and the reference's `.params`), and `runtime`, `util`,
    `test_utils` and `visualization`, loaded at first use as the JAX
    package loads them.

Typical use:  import incubator_mxnet_tpu_torch as mx
"""
from .base import MXNetError, get_env, set_env, env_flags
from .device import (Device, Context, cpu, gpu, tpu, num_gpus, num_tpus,
                     current_device, current_context, device_memory_info,
                     gpu_memory_info, default_device, resolve_device)
from . import telemetry, profiler
from . import (amp, autograd, initializer, lr_scheduler, ops, optimizer,
               random, gluon, metric, serve)
from .ndarray import NDArray, waitall
from . import ndarray
from . import ndarray as nd
from . import numpy as np
from . import numpy_extension as npx
from . import context, engine
from . import io, recordio
from .random import seed
from . import fault, checkpoint, models, deploy
from . import inspect

__all__ = ["MXNetError", "get_env", "set_env", "env_flags",
           "default_device", "resolve_device",
           "Device", "Context", "cpu", "gpu", "tpu", "num_gpus", "num_tpus",
           "current_device", "current_context", "device_memory_info",
           "gpu_memory_info", "NDArray", "waitall", "seed", "ndarray", "nd",
           "np", "npx", "context", "engine",
           "amp", "autograd", "initializer", "lr_scheduler", "metric", "ops",
           "optimizer", "random", "gluon", "serve", "io", "recordio",
           "fault", "checkpoint", "models", "deploy", "telemetry",
           "profiler", "inspect"]

# loaded at first attribute access, as the JAX package's `_LAZY` modules
_LAZY = ("tune", "sanitize", "runtime", "util", "test_utils",
         "visualization")


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
