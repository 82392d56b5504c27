"""mx.context of the PyTorch port: the legacy Context API (≙
`incubator_mxnet_tpu/context.py`). MXNet 2.0 renamed Context to Device;
both names are kept."""
from .device import (Device, Context, cpu, gpu, tpu, num_gpus, num_tpus,
                     current_device, current_context, device_memory_info,
                     gpu_memory_info)

__all__ = ["Device", "Context", "cpu", "gpu", "tpu", "num_gpus", "num_tpus",
           "current_device", "current_context", "device_memory_info",
           "gpu_memory_info"]
