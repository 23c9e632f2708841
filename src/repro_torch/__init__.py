"""PyTorch/CUDA port of the Nalar serving stack.

A second package beside the JAX reference ``repro``: the same module
names, tensor layouts and parameter trees, with every TPU kernel on the
ported path rewritten by hand for Hopper (``csrc/``, bound in
``kernels/``).  It imports neither JAX nor anything of ``repro``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``, where each kernel's plain PyTorch version runs instead.
"""

from .configs import ModelConfig, get_config, get_smoke_config
from .device import resolve_device
from .interop import params_from_numpy
from .models import Model, build_model
from .serving import (EngineMetrics, InferenceEngine, PagedKVPool, Request,
                      SamplingParams)

__all__ = ["EngineMetrics", "InferenceEngine", "Model", "ModelConfig",
           "PagedKVPool", "Request", "SamplingParams", "build_model",
           "get_config", "get_smoke_config", "params_from_numpy",
           "resolve_device"]
