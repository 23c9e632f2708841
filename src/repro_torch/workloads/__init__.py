"""Workloads of the port: the baseline system configurations and the
router workflow, whose runtime builders put real ``InferenceEngine``
replicas behind Nalar agent types."""

from .baselines import BASELINES, SystemConfig, system_config
from .router import build_engine_runtime, build_pool_runtime, run_router

__all__ = ["BASELINES", "SystemConfig", "build_engine_runtime",
           "build_pool_runtime", "run_router", "system_config"]
