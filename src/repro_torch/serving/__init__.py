from .batching import (EngineOverloaded, Request, RequestExpired, WaitQueue,
                       bucket_len)
from .bridge import (EngineBridge, EngineMethod, GenerationResult,
                     hash_tokenize, register_engine_agent)
from .chaos import (ChaosInjector, ChaosSpec, ScaledLatency, clear_engine,
                    inject_engine, restore_instance, slow_instance)
from .engine import EngineMetrics, InferenceEngine, get_slot, set_slot
from .kv_cache import PagedKVPool, SessionPages, StateCachePool
from .pool import EnginePool, register_engine_pool
from .sampler import SamplingParams, sample

__all__ = ["ChaosInjector", "ChaosSpec", "EngineBridge", "EngineMethod",
           "EngineMetrics", "EngineOverloaded", "EnginePool",
           "GenerationResult", "InferenceEngine", "PagedKVPool", "Request",
           "RequestExpired", "SamplingParams", "ScaledLatency",
           "SessionPages", "StateCachePool", "WaitQueue",
           "bucket_len", "clear_engine", "get_slot", "hash_tokenize",
           "inject_engine", "register_engine_agent", "register_engine_pool",
           "restore_instance", "sample", "set_slot", "slow_instance"]
