from .batching import (EngineOverloaded, Request, RequestExpired, WaitQueue,
                       bucket_len)
from .engine import EngineMetrics, InferenceEngine
from .kv_cache import PagedKVPool, SessionPages, StateCachePool
from .sampler import SamplingParams, sample

__all__ = ["EngineMetrics", "EngineOverloaded", "InferenceEngine",
           "PagedKVPool", "Request", "RequestExpired", "SamplingParams",
           "SessionPages", "StateCachePool", "WaitQueue", "bucket_len",
           "sample"]
