"""Agent/tool executors: instances, queues, latency models.

An *agent type* (e.g. ``developer``) has one or more *instances*
(``developer:node3/1``), each managed by a component-level controller.  Method
implementations come in three flavours:

* ``EmulatedMethod`` — a leaf component (LLM engine, vector store, web API)
  whose behaviour is a cheap Python ``value_fn`` and whose *cost* is a
  ``LatencyModel``.  Matches the paper's §6.3 methodology ("profiles LLM
  inference calls to mimic execution behavior").  Executed as a scheduled
  completion event — no thread.

* plain Python callables — composite agents whose body may itself invoke
  other agents/tools through stubs (Fig. 3).  Executed on a kernel driver
  thread; the instance stays busy for the whole span, which is exactly what
  produces the head-of-line blocking the paper's policies mitigate.

* ``EngineBackedMethod`` subclasses — leaf LLM calls executed on a *real*
  serving engine (``repro_torch.serving.InferenceEngine`` via
  ``repro_torch.serving.bridge.EngineMethod``).  The controller hands the future
  to the backend and moves on: the engine batches continuously on its own
  thread and resolves the future through a completion callback, so one
  instance carries up to ``capacity()`` in-flight futures at a time.  This
  is the real-execution counterpart of §6.3 emulation — same stub, same
  future, same routing; only the leaf executes for real.
"""

from __future__ import annotations

import math
import random
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from .directives import Directives


# ------------------------------------------------------------ latency models
class LatencyModel:
    def service_time(self, hints: List[dict], rng: random.Random) -> float:
        """Virtual seconds to process a batch; ``hints`` has one entry per item."""
        raise NotImplementedError


@dataclass
class FixedLatency(LatencyModel):
    seconds: float

    def service_time(self, hints, rng) -> float:
        return self.seconds


@dataclass
class LognormalLatency(LatencyModel):
    median: float
    sigma: float = 0.5

    def service_time(self, hints, rng) -> float:
        return self.median * math.exp(rng.gauss(0.0, self.sigma))


@dataclass
class LLMLatency(LatencyModel):
    """Token-based LLM cost model (vLLM-style continuous batching).

    time = base + in_tokens/prefill_tps + out_tokens/decode_tps, with batched
    requests sharing the engine at ``batch_efficiency`` scaling: a batch of B
    takes max_item_time * (1 + (B-1)*(1-eff)) — eff=1 is perfect batching.
    """

    prefill_tps: float = 8000.0
    decode_tps: float = 60.0
    base: float = 0.05
    batch_efficiency: float = 0.85
    jitter_sigma: float = 0.08

    def _item_time(self, hint: dict, rng: random.Random) -> float:
        tin = hint.get("in_tokens", 512)
        tout = hint.get("out_tokens", 128)
        t = self.base + tin / self.prefill_tps + tout / self.decode_tps
        if self.jitter_sigma:
            t *= math.exp(rng.gauss(0.0, self.jitter_sigma))
        return t

    def service_time(self, hints, rng) -> float:
        if not hints:
            return self.base
        times = [self._item_time(h, rng) for h in hints]
        b = len(times)
        return max(times) * (1.0 + (b - 1) * (1.0 - self.batch_efficiency))


@dataclass
class EmulatedMethod:
    """Leaf method: value from ``value_fn``, cost from ``latency``."""

    latency: LatencyModel
    value_fn: Optional[Callable[..., Any]] = None

    def compute(self, *args, **kwargs) -> Any:
        if self.value_fn is None:
            return None
        return self.value_fn(*args, **kwargs)


class EngineBackedMethod:
    """Abstract async leaf method executed on an external serving engine.

    Contract with the component controller:

    * ``launch(batch, controller)`` is called with futures whose dependencies
      are already materialized; it must return quickly (submission only) and
      arrange for ``controller.complete_async(fut, value=..., error=...)``
      to be invoked exactly once per future, from any thread.
    * The instance is NOT considered blocked while engine calls are in
      flight; the controller keeps admitting work until ``capacity()``
      futures are running on this instance (the engine's own continuous
      batching replaces controller-side batching).

    The concrete implementation lives in ``repro_torch.serving.bridge`` so that
    ``repro_torch.core`` stays importable without torch/serving dependencies.
    """

    def capacity(self) -> int:
        """Max futures in flight on one instance (engine batch width)."""
        return 8

    def launch(self, batch: List[Any], controller: Any) -> None:
        raise NotImplementedError


# ---------------------------------------------------------------- instances
@dataclass
class InstanceMetrics:
    completed: int = 0
    failed: int = 0
    # failure-handling telemetry: local re-attempts started here, futures
    # cancelled while queued/running here, and futures resolved
    # DeadlineExceeded at launch time here
    retries: int = 0
    cancelled: int = 0
    expired: int = 0
    busy_until: float = 0.0
    total_busy: float = 0.0
    queue_len: int = 0
    # exponential moving average of service time (global controller input)
    ema_service: float = 0.0
    last_latencies: List[float] = field(default_factory=list)

    def record_service(self, t: float) -> None:
        self.ema_service = 0.8 * self.ema_service + 0.2 * t if self.ema_service else t
        self.total_busy += t
        self.last_latencies.append(t)
        if len(self.last_latencies) > 64:
            self.last_latencies.pop(0)


class AgentInstance:
    """A running copy of an agent/tool on a node.

    Pure data + queue container; all *behaviour* lives in the component
    controller so the scheduling path is observable and policy-driven.
    """

    def __init__(self, agent_type: str, instance_id: str, node_id: str,
                 methods: Dict[str, Any], directives: Directives) -> None:
        self.agent_type = agent_type
        self.instance_id = instance_id        # "developer:n3/1"
        self.node_id = node_id
        self.methods = methods                # name -> EmulatedMethod | callable
        self.directives = directives
        self.queue: List[Any] = []            # ready futures awaiting dispatch
        self.running: List[Any] = []          # futures being executed now
        self.metrics = InstanceMetrics()
        self.alive = True
        self._lock = threading.RLock()
        # sessions with work waiting here (the HoL policy in Fig. 6 reads this)
        self.waiting_sessions: Dict[str, int] = {}

    # Queue ops are called only from the owning controller.
    def enqueue(self, fut) -> None:
        with self._lock:
            self.queue.append(fut)
            sid = fut.meta.session_id
            if sid:
                self.waiting_sessions[sid] = self.waiting_sessions.get(sid, 0) + 1
            self.metrics.queue_len = len(self.queue)

    def dequeue_selected(self, futs: List[Any]) -> None:
        with self._lock:
            for f in futs:
                self.queue.remove(f)
                sid = f.meta.session_id
                if sid and sid in self.waiting_sessions:
                    self.waiting_sessions[sid] -= 1
                    if self.waiting_sessions[sid] <= 0:
                        del self.waiting_sessions[sid]
            self.metrics.queue_len = len(self.queue)

    def remove_queued(self, fut) -> bool:
        with self._lock:
            if fut in self.queue:
                self.dequeue_selected([fut])
                return True
            return False

    def qsize(self) -> int:
        with self._lock:
            return len(self.queue)

    @property
    def busy(self) -> bool:
        with self._lock:
            return len(self.running) > 0

    def eta(self, now: float) -> float:
        """Estimated seconds until this instance is free (HoL signal).

        Emulated methods publish ``busy_until``; async engine-backed (and
        composite) methods don't, so in-flight futures are also charged at
        the EMA service rate — otherwise least-ETA routing is blind to a
        replica already carrying a full engine batch.
        """
        with self._lock:
            remaining = max(0.0, self.metrics.busy_until - now) if self.running else 0.0
            ema = max(self.metrics.ema_service, 1e-3)
            if self.running and remaining == 0.0:
                remaining = len(self.running) * ema
            return remaining + self.qsize() * ema

    def load_score(self, now: float) -> float:
        return self.eta(now)

    def __repr__(self) -> str:  # pragma: no cover
        return f"AgentInstance({self.instance_id}, q={self.qsize()}, busy={self.busy})"
