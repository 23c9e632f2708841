"""Latency-fault chaos harness for the serving stack.

Robustness claims (deadline propagation, hedged dispatch, the retry
ladder) are only as believable as the faults they were demonstrated
against.  This module injects the tail-producing faults the paper's
straggler experiments assume, at the two layers the repo executes on:

* **Real engines** (`InferenceEngine` + `EngineBridge` pump): an
  injector installed as ``engine.chaos`` is called by ``step()`` before
  each batched step — outside the engine lock — and can slow every step
  (a straggler replica), stall periodically (a stuck pump), add seeded
  jitter, or pin KV pages to create allocation pressure
  (``paged_append_failures`` / admission aborts downstream).

* **Emulated instances** (SimKernel): wall-clock sleeps would break
  virtual-time determinism, so stragglers are modeled by wrapping the
  instance's ``LatencyModel`` with :class:`ScaledLatency` — same seeded
  RNG discipline as the rest of the emulator, bit-identical across runs.

Every injector keeps counters (``steps``, ``stalls``,
``injected_delay_s``) so benchmarks can report exactly how much fault
was injected alongside what the serving stack did about it.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..core.executor import EmulatedMethod, LatencyModel
from .kv_cache import PagedKVPool

_HOLD_SID = "__chaos_hold"


@dataclass
class ChaosSpec:
    """Fault recipe for one engine replica.

    All delays are wall-clock seconds (the engine pump runs in wall
    time).  ``step_delay_s`` is the straggler knob: it stretches every
    decode step, which is how a slow replica actually presents (every
    request on it is slow, the siblings are fine).
    """

    step_delay_s: float = 0.0     # added to every step (straggler replica)
    jitter_s: float = 0.0         # + uniform[0, jitter_s) seeded noise
    stall_every: int = 0          # every Nth step additionally...
    stall_s: float = 0.0          # ...sleeps this long (stuck pump)
    hold_pages: int = 0           # KV pages pinned away from the pool
    seed: int = 0


class ChaosInjector:
    """Installed as ``engine.chaos``; ``before_step`` runs per step."""

    def __init__(self, spec: ChaosSpec) -> None:
        self.spec = spec
        self.rng = random.Random(spec.seed)
        self._lock = threading.Lock()
        self.enabled = True
        self.steps = 0
        self.stalls = 0
        self.injected_delay_s = 0.0
        self._pages_held = False

    def before_step(self, engine) -> None:
        with self._lock:
            if not self.enabled:
                return
            self.steps += 1
            sp = self.spec
            delay = sp.step_delay_s
            if sp.jitter_s > 0:
                delay += self.rng.uniform(0.0, sp.jitter_s)
            if sp.stall_every and self.steps % sp.stall_every == 0:
                delay += sp.stall_s
                self.stalls += 1
            if sp.hold_pages > 0 and not self._pages_held:
                self._hold_pages(engine)
        if delay > 0:
            time.sleep(delay)
            with self._lock:
                self.injected_delay_s += delay

    def _hold_pages(self, engine) -> None:
        """Pin ``hold_pages`` pages on a synthetic protected session so the
        pool runs that much closer to exhaustion (allocation-pressure
        fault).  Caller holds ``self._lock``."""
        pool = engine.pool
        if not isinstance(pool, PagedKVPool):
            return
        tokens = self.spec.hold_pages * pool.page_size
        if pool.allocate(_HOLD_SID, tokens, now=time.monotonic()):
            pool.protect(_HOLD_SID)
            self._pages_held = True

    def stop(self, engine=None) -> None:
        """Disable injection and release any held pages."""
        with self._lock:
            self.enabled = False
            held = self._pages_held
            self._pages_held = False
        if held and engine is not None:
            pool = engine.pool
            pool.unprotect(_HOLD_SID)
            pool.release(_HOLD_SID)

    def telemetry(self) -> Dict[str, Any]:
        with self._lock:
            return {"steps": self.steps, "stalls": self.stalls,
                    "injected_delay_s": round(self.injected_delay_s, 4),
                    "pages_held": (self.spec.hold_pages
                                   if self._pages_held else 0)}


def inject_engine(engine, spec: ChaosSpec) -> ChaosInjector:
    """Attach a fault injector to one engine replica; returns it so the
    caller can ``stop()`` / read ``telemetry()``."""
    inj = ChaosInjector(spec)
    engine.chaos = inj
    return inj


def clear_engine(engine) -> None:
    inj = getattr(engine, "chaos", None)
    if inj is not None:
        inj.stop(engine)
    engine.chaos = None


# ------------------------------------------------- emulated-layer faults
@dataclass
class ScaledLatency(LatencyModel):
    """A LatencyModel stretched by ``factor`` plus ``extra`` seconds —
    the SimKernel-deterministic straggler: virtual service time scales,
    the seeded RNG stream is the inner model's own."""

    inner: LatencyModel
    factor: float = 1.0
    extra: float = 0.0

    def service_time(self, hints: List[dict], rng: random.Random) -> float:
        return self.inner.service_time(hints, rng) * self.factor + self.extra


def slow_instance(runtime, instance_id: str, factor: float = 10.0,
                  extra: float = 0.0) -> int:
    """Turn one emulated instance into a straggler: every EmulatedMethod's
    latency model is wrapped in :class:`ScaledLatency`.  Deterministic
    under SimKernel.  Returns the number of methods slowed (0 if the
    instance is unknown or engine-backed)."""
    inst = runtime.instance(instance_id)
    if inst is None:
        return 0
    # the methods dict is shared across the agent type's instances (it
    # comes from the AgentSpec); copy-on-write so only this replica slows
    inst.methods = dict(inst.methods)
    n = 0
    for name, method in list(inst.methods.items()):
        if isinstance(method, EmulatedMethod):
            inst.methods[name] = EmulatedMethod(
                latency=ScaledLatency(method.latency, factor=factor,
                                      extra=extra),
                value_fn=method.value_fn)
            n += 1
    return n


def restore_instance(runtime, instance_id: str) -> int:
    """Undo :func:`slow_instance`.  Returns the number of methods restored."""
    inst = runtime.instance(instance_id)
    if inst is None:
        return 0
    n = 0
    for name, method in list(inst.methods.items()):
        if (isinstance(method, EmulatedMethod)
                and isinstance(method.latency, ScaledLatency)):
            inst.methods[name] = EmulatedMethod(
                latency=method.latency.inner, value_fn=method.value_fn)
            n += 1
    return n
