"""Virtual- and real-time event kernels for the NALAR runtime.

NALAR's control plane is event-driven (component controllers) plus periodic
(global controller).  The original system runs on wall-clock time across real
GPU nodes; this reproduction supports two interchangeable kernels:

* ``SimKernel`` — a deterministic discrete-event kernel.  Executors and
  controllers are pure event handlers; *driver programs* (ordinary Python
  workflow code, per the paper's programming model) run as real threads that
  block against virtual time.  Virtual time only advances when every driver
  thread is blocked, which makes workload benchmarks deterministic and lets a
  single CPU emulate minutes of cluster time in milliseconds.

* ``RealTimeKernel`` — wall-clock execution with ``threading.Timer``.  Used by
  the serving examples that drive actual torch computation.

Both expose the same interface: ``now()``, ``schedule(delay, fn)``,
``sleep(dt)``, ``wait_event(evt, timeout)``, and driver thread registration.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, Optional


class EventHandle:
    """Returned by ``SimKernel.schedule``; ``cancel()`` makes the event a
    no-op and releases its liveness contribution immediately."""

    __slots__ = ("fn", "periodic", "cancelled")

    def __init__(self, fn: Callable[[], None], periodic: bool) -> None:
        self.fn = fn
        self.periodic = periodic
        self.cancelled = False


class Kernel:
    """Interface shared by both kernels."""

    def now(self) -> float:
        raise NotImplementedError

    def schedule(self, delay: float, fn: Callable[[], None], *, tag: str = "",
                 periodic: bool = False) -> None:
        """``periodic=True`` marks housekeeping events (e.g. the global
        controller tick) that must not keep the simulation alive: the kernel
        quiesces when only periodic events remain and all drivers are blocked.
        """
        raise NotImplementedError

    def sleep(self, duration: float) -> None:
        raise NotImplementedError

    def wait_event(self, evt: threading.Event, timeout: Optional[float] = None) -> bool:
        raise NotImplementedError

    def spawn_driver(self, fn: Callable[[], None], name: str = "driver") -> threading.Thread:
        raise NotImplementedError

    def run(self) -> None:
        """Run until no events remain and all drivers have finished."""
        raise NotImplementedError


class SimKernel(Kernel):
    """Deterministic virtual-time kernel.

    Invariant: the simulator pops the next event only when ``_runnable == 0``,
    i.e. every registered driver thread is blocked in ``sleep``/``wait_event``
    (or has exited).  Events fire in (time, seq) order, so runs are
    reproducible regardless of OS thread scheduling.
    """

    def __init__(self) -> None:
        self._now = 0.0
        self._heap: list = []
        self._seq = itertools.count()
        self._lock = threading.RLock()   # re-entrant: wait_event schedules
        self._cv = threading.Condition(self._lock)
        self._runnable = 0          # driver threads currently executing
        self._drivers: list[threading.Thread] = []
        self._np_count = 0          # non-periodic events pending
        self._wake_queue: list = [] # deferred driver wakeups (determinism)
        self._stopping = False

    # ------------------------------------------------------------------ time
    def now(self) -> float:
        return self._now

    def schedule(self, delay: float, fn: Callable[[], None], *, tag: str = "",
                 periodic: bool = False) -> EventHandle:
        if delay < 0:
            delay = 0.0
        handle = EventHandle(fn, periodic)
        with self._lock:
            heapq.heappush(self._heap,
                           (self._now + delay, next(self._seq), handle, tag))
            if not periodic:
                self._np_count += 1
            self._cv.notify_all()
        return handle

    def cancel(self, handle: EventHandle) -> None:
        with self._lock:
            if not handle.cancelled:
                handle.cancelled = True
                if not handle.periodic:
                    self._np_count -= 1
                self._cv.notify_all()

    # --------------------------------------------------------------- drivers
    def spawn_driver(self, fn: Callable[[], None], name: str = "driver") -> threading.Thread:
        def body() -> None:
            try:
                fn()
            finally:
                with self._lock:
                    self._runnable -= 1
                    self._cv.notify_all()

        with self._lock:
            self._runnable += 1
        t = threading.Thread(target=body, name=name, daemon=True)
        self._drivers.append(t)
        t.start()
        return t

    def _block_driver(self) -> None:
        """Caller must hold the lock."""
        self._runnable -= 1
        self._cv.notify_all()

    def _unblock_driver_locked(self) -> None:
        self._runnable += 1

    def sleep(self, duration: float) -> None:
        evt = threading.Event()

        def wake() -> None:
            with self._lock:
                self._unblock_driver_locked()
            evt.set()

        self.schedule(duration, wake, tag="sleep-wake")
        with self._lock:
            self._block_driver()
        evt.wait()

    def wait_event(self, evt: threading.Event, timeout: Optional[float] = None) -> bool:
        """Block the driver thread until ``evt`` is set (in virtual time).

        The waker must call ``kernel.notify(evt)`` (below) rather than
        ``evt.set()`` directly so the runnable count stays consistent.
        """
        with self._lock:
            if evt.is_set():
                return True
            waiters = self._waiters_for(evt)
            me = threading.Event()
            deadline_fired = [False]
            timeout_handle: list = [None]
            waiters.append((me, timeout_handle))
            if timeout is not None:
                def timeout_fire() -> None:
                    with self._lock:
                        w = self._waiters_for(evt)
                        entry = next((x for x in w if x[0] is me), None)
                        if entry is None:
                            return
                        w.remove(entry)
                        deadline_fired[0] = True
                        self._unblock_driver_locked()
                    me.set()
                timeout_handle[0] = self.schedule(timeout, timeout_fire,
                                                  tag="wait-timeout")
            self._block_driver()
        me.wait()
        return not deadline_fired[0]

    def _waiters_for(self, evt: threading.Event) -> list:
        w = getattr(evt, "_sim_waiters", None)
        if w is None:
            w = []
            evt._sim_waiters = w  # type: ignore[attr-defined]
        return w

    def notify(self, evt: threading.Event) -> None:
        """Set ``evt`` and wake sim-blocked drivers waiting on it.

        Wakeups are DEFERRED to the simulator loop and delivered one driver
        at a time (the loop waits for each woken driver to block again
        before delivering the next).  This serialization makes runs
        deterministic: without it, simultaneously-woken driver threads race
        to schedule their next events and the event order depends on OS
        scheduling.  Safe to call from event handlers or driver threads.
        """
        with self._lock:
            evt.set()
            waiters = self._waiters_for(evt)
            pending = list(waiters)
            waiters.clear()
            for _me, th in pending:
                if th[0] is not None:
                    self.cancel(th[0])
            self._wake_queue.extend(me for me, _th in pending)
            self._cv.notify_all()

    # ------------------------------------------------------------------- run
    def run(self, max_time: float = float("inf"), max_events: int = 50_000_000) -> float:
        """Process events until quiescent.  Returns final virtual time."""
        events = 0
        while True:
            with self._lock:
                # Wait for all drivers to block (or exit).
                while self._runnable > 0:
                    self._cv.wait(timeout=30.0)
                if self._wake_queue:
                    # deliver exactly one deferred wakeup, then re-wait
                    me = self._wake_queue.pop(0)
                    self._unblock_driver_locked()
                    me.set()
                    continue
                if self._np_count == 0:
                    # Only periodic housekeeping (or nothing) remains and every
                    # driver is blocked/finished -> quiescent.  Drivers blocked
                    # forever at this point indicate a workload deadlock; we
                    # return either way (threads are daemonic).
                    return self._now
                t, _, handle, _tag = self._heap[0]
                if handle.cancelled:
                    heapq.heappop(self._heap)
                    continue  # np_count already released at cancel time
                if t > max_time:
                    # beyond the horizon: leave the event queued so a later
                    # ``run`` call (staged execution) still processes it
                    self._now = max_time
                    return self._now
                heapq.heappop(self._heap)
                if not handle.periodic:
                    self._np_count -= 1
                self._now = t
            handle.fn()  # may wake drivers; loop re-waits for runnable==0
            events += 1
            if events >= max_events:
                raise RuntimeError("SimKernel: max_events exceeded (runaway loop?)")


class RealTimeKernel(Kernel):
    """Wall-clock kernel for live serving."""

    def __init__(self) -> None:
        self._t0 = time.monotonic()
        self._drivers: list[threading.Thread] = []
        self._timers: list[threading.Timer] = []
        self._lock = threading.Lock()

    def now(self) -> float:
        return time.monotonic() - self._t0

    def schedule(self, delay: float, fn: Callable[[], None], *, tag: str = "",
                 periodic: bool = False) -> None:
        timer = threading.Timer(max(0.0, delay), fn)
        timer.daemon = True
        with self._lock:
            self._timers = [t for t in self._timers if t.is_alive()]
            self._timers.append(timer)
        timer.start()

    def sleep(self, duration: float) -> None:
        time.sleep(duration)

    def wait_event(self, evt: threading.Event, timeout: Optional[float] = None) -> bool:
        return evt.wait(timeout)

    def notify(self, evt: threading.Event) -> None:
        evt.set()

    def spawn_driver(self, fn: Callable[[], None], name: str = "driver") -> threading.Thread:
        t = threading.Thread(target=fn, name=name, daemon=True)
        self._drivers.append(t)
        t.start()
        return t

    def run(self, max_time: float = float("inf"), max_events: int = 0) -> float:
        for t in self._drivers:
            t.join()
        return self.now()
