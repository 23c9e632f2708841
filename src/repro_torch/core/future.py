"""Futures as first-class runtime objects (paper §3.2, §4.3.1, Table 3).

A NALAR future represents a long-running agent-driven computation.  Its
*value* is immutable once materialized; its *metadata* (executor, consumers,
priority) is mutable, which is what enables late binding and migration of
already-routed work — the key departure from Ray/CIEL futures.

Three runtime operations (Fig. 7):
  Op 1  creation            non-blocking
  Op 2  register consumer   non-blocking (first value access registers caller)
  Op 3  return              ``value()`` blocks until push-based materialization

Readiness is push-based: when a future resolves, the producing component
controller immediately transfers the value to every registered consumer.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional

_future_ids = itertools.count()


class FutureState(str, Enum):
    PENDING = "pending"        # created, not yet dispatched/running
    SCHEDULED = "scheduled"    # routed to an executor queue
    RUNNING = "running"
    READY = "ready"            # value materialized
    FAILED = "failed"
    CANCELLED = "cancelled"


#: states in which a future is resolved and will never run again
TERMINAL_STATES = (FutureState.READY, FutureState.FAILED,
                   FutureState.CANCELLED)


class FutureCancelled(RuntimeError):
    """Raised by ``Future.value()`` when the future was cancelled.

    Cancellation is a *terminal* resolution: consumers are notified exactly
    like on failure, but the retry ladder never re-dispatches a cancelled
    future."""


class InstanceDied(RuntimeError):
    """The agent instance executing a future died (fault injection, replica
    crash, hard ``kill_instance``).  Component controllers escalate this
    error straight to the global controller — local in-place retries are
    pointless on a dead executor."""


class DeadlineExceeded(RuntimeError):
    """The future's deadline passed before (or while) it executed.

    Like cancellation this is a *terminal* resolution: the work is worthless
    after the deadline, so the retry ladder never re-dispatches an expired
    future and no retry budget is burned."""


@dataclass
class FutureMetadata:
    """Mutable coordination metadata (Table 3)."""

    dependencies: List[str] = field(default_factory=list)   # future ids needed
    creator: str = ""          # "agent_name:instance_id" (or "driver:<rid>")
    executor: str = ""         # where the computation is slated to run
    consumers: List[str] = field(default_factory=list)      # who needs the value
    session_id: str = ""
    request_id: str = ""
    agent_type: str = ""       # agent/tool that computes this future
    method: str = ""
    priority: float = 0.0      # higher = more urgent
    # absolute deadline in kernel time; -1.0 = none.  Stamped at creation
    # (min of the call's own budget and the caller's inherited remaining
    # budget) and enforced at launch, at engine admission, and mid-decode.
    deadline: float = -1.0
    created_at: float = 0.0
    scheduled_at: float = -1.0
    started_at: float = -1.0
    ready_at: float = -1.0
    # failure-handling bookkeeping: attempt 0 is the first execution, each
    # retry (local or escalated) increments it; ``escalations`` counts hops
    # through the global controller's RetryPolicy ladder
    attempt: int = 0
    escalations: int = 0
    # bookkeeping for emulated execution / cost models
    work_hint: Dict[str, Any] = field(default_factory=dict)
    # every node whose store holds (or held) this future's metadata mirror —
    # migration/escalation re-home the mirror, and GC must scrub them all
    mirror_nodes: List[str] = field(default_factory=list)


class Future:
    """Coordination handle returned by auto-generated stubs.

    Driver code interacts only via ``available`` and ``value`` (§3.2 API);
    everything else is runtime-internal.
    """

    __slots__ = (
        "fid", "meta", "_state", "_value", "_error", "_ready_evt",
        "_runtime", "_lock", "args", "kwargs", "_run_id",
        "_table", "_live_indexed",
        "_chunks", "_chunk_gen", "_stream_tokens", "_chunk_evt",
        "_stream_owner",
    )

    def __init__(self, runtime: Any, meta: FutureMetadata,
                 args: tuple = (), kwargs: Optional[dict] = None) -> None:
        self.fid = f"f{next(_future_ids)}"
        self.meta = meta
        self._state = FutureState.PENDING
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self._ready_evt = threading.Event()
        self._runtime = runtime
        self._lock = threading.Lock()
        self.args = args
        self.kwargs = kwargs or {}
        # execution fence: bumped every time a controller moves the future
        # into RUNNING.  Completion callbacks captured under an older run id
        # are stale (the attempt was preempted, retried, or its instance
        # died) and must not resolve the future.
        self._run_id = 0
        # the FutureTable tracking this future's liveness (set by add());
        # _live_indexed — mutated only under the table's lock — records
        # whether this future currently contributes to the table's
        # per-session live counters and secondary indexes
        self._table: Optional["FutureTable"] = None
        self._live_indexed = False
        # ---- incremental streaming (STREAMING sub-state of RUNNING) ----
        # Append-only chunk log for the CURRENT attempt.  Each entry is a
        # list of token ids emitted by one engine step.  A retry truncates
        # the log back to the attempt boundary (all entries belong to the
        # attempt that appended them — exactly-once mirrors state epochs)
        # and bumps ``_chunk_gen`` so live iterators rewind their cursor.
        self._chunks: List[list] = []
        self._chunk_gen = 0
        self._stream_tokens = 0          # total tokens across self._chunks
        # eventcount: replaced with a fresh Event on every append/terminal
        # transition; waiters capture it under the lock, then block on it
        self._chunk_evt = threading.Event()
        # stream ownership: the first producer (engine instance id) to
        # append claims the stream; a concurrently-running hedge duplicate
        # shares the run id, so the run fence alone cannot stop it from
        # interleaving tokens — owner mismatch rejects its appends
        self._stream_owner: Optional[str] = None

    # ------------------------------------------------------------ public API
    @property
    def available(self) -> bool:
        """True iff the future is resolved (non-blocking): value materialized,
        failed, or cancelled."""
        return self._state in TERMINAL_STATES

    def value(self, timeout: Optional[float] = None) -> Any:
        """Blocking access (Op 3).  Registers the caller as a consumer."""
        if not self._ready_evt.is_set():
            self._runtime.register_consumer(self)
            ok = self._runtime.kernel.wait_event(self._ready_evt, timeout)
            if not ok:
                raise TimeoutError(f"future {self.fid} not ready within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._value

    # ------------------------------------------------------------- streaming
    @property
    def streaming(self) -> bool:
        """True while partial output exists but the future is unresolved —
        the STREAMING sub-state of RUNNING (orthogonal to the lifecycle
        enum: materialize/fail/cancel/retry machinery is unchanged)."""
        return bool(self._chunks) and self._state not in TERMINAL_STATES

    def streamed(self) -> int:
        """Tokens streamed so far in the current attempt (non-blocking)."""
        return self._stream_tokens

    def partial(self) -> list:
        """Snapshot of all tokens streamed so far (current attempt only).

        Non-blocking; valid in any state.  After READY the log has been
        sealed to the full output, so ``partial()`` equals the final token
        sequence for engine-backed calls."""
        with self._lock:
            out: list = []
            for c in self._chunks:
                out.extend(c)
            return out

    def wait_streamed(self, n: int, timeout: Optional[float] = None) -> int:
        """Block until ≥ ``n`` tokens have streamed or the future resolves.

        Returns the streamed count (callers should check ``available`` on
        return: terminal resolution also wakes this wait, so a short answer
        or a failure returns with fewer than ``n`` tokens).  ``timeout``
        bounds each successive wait for progress."""
        self._runtime.register_consumer(self)
        while True:
            with self._lock:
                if (self._stream_tokens >= n
                        or self._state in TERMINAL_STATES):
                    return self._stream_tokens
                evt = self._chunk_evt
            if not self._runtime.kernel.wait_event(evt, timeout):
                raise TimeoutError(
                    f"future {self.fid}: no stream progress within {timeout}s")

    def iter_chunks(self, timeout: Optional[float] = None):
        """Yield token chunks in order until the future resolves.

        Terminates cleanly at READY (after draining the sealed log) and
        raises the stored error at FAILED/CANCELLED, so consumers blocked
        mid-stream observe a drain/cancel as a fast failure instead of a
        hang.  A mid-stream retry truncates the log back to the attempt
        boundary; live iterators detect the generation bump and rewind to
        re-observe the fresh attempt (greedy decode re-streams identical
        tokens).  ``timeout`` bounds the wait for each successive chunk."""
        self._runtime.register_consumer(self)
        i = 0
        gen = self._chunk_gen
        while True:
            with self._lock:
                if gen != self._chunk_gen:      # retry rewound the log
                    gen = self._chunk_gen
                    i = 0
                if i < len(self._chunks):
                    chunk, evt = self._chunks[i], None
                    i += 1
                elif self._state in TERMINAL_STATES:
                    chunk, evt = None, False
                else:
                    chunk, evt = None, self._chunk_evt
            if evt is None:
                yield chunk
            elif evt is False:
                if self._error is not None:
                    raise self._error
                return
            elif not self._runtime.kernel.wait_event(evt, timeout):
                raise TimeoutError(
                    f"future {self.fid}: no chunk within {timeout}s")

    def append_chunk(self, chunk: list, now: float = 0.0,
                     expect_run: Optional[int] = None,
                     owner: str = "") -> bool:
        """Append one engine step's tokens to the stream (runtime-internal).

        Fenced twice: ``expect_run`` rejects appends captured under a
        superseded attempt (retry/preemption), and ``owner`` rejects a
        hedge duplicate racing the stream's first producer (hedges share
        the run id, so the run fence alone cannot order them).  Returns
        False when the append was rejected or the future is resolved."""
        with self._lock:
            if self._state in TERMINAL_STATES:
                return False
            if expect_run is not None and self._run_id != expect_run:
                return False
            if owner:
                if self._stream_owner is None:
                    self._stream_owner = owner
                elif self._stream_owner != owner:
                    return False
            self._chunks.append(list(chunk))
            self._stream_tokens += len(chunk)
            evt, self._chunk_evt = self._chunk_evt, threading.Event()
        self._runtime.kernel.notify(evt)
        notify_partial = getattr(self._runtime, "on_future_partial", None)
        if notify_partial is not None:
            notify_partial(self)
        return True

    def seal_stream(self, tokens: list, owner: str = "",
                    expect_run: Optional[int] = None) -> None:
        """Reconcile the chunk log with the final token sequence.

        Called by the winning completion just before materialization: the
        common case appends the not-yet-streamed tail as a last chunk.  If
        the log disagrees with ``tokens`` (a hedge loser streamed first and
        claimed ownership), it is truncated and replaced wholesale — the
        generation bump makes live iterators rewind onto the winner's
        tokens, so the stream a consumer assembles is always byte-identical
        to the completion value."""
        with self._lock:
            if self._state in TERMINAL_STATES:
                return
            if expect_run is not None and self._run_id != expect_run:
                return
            have: list = []
            for c in self._chunks:
                have.extend(c)
            if ((owner and self._stream_owner not in (None, owner))
                    or have != list(tokens[:len(have)])):
                self._chunks.clear()
                self._stream_tokens = 0
                self._chunk_gen += 1
                have = []
            if owner:
                self._stream_owner = owner
            tail = list(tokens[len(have):])
            if tail:
                self._chunks.append(tail)
                self._stream_tokens += len(tail)
            evt, self._chunk_evt = self._chunk_evt, threading.Event()
        self._runtime.kernel.notify(evt)

    def _wake_stream_waiters_locked(self) -> threading.Event:
        """Swap in a fresh chunk event; caller must hold ``_lock`` and
        notify the returned event after releasing it."""
        evt, self._chunk_evt = self._chunk_evt, threading.Event()
        return evt

    # ------------------------------------------------------- runtime-internal
    @property
    def state(self) -> FutureState:
        return self._state

    def _set_state(self, s: FutureState) -> None:
        self._state = s

    def materialize(self, value: Any, now: float) -> None:
        """Make the value available and push readiness to waiters.

        Value immutability: a second materialization is a runtime bug.  A
        materialization racing a cancellation loses silently — the caller
        renounced the value, so the late result is discarded.
        """
        with self._lock:
            if self._state == FutureState.READY:
                raise RuntimeError(f"future {self.fid} materialized twice")
            if self._state == FutureState.CANCELLED:
                return
            self._value = value
            self._state = FutureState.READY
            self.meta.ready_at = now
            chunk_evt = self._wake_stream_waiters_locked()
        self._notify_resolved()
        self._runtime.kernel.notify(chunk_evt)
        self._runtime.kernel.notify(self._ready_evt)

    def fail(self, error: BaseException, now: float) -> None:
        with self._lock:
            if self._state in TERMINAL_STATES:
                return
            self._error = error
            self._state = FutureState.FAILED
            self.meta.ready_at = now
            chunk_evt = self._wake_stream_waiters_locked()
        self._notify_resolved()
        self._runtime.kernel.notify(chunk_evt)
        self._runtime.kernel.notify(self._ready_evt)

    def cancel(self, now: float, reason: str = "cancelled") -> bool:
        """Resolve the future as CANCELLED; waiters raise ``FutureCancelled``.

        Returns False when the future is already resolved.  Queue removal and
        consumer notification are orchestrated by ``runtime.cancel_future`` /
        the executor's component controller — this method only flips the
        handle's state and wakes blocked ``value()`` callers.
        """
        with self._lock:
            if self._state in TERMINAL_STATES:
                return False
            self._error = FutureCancelled(
                f"future {self.fid} ({self.meta.agent_type}.{self.meta.method}) "
                f"cancelled: {reason}")
            self._state = FutureState.CANCELLED
            self.meta.ready_at = now
            chunk_evt = self._wake_stream_waiters_locked()
        self._notify_resolved()
        self._runtime.kernel.notify(chunk_evt)
        self._runtime.kernel.notify(self._ready_evt)
        return True

    def reset_for_retry(self, now: float) -> bool:
        """FAILED/SCHEDULED/RUNNING -> PENDING reset for retry re-dispatch.

        Increments the attempt counter and re-arms readiness so the future
        can travel the dispatch path again.  READY and CANCELLED futures are
        immutable — the reset is refused.
        """
        with self._lock:
            if self._state in (FutureState.READY, FutureState.CANCELLED):
                return False
            revived = self._state == FutureState.FAILED
            self._error = None
            self._state = FutureState.PENDING
            self.meta.attempt += 1
            # close the fence immediately: a completion captured under the
            # superseded attempt must not land during the PENDING
            # backoff/escalation window either
            self._run_id += 1
            self.meta.scheduled_at = -1.0
            self.meta.started_at = -1.0
            self.meta.ready_at = -1.0
            if self._ready_evt.is_set():
                # the future had terminally failed (its waiters already woke
                # and observed the error); new waiters need a fresh event
                self._ready_evt = threading.Event()
            # truncate the stream back to the attempt boundary: every
            # logged chunk belongs to the superseded attempt, so the retry
            # re-streams from scratch.  The generation bump rewinds live
            # iterators; waking them here lets blocked consumers observe
            # the rewind instead of waiting on a dead event.
            if self._chunks:
                self._chunks.clear()
                self._stream_tokens = 0
                self._chunk_gen += 1
            self._stream_owner = None
            chunk_evt = self._wake_stream_waiters_locked()
        self._runtime.kernel.notify(chunk_evt)
        if revived:
            self._notify_revived()
        return True

    # liveness notifications keep the FutureTable's per-session counters and
    # secondary indexes exact at every state transition — called with the
    # future's own lock RELEASED (lock order: future lock before table lock,
    # never interleaved)
    def _notify_resolved(self) -> None:
        if self._table is not None:
            self._table.on_resolved(self)

    def _notify_revived(self) -> None:
        if self._table is not None:
            self._table.on_revived(self)

    def unresolved_deps(self, table: "FutureTable") -> List[str]:
        out = []
        for dep in self.meta.dependencies:
            f = table.get(dep)
            if f is not None and not f.available:
                out.append(dep)
        return out

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Future({self.fid}, {self.meta.agent_type}.{self.meta.method}, "
                f"{self._state.value}, exec={self.meta.executor})")


class FutureTable:
    """Process-wide registry mapping fid -> Future.

    In the distributed deployment this is sharded across node stores; the
    in-process table keeps one authoritative object per future while the node
    stores hold serialized metadata mirrors (what Fig. 10 measures).

    The table is *bounded*: once it grows past ``gc_threshold`` entries, a
    sweep retires resolved futures (READY/FAILED/CANCELLED).  Resolved
    futures have already pushed their values to every registered consumer,
    and dependency checks treat a missing fid as resolved, so retirement is
    invisible to the runtime — it just keeps long-running deployments
    (the 130K-future scale of ``fig10_control_loop``) memory-flat.  Callers
    holding the ``Future`` object keep full access to its value.

    The table is *indexed*: per-session live-future counters plus by-session
    / by-executor / by-agent-type secondary indexes, maintained at future
    state transitions (materialize/fail/cancel/reset_for_retry notify the
    table; GC and explicit removal reconcile through the same per-future
    ``_live_indexed`` flag, so tombstoned epochs, run-id-fenced completions
    and retry re-arms all keep the counters exact).  This is what lets the
    global controller answer "which sessions still have unresolved work" in
    O(1) per session instead of an O(N) snapshot per control round.
    """

    def __init__(self, gc_threshold: int = 4096) -> None:
        self._lock = threading.Lock()
        self._futures: Dict[str, Future] = {}
        # sweep trigger; 0/None disables GC entirely
        self.gc_threshold = gc_threshold
        self.retired = 0          # total futures GC'd over the table's life
        # adaptive watermark: when a sweep finds little to collect (a burst
        # of still-pending futures), back off geometrically so future
        # creation stays amortized O(1) instead of O(n) per add
        self._sweep_floor = 0
        # secondary indexes (all under _lock):
        self._by_session: Dict[str, Dict[str, Future]] = {}   # all registered
        self._live_by_session: Dict[str, int] = {}            # live counters
        self._live_by_executor: Dict[str, Dict[str, Future]] = {}
        self._live_by_type: Dict[str, Dict[str, Future]] = {}
        # sessions whose liveness flipped (0 <-> >0) since the last drain;
        # the global controller re-filters stale waiting lists from this
        self._dirty_sessions: set = set()

    # ------------------------------------------------------- index internals
    def _index_live_locked(self, f: Future) -> None:
        if f._live_indexed:
            return
        f._live_indexed = True
        sid = f.meta.session_id
        if sid:
            before = self._live_by_session.get(sid, 0)
            self._live_by_session[sid] = before + 1
            if before == 0:
                self._dirty_sessions.add(sid)
        if f.meta.executor:
            self._live_by_executor.setdefault(f.meta.executor, {})[f.fid] = f
        if f.meta.agent_type:
            self._live_by_type.setdefault(f.meta.agent_type, {})[f.fid] = f

    def _unindex_live_locked(self, f: Future) -> None:
        if not f._live_indexed:
            return
        f._live_indexed = False
        sid = f.meta.session_id
        if sid:
            after = self._live_by_session.get(sid, 1) - 1
            if after <= 0:
                self._live_by_session.pop(sid, None)
                self._dirty_sessions.add(sid)
            else:
                self._live_by_session[sid] = after
        for index, key in ((self._live_by_executor, f.meta.executor),
                           (self._live_by_type, f.meta.agent_type)):
            bucket = index.get(key)
            if bucket is not None:
                bucket.pop(f.fid, None)
                if not bucket:
                    index.pop(key, None)

    def on_resolved(self, f: Future) -> None:
        """A registered future reached a terminal state."""
        with self._lock:
            self._unindex_live_locked(f)

    def on_revived(self, f: Future) -> None:
        """A FAILED future was re-armed (``reset_for_retry``)."""
        with self._lock:
            if f.fid in self._futures and not f.available:
                self._index_live_locked(f)

    def set_executor(self, f: Future, instance_id: str) -> None:
        """Re-home ``f``'s executor, keeping the by-executor index exact.
        All executor reassignment (submit, migration, reroute) goes through
        here."""
        with self._lock:
            if f._live_indexed and f.meta.executor != instance_id:
                bucket = self._live_by_executor.get(f.meta.executor)
                if bucket is not None:
                    bucket.pop(f.fid, None)
                    if not bucket:
                        self._live_by_executor.pop(f.meta.executor, None)
                f.meta.executor = instance_id
                if instance_id:
                    self._live_by_executor.setdefault(
                        instance_id, {})[f.fid] = f
            else:
                f.meta.executor = instance_id

    # ------------------------------------------------------------ index API
    def live_count(self, session_id: str) -> int:
        """Unresolved futures of ``session_id`` — O(1)."""
        with self._lock:
            return self._live_by_session.get(session_id, 0)

    def live_sessions(self) -> set:
        """Sessions with at least one unresolved future — O(live sessions)."""
        with self._lock:
            return set(self._live_by_session)

    def drain_dirty_sessions(self) -> set:
        """Sessions whose liveness flipped since the last drain (single
        consumer: the global controller's incremental view maintenance)."""
        with self._lock:
            out = self._dirty_sessions
            self._dirty_sessions = set()
            return out

    def futures_of_session(self, session_id: str) -> List[Future]:
        """Every registered (not yet GC'd) future of the session."""
        with self._lock:
            return list(self._by_session.get(session_id, {}).values())

    def live_of_executor(self, instance_id: str) -> List[Future]:
        with self._lock:
            return list(self._live_by_executor.get(instance_id, {}).values())

    def live_of_type(self, agent_type: str) -> List[Future]:
        with self._lock:
            return list(self._live_by_type.get(agent_type, {}).values())

    # -------------------------------------------------------------- registry
    def add(self, f: Future) -> None:
        f._table = self
        with self._lock:
            self._futures[f.fid] = f
            sid = f.meta.session_id
            if sid:
                self._by_session.setdefault(sid, {})[f.fid] = f
            if not f.available:
                self._index_live_locked(f)

    def get(self, fid: str) -> Optional[Future]:
        with self._lock:
            return self._futures.get(fid)

    def _forget_locked(self, f: Future) -> None:
        self._unindex_live_locked(f)
        sid = f.meta.session_id
        if sid:
            bucket = self._by_session.get(sid)
            if bucket is not None:
                bucket.pop(f.fid, None)
                if not bucket:
                    self._by_session.pop(sid, None)

    def remove(self, fid: str) -> None:
        with self._lock:
            f = self._futures.pop(fid, None)
            if f is not None:
                self._forget_locked(f)

    def __len__(self) -> int:
        with self._lock:
            return len(self._futures)

    def snapshot(self) -> List[Future]:
        with self._lock:
            return list(self._futures.values())

    def needs_sweep(self) -> bool:
        if not self.gc_threshold:
            return False
        with self._lock:
            return len(self._futures) > max(self.gc_threshold,
                                            self._sweep_floor)

    def sweep(self) -> List[Future]:
        """Retire resolved futures; returns them (for mirror cleanup).

        Retirement never touches the live counters directly: resolution
        already decremented them (``on_resolved``), and ``_forget_locked``
        only reconciles a future whose resolution raced the sweep — so a
        completed-then-GC'd future decrements its session exactly once.
        """
        with self._lock:
            dead = [f for f in self._futures.values()
                    if f.state in TERMINAL_STATES]
            for f in dead:
                del self._futures[f.fid]
                self._forget_locked(f)
            self.retired += len(dead)
            # next sweep only once the table doubles past what survived —
            # collapses back to gc_threshold as soon as futures resolve
            self._sweep_floor = max(self.gc_threshold,
                                    2 * len(self._futures))
        return dead


def resolve_args(args: tuple, kwargs: dict,
                 stream_min: Optional[int] = None) -> tuple:
    """Replace Future objects in call args with their materialized values.

    Called by the executing component controller once all dependencies are
    ready (push-based: the values have already arrived).

    ``stream_min`` is the consumer's ``stream_min_tokens`` hint: a still-
    running dependency that has streamed at least that many tokens is
    substituted with its ``partial()`` token snapshot instead of blocking —
    the consumer declared it can start on partial output.  Fully-resolved
    dependencies substitute their value as usual (callers accepting partial
    input must handle both shapes).
    """
    def r(x: Any) -> Any:
        if isinstance(x, Future):
            if not x.available and stream_min is not None:
                partial = x.partial()
                assert len(partial) >= stream_min, (
                    "partial dependency dispatched below stream_min_tokens")
                return partial
            assert x.available, "dependency not materialized before execution"
            return x.value()
        if isinstance(x, (list, tuple)):
            t = type(x)
            return t(r(i) for i in x)
        if isinstance(x, dict):
            return {k: r(v) for k, v in x.items()}
        return x

    return tuple(r(a) for a in args), {k: r(v) for k, v in kwargs.items()}


def extract_dependencies(args: tuple, kwargs: dict) -> List[str]:
    """Scan call arguments for Future objects (dynamic dep-graph extraction)."""
    deps: List[str] = []

    def scan(x: Any) -> None:
        if isinstance(x, Future):
            deps.append(x.fid)
        elif isinstance(x, (list, tuple)):
            for i in x:
                scan(i)
        elif isinstance(x, dict):
            for v in x.values():
                scan(v)

    for a in args:
        scan(a)
    for v in kwargs.values():
        scan(v)
    return deps
