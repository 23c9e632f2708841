"""Component-level controller: event-driven local enforcement (paper §4.1).

One controller per agent instance.  Three roles (verbatim from the paper):
 1. local scheduling with policies installed by the global controller, plus
    maintenance of future metadata for migration and value propagation;
 2. the interface between stubs and the runtime — stubs invoke the controller,
    never user code directly;
 3. serving-time metrics (queue length, latencies, resource use) pushed to the
    node store for the global controller's periodic computations.

Migration (Fig. 8) is coordinated entirely among component controllers; the
global controller only issues the command.
"""

from __future__ import annotations

import random
import threading
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from .executor import AgentInstance, EmulatedMethod, EngineBackedMethod
from .future import (DeadlineExceeded, Future, FutureCancelled, FutureState,
                     InstanceDied, TERMINAL_STATES, resolve_args)


class LocalSchedule:
    """Local scheduling policy installed by the global controller.

    ``order_key(fut, now)``: smaller runs first.  Default: priority then FCFS.
    Swappable at runtime via the policy interface (§4.2) — e.g. SRTF installs
    a remaining-work key, LPT a longest-processing-time key.
    """

    name = "priority_fcfs"

    def order_key(self, fut: Future, now: float):
        return (-fut.meta.priority, fut.meta.created_at)


class ComponentController:
    def __init__(self, runtime, instance: AgentInstance) -> None:
        self.runtime = runtime
        self.inst = instance
        self.kernel = runtime.kernel
        self.store = runtime.stores.get(instance.node_id)
        self.schedule_policy: LocalSchedule = LocalSchedule()
        # stable across processes (str hash is salted; crc32 is not)
        import zlib
        self._rng = random.Random(zlib.crc32(instance.instance_id.encode()))
        self._lock = threading.RLock()
        # futures parked here waiting on dependencies: fid -> set of dep fids
        self._parked: Dict[str, set] = {}
        # metrics-mirror write coalescing: inside a ``_metrics_batch`` block
        # (one per externally-triggered pump iteration) publishes only mark
        # the mirror dirty; one ``hset_many`` lands at batch exit.  Depth is
        # per-thread (nesting == call-stack), the dirty flag is shared —
        # a racing flush publishes the freshest state either way.
        self._pub_tls = threading.local()
        self._pub_dirty = False
        self._publish_metrics()
        # consume policy/commands written to the node store asynchronously
        self.store.subscribe(f"cmd:{instance.instance_id}", self._on_command)

    @contextmanager
    def _metrics_batch(self):
        depth = getattr(self._pub_tls, "depth", 0)
        self._pub_tls.depth = depth + 1
        try:
            yield
        finally:
            self._pub_tls.depth = depth
            if depth == 0 and self._pub_dirty:
                self._flush_metrics()

    # ------------------------------------------------------------ submission
    def submit(self, fut: Future) -> None:
        """A stub routed ``fut`` here.  Park until deps ready, then enqueue."""
        if not self.inst.alive:
            # instance died between routing and arrival: re-route
            self.runtime.dispatch(fut)
            return
        # executor reassignment goes through the table so its by-executor
        # index stays exact
        self.runtime.futures.set_executor(fut, self.inst.instance_id)
        fut.meta.scheduled_at = self.kernel.now()
        fut._set_state(FutureState.SCHEDULED)
        pending = set(fut.unresolved_deps(self.runtime.futures))
        # a consumer declared with stream_min_tokens can start on partial
        # output: deps that have already streamed enough don't park it
        smin = fut.meta.work_hint.get("stream_min_tokens")
        if pending and smin is not None:
            for dep_fid in list(pending):
                dep = self.runtime.futures.get(dep_fid)
                if dep is not None and dep.streamed() >= int(smin):
                    pending.discard(dep_fid)
        with self._metrics_batch():
            with self._lock:
                if pending:
                    self._parked[fut.fid] = pending
                    for dep in pending:
                        self.runtime.register_dep_consumer(dep, self)
                else:
                    self._enqueue(fut)
            self._maybe_dispatch()

    def on_dep_ready(self, dep_fid: str) -> None:
        """Push-based readiness: a producer transferred a dependency value."""
        ready: List[Future] = []
        with self._lock:
            for fid, deps in list(self._parked.items()):
                deps.discard(dep_fid)
                if not deps:
                    del self._parked[fid]
                    fut = self.runtime.futures.get(fid)
                    if fut is not None:
                        ready.append(fut)
        with self._metrics_batch():
            for fut in ready:
                with self._lock:
                    self._enqueue(fut)
            if ready:
                self._maybe_dispatch()

    def on_dep_partial(self, dep_fid: str, streamed: int) -> None:
        """Partial availability: a streaming producer appended a chunk.

        Parked futures whose ``stream_min_tokens`` hint is satisfied treat
        the dependency as ready-enough and dispatch; ``resolve_args`` then
        substitutes the dep's ``partial()`` snapshot at execution time."""
        ready: List[Future] = []
        with self._lock:
            for fid, deps in list(self._parked.items()):
                if dep_fid not in deps:
                    continue
                fut = self.runtime.futures.get(fid)
                if fut is None:
                    continue
                smin = fut.meta.work_hint.get("stream_min_tokens")
                if smin is None or streamed < int(smin):
                    continue
                deps.discard(dep_fid)
                if not deps:
                    del self._parked[fid]
                    ready.append(fut)
        with self._metrics_batch():
            for fut in ready:
                with self._lock:
                    self._enqueue(fut)
            if ready:
                self._maybe_dispatch()

    def _enqueue(self, fut: Future) -> None:
        self.inst.enqueue(fut)
        self._publish_metrics()

    # -------------------------------------------------------------- dispatch
    def _maybe_dispatch(self) -> None:
        with self._lock:
            if not self.inst.alive or self.inst.qsize() == 0:
                return
            now = self.kernel.now()
            order = sorted(self.inst.queue, key=lambda f: self.schedule_policy.order_key(f, now))
            head = order[0]
            method = self.inst.methods.get(head.meta.method)
            if isinstance(method, EngineBackedMethod):
                # Engine-backed leaves are asynchronous: the external engine
                # batches continuously, so the instance admits work until the
                # engine's batch width is saturated instead of blocking on
                # one in-flight batch.
                free = max(1, method.capacity()) - len(self.inst.running)
                if free <= 0:
                    return
                batch = [f for f in order if f.meta.method == head.meta.method][:free]
                self.inst.dequeue_selected(batch)
                self.inst.running.extend(batch)
            else:
                if self.inst.busy:
                    return
                batch = [head]
                if self.inst.directives.batchable:
                    for f in order[1:]:
                        if len(batch) >= self.inst.directives.max_batch:
                            break
                        if f.meta.method == head.meta.method:
                            batch.append(f)
                self.inst.dequeue_selected(batch)
                self.inst.running = list(batch)
            # re-publish after dequeue: otherwise the node-store mirror keeps
            # claiming these sessions are *waiting* here until completion,
            # and a policy round in between acts on the stale list
            self._publish_metrics()
        self._execute(batch)

    def _execute(self, batch: List[Future]) -> None:
        now = self.kernel.now()
        # launch-time deadline check: work whose deadline already passed is
        # worthless — resolve it DeadlineExceeded (terminal, never retried)
        # instead of burning the executor on it
        expired = [f for f in batch
                   if 0 <= f.meta.deadline <= now]
        if expired:
            batch = [f for f in batch if f not in expired]
            for f in expired:
                self.inst.metrics.expired += 1
                self._complete(f, error=DeadlineExceeded(
                    f"future {f.fid} ({f.meta.agent_type}.{f.meta.method}) "
                    f"deadline {f.meta.deadline:.3f} passed at launch "
                    f"(now {now:.3f})"))
            if not batch:
                return
        for f in batch:
            f._set_state(FutureState.RUNNING)
            f._run_id += 1      # fences stale completions of older attempts
            f.meta.started_at = now
        method = self.inst.methods.get(batch[0].meta.method)
        if isinstance(method, EngineBackedMethod):
            self._execute_engine(batch, method)
        elif isinstance(method, EmulatedMethod):
            self._execute_emulated(batch, method)
        elif callable(method):
            self._execute_composite(batch[0], method)
        else:
            for f in batch:
                self._complete(f, error=AttributeError(
                    f"{self.inst.agent_type} has no method {f.meta.method}"))

    def _execute_emulated(self, batch: List[Future], method: EmulatedMethod) -> None:
        # enrich hints with execution context so cost models can consult
        # session-state (e.g. K,V-cache locality — §4.3.2)
        hints = [dict(f.meta.work_hint,
                      session_id=f.meta.session_id,
                      instance=self.inst.instance_id,
                      now=self.kernel.now()) for f in batch]
        service = method.latency.service_time(hints, self._rng)
        now = self.kernel.now()
        self.inst.metrics.busy_until = now + service
        self.inst.metrics.record_service(service)
        runs = [(f, f._run_id) for f in batch]

        def finish() -> None:
            done_any = False
            for f, run_id in runs:
                if f.state != FutureState.RUNNING or f._run_id != run_id:
                    # preempted/migrated/retried mid-flight — or the losing
                    # half of a hedged pair (already resolved elsewhere).
                    # A resolved loser occupied this instance until *now*,
                    # so only now does its running entry clear (migrated /
                    # retried futures are live elsewhere: leave them alone)
                    if f.available:
                        self.detach_running(f)
                    continue
                done_any = True
                if f.meta.executor != self.inst.instance_id:
                    # hedged duplicate completing first: attribute the win
                    # to the instance that actually produced the value
                    self.runtime.futures.set_executor(
                        f, self.inst.instance_id)
                try:
                    self.runtime.enter_agent_context(f, self.inst)
                    args, kwargs = resolve_args(
                        f.args, f.kwargs,
                        stream_min=f.meta.work_hint.get("stream_min_tokens"))
                    value = method.compute(*args, **kwargs)
                    self._complete(f, value=value)
                except BaseException as e:  # noqa: BLE001 — fault reporting (§5)
                    self._complete(f, error=e)
                finally:
                    self.runtime.exit_agent_context()
            if not done_any:
                # entire batch was preempted away; free the instance
                self._maybe_dispatch()

        self.kernel.schedule(service, finish, tag=f"exec:{self.inst.instance_id}")

    def _execute_engine(self, batch: List[Future],
                        method: "EngineBackedMethod") -> None:
        """Hand the batch to a real serving engine; completions arrive later
        via ``complete_async`` from the engine's pump thread."""
        try:
            method.launch(batch, self)
        except BaseException as e:  # noqa: BLE001 — submission failure (§5)
            for f in batch:
                self.complete_async(f, error=e)

    def complete_async(self, fut: Future, value: Any = None,
                       error: Optional[BaseException] = None,
                       expect_run: Optional[int] = None) -> None:
        """Thread-safe completion entry for asynchronous backends.

        Routed through ``kernel.schedule`` so that, under the SimKernel, the
        completion becomes an ordinary event (deterministic ordering) and,
        under the RealTimeKernel, it fires on a timer thread rather than
        re-entering the caller's stack.

        A future cancelled (or otherwise resolved) while in flight on an
        engine must NOT be materialized by the late completion; callers that
        captured ``expect_run`` at submission additionally fence against the
        future having been retried on another replica in the meantime.
        """
        def finish() -> None:
            if fut.state in TERMINAL_STATES:
                return  # preempted/cancelled/failed while in flight
            if expect_run is not None and fut._run_id != expect_run:
                return  # stale completion of a superseded attempt
            self.inst.metrics.record_service(
                max(0.0, self.kernel.now() - fut.meta.started_at))
            self._complete(fut, value=value, error=error)

        self.kernel.schedule(0.0, finish, tag=f"engine-done:{fut.fid}")

    def _execute_composite(self, fut: Future, fn) -> None:
        """User-code agent method that may itself call stubs: run on a driver
        thread so nested future blocking works under virtual time."""
        run_id = fut._run_id

        def body() -> None:
            start = self.kernel.now()
            try:
                self.runtime.enter_agent_context(fut, self.inst)
                args, kwargs = resolve_args(
                    fut.args, fut.kwargs,
                    stream_min=fut.meta.work_hint.get("stream_min_tokens"))
                value = fn(*args, **kwargs)
                err: Optional[BaseException] = None
            except BaseException as e:  # noqa: BLE001
                value, err = None, e
            finally:
                self.runtime.exit_agent_context()
            self.inst.metrics.record_service(self.kernel.now() - start)
            if err is None:
                self._complete(fut, value=value, expect_run=run_id)
            else:
                self._complete(fut, error=err, expect_run=run_id)

        self.kernel.spawn_driver(body, name=f"agent:{fut.fid}")

    # ------------------------------------------------------------ completion
    def _complete(self, fut: Future, value: Any = None,
                  error: Optional[BaseException] = None,
                  expect_run: Optional[int] = None) -> None:
        # one coalesced metrics write per completion, not one per intermediate
        # publish point (dequeue, failure bookkeeping, re-dispatch)
        with self._metrics_batch():
            self._complete_inner(fut, value, error, expect_run)

    def _complete_inner(self, fut: Future, value: Any = None,
                        error: Optional[BaseException] = None,
                        expect_run: Optional[int] = None) -> None:
        now = self.kernel.now()
        with self._lock:
            if fut in self.inst.running:
                self.inst.running.remove(fut)
        if expect_run is not None and fut._run_id != expect_run:
            # stale completion of a superseded attempt: the future was
            # preempted/retried and re-executes elsewhere; drop the result
            self._publish_metrics()
            self._maybe_dispatch()
            return
        epoch = (fut.fid, fut.meta.attempt)
        if fut.state == FutureState.CANCELLED:
            # resolved by cancellation while in flight: discard the late
            # result; the cancel path already rolled back + notified
            self.runtime.state_store.rollback_epoch(epoch)
            self._publish_metrics()
            self._maybe_dispatch()
            return
        if fut.state in (FutureState.READY, FutureState.FAILED):
            # already resolved — the winning half of a hedged pair got here
            # first; drop the loser's late result (its epoch was never opened:
            # only leaf methods may race, and leaves journal no state)
            self._publish_metrics()
            self._maybe_dispatch()
            return
        if error is not None:
            # failed attempt: its managed-state writes never happened
            # (exactly-once contract — rollback precedes any re-execution)
            self.runtime.state_store.rollback_epoch(epoch)
            if self._handle_failure(fut, error, now):
                self._publish_metrics()
                self._maybe_dispatch()
                return          # absorbed: retrying locally or escalated
            self.inst.metrics.failed += 1
            fut.fail(error, now)
        else:
            self.runtime.state_store.commit_epoch(epoch)
            self.inst.metrics.completed += 1
            fut.materialize(value, now)
        self._push_consumers(fut)
        self.runtime.on_future_resolved(fut)
        self.runtime.telemetry.on_future_done(fut, self.inst, now)
        self._publish_metrics()
        self._maybe_dispatch()

    def _push_consumers(self, fut: Future) -> None:
        """Push resolution to each consumer controller (push-based readiness)."""
        for consumer in list(fut.meta.consumers):
            ctrl = self.runtime.controller_of(consumer)
            if ctrl is not None and ctrl is not self:
                delay = self.runtime.net_latency(self.inst.node_id, ctrl.inst.node_id)
                self.kernel.schedule(delay, lambda c=ctrl, fid=fut.fid: c.on_dep_ready(fid))
            elif ctrl is self:
                self.on_dep_ready(fut.fid)

    # ------------------------------------------------------- failure handling
    def _retry_budget(self, fut: Future) -> int:
        """Per-call retry budget.

        ``_hint={"max_retries": n}`` overrides the agent directive outright
        (0 disables retries for this call).  The pre-existing ``"retry"``
        hint doubles as the budget only when truthy — drivers tag first
        attempts of their own retry loops with ``{"retry": 0}`` as a
        *scheduling* signal (LPT re-entrance), which must not silently
        disable the operator's ``max_retries`` directive.
        """
        hint = fut.meta.work_hint
        for key, zero_counts in (("max_retries", True), ("retry", False)):
            v = hint.get(key)
            if v is None:
                continue
            try:
                n = int(v)
            except (TypeError, ValueError):
                continue
            if n > 0 or (zero_counts and n == 0):
                return max(0, n)
        return self.inst.directives.max_retries

    def _retryable(self, error: BaseException) -> bool:
        r = self.inst.directives.retryable
        if callable(r):
            try:
                return bool(r(error))
            except Exception:  # noqa: BLE001 — a broken predicate fails fast
                return False
        return bool(r)

    def _handle_failure(self, fut: Future, error: BaseException,
                        now: float) -> bool:
        """The retry ladder (rung 1 + handoff to rung 2).

        Returns True when the failure was absorbed: either a local in-place
        retry was scheduled (backoff), or the future escalated to the global
        controller's RetryPolicy (budget exhausted / instance death).  False
        means the failure is terminal and the caller should ``fail`` it.
        """
        if isinstance(error, (FutureCancelled, DeadlineExceeded)):
            # cancellation is never retried; expired work is worthless after
            # its deadline — neither burns retry budget
            return False
        budget = self._retry_budget(fut)
        if budget <= 0 or not self._retryable(error):
            return False
        dead = not self.inst.alive or isinstance(error, InstanceDied)
        if not dead and fut.meta.attempt < budget:
            self._schedule_retry(fut, now)
            return True
        # rung 2: local budget exhausted, or the executor died — hand the
        # future to the global controller for rerouting to a survivor
        return self.runtime.escalate(
            fut, error, self.inst.instance_id,
            reason="instance_death" if dead else "budget_exhausted")

    def _schedule_retry(self, fut: Future, now: float) -> None:
        """Rung 1: retry in place with exponential backoff."""
        delay = self.inst.directives.retry_backoff * (2 ** fut.meta.attempt)
        if not fut.reset_for_retry(now):
            return
        self.inst.metrics.retries += 1

        def resubmit() -> None:
            if fut.state != FutureState.PENDING:
                return          # cancelled during backoff
            if self.inst.alive:
                self.submit(fut)
            else:
                self.runtime.dispatch(fut)   # died during backoff: re-route

        self.kernel.schedule(delay, resubmit, tag=f"retry:{fut.fid}")

    def cancel_local(self, fut: Future, reason: str) -> bool:
        """Cancel a future owned by this controller: remove it from queued /
        parked / running bookkeeping, resolve it CANCELLED, and propagate
        readiness so dependents unblock (they observe the cancellation when
        they touch the value)."""
        now = self.kernel.now()
        with self._lock:
            self.inst.remove_queued(fut)
            self._parked.pop(fut.fid, None)
            if fut in self.inst.running:
                self.inst.running.remove(fut)
        if not fut.cancel(now, reason):
            return False
        # a running attempt may have written managed state already
        self.runtime.state_store.rollback_epoch((fut.fid, fut.meta.attempt))
        self.inst.metrics.cancelled += 1
        with self._metrics_batch():
            self._push_consumers(fut)
            self.runtime.on_future_resolved(fut)
            self.runtime.telemetry.on_future_done(fut, self.inst, now)
            self._publish_metrics()
            self._maybe_dispatch()
        return True

    # ------------------------------------------------------------- migration
    def take_session_futures(self, session_id: str) -> List[Future]:
        """Atomically remove and return this session's queued futures.

        Used by ``serving.pool.EnginePool`` migration to hand a session's
        not-yet-launched work to the destination replica without reaching
        into the queue's bookkeeping (``waiting_sessions`` stays coherent).
        """
        with self._lock:
            futs = [f for f in list(self.inst.queue)
                    if f.meta.session_id == session_id]
            if futs:
                self.inst.dequeue_selected(futs)
        if futs:
            self._publish_metrics()
        return futs

    def detach_running(self, fut: Future) -> None:
        """Drop ``fut`` from the running set (engine-pool re-route: the
        future never reached the engine and is being re-submitted on
        another replica)."""
        with self._lock:
            if fut in self.inst.running:
                self.inst.running.remove(fut)
        self._publish_metrics()

    def migrate_out(self, fut: Future, dst_instance_id: str) -> bool:
        """Fig. 8 protocol, steps 2–6, coordinated locally.

        Returns True if migration happened (future was still movable here).
        """
        dst_ctrl = self.runtime.controller_of(dst_instance_id)
        if dst_ctrl is None:
            return False
        with self._lock:
            queued = self.inst.remove_queued(fut)
            parked = fut.fid in self._parked
            if parked:
                pending = self._parked.pop(fut.fid)
            if not queued and not parked:
                # running: movable only if the agent declared `preemptable`
                # (Table 1) — preemption-with-restart semantics: the pending
                # completion event becomes a no-op (state check) and the
                # future re-executes at the destination.
                preempt_fn = self.inst.directives.preemptable
                if (preempt_fn is None or fut not in self.inst.running
                        or len(self.inst.running) != 1):
                    return False
                self.inst.running.remove(fut)
                fut._set_state(FutureState.PENDING)
                fut.meta.work_hint["preempted"] = \
                    fut.meta.work_hint.get("preempted", 0) + 1
                if callable(preempt_fn):
                    preempt_fn(fut)
                queued = True   # treat as movable from here on
        now = self.kernel.now()
        # Step 2+3: for unresolved deps, repoint the consumer registration so
        # producers push values to the destination instead of here.
        if parked and pending:
            for dep in pending:
                self.runtime.register_dep_consumer(dep, dst_ctrl)
        # Step 4: notify creator that the executor changed (metadata update,
        # routed through the table to keep the by-executor index exact).
        self.runtime.futures.set_executor(fut, dst_instance_id)
        self.runtime.telemetry.on_migration(fut, self.inst.instance_id,
                                            dst_instance_id, now)
        # Step 5: transfer session state; cost modelled as a delay on activation.
        bytes_moved = self.runtime.migrate_session_state(
            fut.meta.session_id, self.inst.agent_type, dst_ctrl.inst.node_id)
        delay = self.runtime.state_transfer_delay(
            self.inst.node_id, dst_ctrl.inst.node_id, bytes_moved)
        # also move KV-cache residency hints for the session (§4.3.2)
        self.runtime.kv_registry.migrate(fut.meta.session_id,
                                         self.inst.instance_id, dst_instance_id)

        # Step 6: activate at destination.
        def activate() -> None:
            if parked and pending:
                with dst_ctrl._lock:
                    # a dep retired by the FutureTable GC counts as resolved
                    deps = {d: self.runtime.futures.get(d) for d in pending}
                    still = {d for d, f in deps.items()
                             if f is not None and not f.available}
                    if still:
                        dst_ctrl._parked[fut.fid] = still
                    else:
                        dst_ctrl._enqueue(fut)
                dst_ctrl._maybe_dispatch()
            else:
                dst_ctrl.submit(fut)

        self.kernel.schedule(delay, activate, tag="migrate-activate")
        self._publish_metrics()
        return True

    def migrate_session(self, session_id: str, dst_instance_id: str) -> int:
        """Move a session to another instance (Table 2 ``migrate``).

        Engine-pool agent types delegate to the pool backend, which owns the
        physical semantics: defer past the in-flight engine call, replay the
        transcript on the destination, re-home the KV registry, then move
        queued futures.  Emulated/composite agents keep the seed behaviour —
        move all queued/parked futures of the session.
        """
        backend = self.runtime.engine_backends.get(self.inst.agent_type)
        if backend is not None and hasattr(backend, "migrate_session"):
            return backend.migrate_session(session_id,
                                           self.inst.instance_id,
                                           dst_instance_id)
        with self._lock:
            movable = [f for f in list(self.inst.queue)
                       if f.meta.session_id == session_id]
            movable += [self.runtime.futures.get(fid)
                        for fid, _ in list(self._parked.items())
                        if self.runtime.futures.get(fid) is not None
                        and self.runtime.futures.get(fid).meta.session_id == session_id]
        n = 0
        for f in movable:
            if f is not None and self.migrate_out(f, dst_instance_id):
                n += 1
        return n

    # ----------------------------------------------------- commands & policy
    def _on_command(self, field: str, payload: Any) -> None:
        """Commands written by the global controller into the node store."""
        kind = payload.get("kind") if isinstance(payload, dict) else None
        if kind == "migrate_session":
            self.migrate_session(payload["session_id"], payload["dst"])
        elif kind == "migrate_future":
            fut = self.runtime.futures.get(payload["fid"])
            if fut is not None:
                self.migrate_out(fut, payload["dst"])
        elif kind == "set_schedule":
            self.schedule_policy = payload["policy"]
            self._maybe_dispatch()
        elif kind == "kill":
            self.shutdown(drain_to=payload.get("drain_to"))

    def shutdown(self, drain_to: Optional[str] = None,
                 hard: bool = False) -> None:
        """Stop this instance.

        Graceful (default): queued and parked work drains to ``drain_to`` or
        re-routes through the runtime; in-flight work is allowed to finish
        (its completion events still fire).  ``hard=True`` models instance
        *death* (fault injection): in-flight work is lost — each running
        future fails with ``InstanceDied`` and travels the retry ladder
        (escalating to the global controller when retries are enabled).
        Engine-backed in-flight futures are failed by the serving backend's
        ``on_replica_killed`` hook instead, which also recovers the dead
        replica's sessions by transcript replay.
        """
        self.inst.alive = False
        with self._metrics_batch():
            with self._lock:
                pending = list(self.inst.queue)
                parked = [self.runtime.futures.get(fid)
                          for fid in list(self._parked)]
            # drain queued AND parked work; fall back to re-routing through
            # the runtime when no explicit drain target was given
            for f in pending + [p for p in parked if p is not None]:
                if drain_to and self.migrate_out(f, drain_to):
                    continue
                with self._lock:
                    dequeued = self.inst.remove_queued(f)
                    if f.fid in self._parked:
                        self._parked.pop(f.fid)
                        dequeued = True
                if dequeued:
                    self.runtime.dispatch(f)
            if hard:
                with self._lock:
                    running = list(self.inst.running)
                err = InstanceDied(f"instance {self.inst.instance_id} died")
                for f in running:
                    if isinstance(self.inst.methods.get(f.meta.method),
                                  EngineBackedMethod):
                        continue   # failed by the backend's on_replica_killed
                    self._complete(f, error=err)
            self._publish_metrics()

    # -------------------------------------------------------------- metrics
    def _publish_metrics(self) -> None:
        """Publish the metrics mirror — or, inside a ``_metrics_batch``
        block, mark it dirty for one coalesced write at batch exit."""
        if getattr(self._pub_tls, "depth", 0) > 0:
            self._pub_dirty = True
        else:
            self._flush_metrics()

    def _flush_metrics(self) -> None:
        m = self.inst.metrics
        self._pub_dirty = False
        # engine-backed instances piggyback data-plane gauges (wait-queue
        # depth / admission saturation) into the same mirror write, so the
        # global controller's InstanceView sees backpressure building
        # before the queue hard-rejects (duck-typed: core never imports
        # serving)
        extra: Dict[str, Any] = {}
        backend = self.runtime.engine_backends.get(self.inst.agent_type)
        if backend is not None and hasattr(backend, "instance_metrics"):
            try:
                extra = dict(backend.instance_metrics(
                    self.inst.instance_id) or {})
            except Exception:  # noqa: BLE001 — telemetry must never wedge
                extra = {}
        self.store.hset_many(f"metrics:{self.inst.instance_id}", {
            **extra,
            "agent_type": self.inst.agent_type,
            "node": self.inst.node_id,
            "qsize": self.inst.qsize(),
            "busy": self.inst.busy,
            "inflight": len(self.inst.running),
            "busy_until": m.busy_until,
            "ema_service": m.ema_service,
            "completed": m.completed,
            "failed": m.failed,
            "retries": m.retries,
            "cancelled": m.cancelled,
            "expired": m.expired,
            "alive": self.inst.alive,
            "waiting_sessions": list(self.inst.waiting_sessions),
            "updated_at": self.kernel.now(),
        })
