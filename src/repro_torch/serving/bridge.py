"""Bridge between NALAR futures and the port's ``InferenceEngine`` (the
port of the JAX package's ``serving/bridge.py``).

This is the module that turns the repo from a discrete-event *emulator* of
agent serving into an actual agent-serving system: a stub call on an
engine-backed agent creates an ordinary NALAR future, the runtime routes it
like any other, and the component controller hands it here — where it becomes
a ``serving.Request`` in the engine's continuous-batching queue.  A pump
thread steps the engine; completion callbacks resolve the futures.

Per-session KV state flows through the two core registries:

* ``KVRegistry`` (agent layer) knows which engine instance holds a session's
  cache and how many tokens it covers.  Before submitting, the bridge asks
  ``expect_reuse(session, instance)``: a warm cache means only the *new*
  tokens are sent (the engine appends them to the cached prefix — measurably
  fewer prefill tokens); a cold one means the full transcript is prefilled.
* ``SessionTranscript`` (managed state, ``core/state.py``) records every
  call's prompt + generated tokens under the session's identity, so that
  cold rebuilds and cross-instance migrations keep the conversation context
  without developer involvement (§3.3).

Layering: ``repro_torch.core`` never imports serving; the abstract
``EngineBackedMethod`` hook lives in ``core.executor`` and is implemented
here, keeping the core runtime importable without torch.
"""

from __future__ import annotations

import logging
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from ..core.directives import Directives
from ..core.executor import EngineBackedMethod
from ..core.future import (DeadlineExceeded, Future, InstanceDied,
                           resolve_args)
from ..core.state import SessionTranscript
from ..core.stubs import AgentSpec
from .batching import Request, RequestExpired
from .engine import InferenceEngine
from .sampler import SamplingParams

log = logging.getLogger(__name__)


def hash_tokenize(text: Any, vocab_size: int) -> List[int]:
    """Deterministic toy tokenizer: stable token id per whitespace word.

    The reproduction has no trained tokenizer; what matters for serving
    behaviour is that identical text maps to identical token ids (so prefix
    caching is exercised honestly) and ids stay inside the vocabulary.
    """
    words = str(text).split()
    if not words:
        return [0]
    return [zlib.crc32(w.encode()) % vocab_size for w in words]


@dataclass
class GenerationResult:
    """Value an engine-backed future resolves to (default decode)."""

    request_id: str
    session_id: str
    tokens: List[int]               # newly generated token ids
    prompt_tokens: int              # tokens actually sent this call
    prefix_reused_tokens: int       # prefix restored from the session cache
    engine_id: str = ""

    def __len__(self) -> int:
        return len(self.tokens)

    def __str__(self) -> str:
        return (f"GenerationResult({len(self.tokens)} tokens, "
                f"reused={self.prefix_reused_tokens}, via {self.engine_id})")


class EngineBridge:
    """Owns one ``InferenceEngine`` and its pump thread.

    ``submit_future`` is called by ``EngineMethod.launch`` on the component
    controller's thread; every engine step runs on the single pump thread
    (continuous batching), and future resolution re-enters the runtime via
    ``ComponentController.complete_async`` (kernel-scheduled, thread-safe).
    """

    def __init__(self, runtime, engine: InferenceEngine,
                 agent_type: str) -> None:
        self.rt = runtime
        self.engine = engine
        self.agent_type = agent_type
        self.transcript: Optional[SessionTranscript] = None
        self._cv = threading.Condition()
        self._pending = 0
        self._stop = False
        self._draining = False
        # request_id -> (future, controller): for failure propagation when
        # the pump loop itself dies (engine bug, OOM, ...)
        self._inflight: Dict[str, Tuple[Future, Any]] = {}
        # per-session ordering: a session's calls must hit the engine one at
        # a time (each call's prompt depends on the previous call's
        # transcript and cache), while different sessions batch freely
        self._session_active: set = set()
        self._session_q: Dict[str, Deque[Tuple[Future, Any, "EngineMethod"]]] = {}
        # session migrations deferred until the in-flight call resolves:
        # sid -> fn(remaining_queue).  A migration must never yank the KV
        # cache out from under a running request; it runs between calls.
        self._migrate_pending: Dict[str, Callable] = {}
        self._thread = threading.Thread(
            target=self._pump, daemon=True,
            name=f"engine-pump:{engine.instance_id}")
        self._thread.start()
        runtime.add_shutdown_hook(self.drain)

    # ------------------------------------------------------------- lifecycle
    def attach(self, instance_id: str, node_id: str) -> None:
        """Bind to the provisioned NALAR agent instance: one identity for
        routing, KV residency, and managed-state placement."""
        self.engine.bind_registry(self.rt.kv_registry, instance_id)
        self.transcript = SessionTranscript(self.rt.state_store,
                                            self.agent_type, node_id)

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():
            # never silently abandon a wedged pump: the daemon thread will
            # die with the process, but the operator must know it leaked
            log.warning("engine pump %s did not stop within 5s; "
                        "abandoning daemon thread", self.engine.instance_id)

    def drain(self, timeout: float = 5.0) -> int:
        """Graceful shutdown: stop admitting new futures, keep pumping until
        in-flight work completes (or ``timeout`` passes), then fail-fast
        whatever remains through the normal failure path instead of leaking
        it, and finally stop the pump thread.  Returns the number of
        requests failed-fast (0 = clean drain)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            self._draining = True
            while self._pending > 0 and time.monotonic() < deadline:
                self._cv.wait(timeout=0.1)
            leftover = self._pending
        failed = 0
        if leftover:
            log.warning("engine bridge %s drained with %d requests still "
                        "in flight; failing them fast",
                        self.engine.instance_id, leftover)
            failed = self.fail_inflight(InstanceDied(
                f"engine {self.engine.instance_id} shut down mid-flight"))
        self.stop()
        return failed

    def fail_inflight(self, error: BaseException) -> int:
        """Fail every in-flight and session-queued future with ``error`` and
        clear the bridge's session bookkeeping.  Deferred migrations still
        fire (with an empty queue) so their sessions re-home even though the
        queued calls died.  Returns the number of futures failed.

        Used when the engine itself dies (pump-loop crash) and when the
        replica is hard-killed (fault injection): either way the engine's
        results will never arrive, so the futures must travel the retry
        ladder now rather than hang.  Partially-streamed requests fail the
        same way: ``Future.fail`` wakes blocked chunk iterators, which
        terminate by raising the failure — a consumer mid-stream observes a
        drain/crash as a fast error, never a hang."""
        with self._cv:
            dead = list(self._inflight.values())
            dead += [(f, c) for q in self._session_q.values()
                     for (f, c, _m) in q]
            self._inflight.clear()
            self._session_q.clear()
            self._session_active.clear()
            self._pending = 0
            migs = list(self._migrate_pending.values())
            self._migrate_pending.clear()
        try:
            # drop queued/in-slot work and clear per-slot residue (pending
            # prompts) so nothing of the dead attempts leaks into recycled
            # slots if the engine is ever stepped again
            self.engine.abort_all()
        except Exception:  # noqa: BLE001 — engine may be the thing that died
            pass
        for fut, ctrl in dead:
            ctrl.complete_async(fut, error=error)
        for mig in migs:
            # still re-home the session: its queued futures died with
            # the engine, but follow-ups must not land here again
            try:
                mig([])
            except Exception:  # noqa: BLE001 — best-effort re-home
                pass
        return len(dead)

    def cancel_inflight(self, fid: str, instance_id: str = "") -> bool:
        """Withdraw one in-flight future's engine request (hedge-loser
        cancellation): the winning replica already resolved the future, so
        this engine's copy is pure waste — pull it from the wait queue or
        vacate its batch slot (reclaiming the slot and its KV pages), drop
        the completion callback, and release the session's ordering slot.
        Returns True if a request was actually withdrawn."""
        if instance_id and instance_id != self.engine.instance_id:
            return False
        with self._cv:
            rid = cancel_sid = None
            for r, (f, _c) in self._inflight.items():
                if f.fid == fid:
                    rid, cancel_sid = r, f.meta.session_id
                    break
            if rid is None:
                return False
            self._inflight.pop(rid, None)
            self._pending -= 1
            self._cv.notify_all()
        self.engine.cancel_request(rid)
        if cancel_sid:
            self._advance_session(cancel_sid)
        return True

    def on_replica_killed(self, instance_id: str) -> int:
        """Fault-injection hook (``runtime.kill_instance(..., hard=True)``):
        fail the in-flight work and stop the pump so no zombie completion
        resolves a retried future.  Returns the number of futures failed.
        ``EnginePool`` layers session recovery on top of this."""
        n = self.fail_inflight(InstanceDied(
            f"engine instance {instance_id} died"))
        self.stop()
        return n

    # ------------------------------------------------------------ submission
    def submit_future(self, fut: Future, controller,
                      method: "EngineMethod") -> None:
        if self.transcript is None:
            raise RuntimeError(
                "EngineBridge not attached to an agent instance; register "
                "the agent via repro_torch.serving.bridge.register_engine_agent")
        if fut.available:
            return      # cancelled/resolved before launch: nothing to run
        sid = fut.meta.session_id
        if sid:
            with self._cv:
                if sid in self._session_active:
                    # a same-session call is in flight: its completion will
                    # submit this one (the prompt depends on its outcome)
                    self._session_q.setdefault(sid, deque()).append(
                        (fut, controller, method))
                    return
                self._session_active.add(sid)
        try:
            self._submit_now(fut, controller, method)
        except BaseException:
            if sid:
                self._advance_session(sid)
            raise

    def defer_until_idle(self, sid: str, fn: Callable) -> bool:
        """If ``sid`` has an in-flight engine call, arrange for ``fn(queued)``
        to run once it resolves — *before* any queued same-session call is
        submitted — where ``queued`` is the list of (future, controller,
        method) tuples still waiting.  Returns True if deferred, False if the
        session is idle here (the caller should act immediately).

        This is the in-flight-future safety rule of session migration: the
        running request finishes where it started; everything after it moves.
        """
        with self._cv:
            if sid in self._session_active:
                self._migrate_pending[sid] = fn
                return True
        return False

    def _advance_session(self, sid: str) -> None:
        """Previous call of ``sid`` settled: submit the next queued one."""
        while True:
            with self._cv:
                # deferred migration takes priority over queued calls, and
                # must be checked under the same lock that deactivates the
                # session (a migrate request landing between those two steps
                # would otherwise never fire)
                mig = self._migrate_pending.pop(sid, None)
                if mig is not None:
                    # hand the whole remaining session queue to the deferred
                    # migration; the session is no longer active here
                    remaining = list(self._session_q.pop(sid, ()))
                    self._session_active.discard(sid)
                else:
                    q = self._session_q.get(sid)
                    if not q:
                        self._session_active.discard(sid)
                        self._session_q.pop(sid, None)
                        return
                    fut, controller, method = q.popleft()
            if mig is not None:
                mig(remaining)
                return
            if fut.available:
                continue    # cancelled while parked here: skip, pop the next
            try:
                self._submit_now(fut, controller, method)
                return
            except BaseException as e:  # noqa: BLE001 — fail this call only
                controller.complete_async(fut, error=e)

    def _submit_now(self, fut: Future, controller,
                    method: "EngineMethod") -> None:
        args, kwargs = resolve_args(
            fut.args, fut.kwargs,
            stream_min=fut.meta.work_hint.get("stream_min_tokens"))
        vocab = self.engine.cfg.vocab_size
        new_tokens = [int(t) % vocab for t in method.encode(*args, **kwargs)]

        hint = fut.meta.work_hint
        max_new = int(hint.get("out_tokens", method.sampling.max_new_tokens))
        sampling = replace(method.sampling, max_new_tokens=max_new)
        if "temperature" in hint:
            # per-call sampling override (the HTTP front end forwards the
            # OpenAI request's temperature; 0 = greedy)
            sampling = replace(sampling,
                              temperature=float(hint["temperature"]))

        sid = fut.meta.session_id
        iid = self.engine.instance_id
        prompt: List[int] = new_tokens
        fallback: Optional[List[int]] = None
        if sid:
            history = self.transcript.tokens(sid)
            # keep context within the engine's sequence budget
            room = max(1, self.engine.max_seq - max_new - len(new_tokens) - 1)
            history = history[-room:]
            if history:
                cached = self.rt.kv_registry.expect_reuse(sid, iid)
                full = history + new_tokens
                if cached > 0:
                    # warm cache on this instance: send only the suffix; the
                    # engine appends it to the cached prefix.  If the pool
                    # evicted the pages since we checked, the engine falls
                    # back to prefilling the full context.
                    prompt, fallback = new_tokens, full
                else:
                    prompt = full

        req = Request.make(prompt, session_id=sid,
                           sampling=sampling, priority=fut.meta.priority,
                           now=self.rt.kernel.now(), fallback_prompt=fallback)
        # stamp the wall clock here, not in engine.submit: TTFT must count
        # from when the bridge hands the request over, even if the engine
        # is mid-step when the submission lands
        req.submitted_wall = time.monotonic()
        if fut.meta.deadline >= 0:
            # kernel time -> engine wall clock: same absolute instant, so a
            # hedged duplicate on a sibling engine expires simultaneously
            req.deadline_wall = (time.monotonic()
                                 + (fut.meta.deadline - self.rt.kernel.now()))
        # run-id fence: if the replica dies and the future is retried on a
        # sibling, a late completion from this engine must not resolve it
        run_id = fut._run_id

        def on_chunk(r: Request, chunk: List[int]) -> None:
            # per-step tokens -> incremental future updates.  Doubly fenced:
            # expect_run drops chunks from a superseded attempt (retry /
            # preemption), owner drops a hedge duplicate racing the stream's
            # first producer (hedges share the run id).  The first accepted
            # chunk stamps workload-level TTFT.
            if fut.append_chunk(chunk, now=self.rt.kernel.now(),
                                expect_run=run_id, owner=iid):
                self.rt.telemetry.on_first_output(fut.meta.request_id,
                                                  self.rt.kernel.now())

        def on_done(r: Request) -> None:
            with self._cv:
                self._pending -= 1
                self._inflight.pop(r.request_id, None)
                self._cv.notify_all()
            if not self.rt.claim_hedge_completion(fut.fid):
                # hedge loser finishing in the winner's resolution window:
                # the winning replica owns the transcript and the future;
                # just release this bridge's per-session slot
                if sid:
                    self._advance_session(sid)
                return
            if fut.meta.executor != self.engine.instance_id:
                # hedged duplicate completing first: attribute the win to
                # the replica that actually produced the value
                self.rt.futures.set_executor(fut, self.engine.instance_id)
            value = err = None
            if r.expired:
                # the engine preempted (or rejected) this request because
                # its deadline passed: non-retryable by design, and the
                # partial tokens never reach the transcript
                err = DeadlineExceeded(
                    f"request {r.request_id} exceeded its deadline on "
                    f"{self.engine.instance_id}")
                if sid:
                    self._advance_session(sid)
                controller.complete_async(fut, error=err, expect_run=run_id)
                return
            try:
                # decode FIRST: if make_value raises, the attempt failed and
                # its tokens must never reach the transcript — a retry would
                # re-send them as history (exactly-once would break)
                value = method.make_value(r, self.engine.instance_id)
                if sid and not fut.available and fut._run_id == run_id:
                    # the conversation advances by this call's new tokens +
                    # the generation; any prefilled history was already in
                    # the transcript (rebuild paths must not duplicate it).
                    # Skip if the future was already resolved elsewhere
                    # (failed/cancelled): the caller never saw these tokens.
                    # Cap at the engine's context budget — older tokens can
                    # never be prefilled again, so storing them only bloats
                    # state migration.
                    self.transcript.extend(sid, new_tokens + list(r.generated),
                                           max_tokens=self.engine.max_seq)
            except BaseException as e:  # noqa: BLE001 — fault reporting (§5)
                err = e
            if err is None:
                # reconcile the chunk log with the final tokens before
                # materializing: the common case appends the unstreamed
                # tail; a hedge race that let the loser claim the stream is
                # truncated and replaced with the winner's tokens, so
                # consumers always assemble exactly the completion value
                fut.seal_stream([int(t) for t in r.generated], owner=iid,
                                expect_run=run_id)
            # deactivate the session BEFORE resolving the future: a caller
            # that migrates the session the moment ``value()`` returns must
            # see it idle, not spuriously deferred behind a request that has
            # already finished.  The transcript is final at this point, so a
            # queued same-session call submitted here reads correct history.
            if sid:
                self._advance_session(sid)
            try:
                if err is None:
                    controller.complete_async(fut, value=value,
                                              expect_run=run_id)
                else:
                    controller.complete_async(fut, error=err,
                                              expect_run=run_id)
            except BaseException as e:  # noqa: BLE001 — fault reporting (§5)
                controller.complete_async(fut, error=e, expect_run=run_id)

        with self._cv:
            if self._stop or self._draining:
                raise RuntimeError("engine bridge is stopped")
            self._pending += 1
            self._inflight[req.request_id] = (fut, controller)
        try:
            # may raise EngineOverloaded: the bounded wait queue is full.
            # The exception travels back through launch() into the retry
            # ladder — a *retryable* failure (backoff locally, escalate to
            # the RetryPolicy for a reroute) instead of unbounded queueing.
            self.engine.submit_async(req, on_done, on_chunk)
        except RequestExpired as e:
            with self._cv:
                self._pending -= 1
                self._inflight.pop(req.request_id, None)
            # expired work is worthless: convert the engine's retryable
            # admission error into the runtime's terminal DeadlineExceeded
            # so the retry ladder never re-arms it
            raise DeadlineExceeded(str(e)) from e
        except BaseException:
            with self._cv:
                self._pending -= 1
                self._inflight.pop(req.request_id, None)
            raise
        with self._cv:
            self._cv.notify_all()

    # ------------------------------------------------------------ pump loop
    def _pump(self) -> None:
        while True:
            with self._cv:
                while not self._stop and self._pending == 0:
                    self._cv.wait(timeout=0.25)
                if self._stop:
                    return
            try:
                self.engine.step()
                self.engine.drain_completions()
            except BaseException as e:  # noqa: BLE001 — engine died
                self.fail_inflight(e)

    def telemetry(self) -> Dict[str, Any]:
        t = dict(self.engine.telemetry())
        t["kv_reuse"] = dict(self.rt.kv_registry.stats)
        t["resident_sessions"] = self.rt.kv_registry.instance_sessions(
            self.engine.instance_id)
        with self._cv:
            t["bridge_inflight"] = self._pending
        return t

    # ------------------------------------------------- admission telemetry
    def saturation_of(self, instance_id: str = "") -> float:
        """Wait-queue saturation of the backing engine (Router shed hook)."""
        return self.engine.saturation()

    def instance_metrics(self, instance_id: str = "") -> Dict[str, Any]:
        """Engine data-plane gauges merged into the controller's metrics
        mirror each publish, so the queue-depth watermark reaches the
        ``InstanceView`` the global policies act on (EngineMetrics →
        bridge → view)."""
        e = self.engine
        return {
            "engine_queue": len(e.queue),
            "engine_active": int(e._active_mask.sum()),
            "engine_saturation": e.saturation(),
            "engine_rejects": e.queue.rejected,
            "engine_shared_prefix_hits": e.metrics.shared_prefix_hits,
            "engine_shared_prefix_tokens": e.metrics.shared_prefix_tokens,
            "engine_tier": getattr(e, "tier", ""),
            "engine_expired": e.metrics.expired,
            "engine_spec_acceptance": e.metrics.spec_acceptance,
            "engine_decode_tokens_per_step":
                e.metrics.decode_tokens_per_step,
        }


@dataclass
class EngineMethod(EngineBackedMethod):
    """Leaf LLM method executed on a real ``InferenceEngine``.

    Drop-in peer of ``EmulatedMethod`` in an ``AgentSpec.methods`` dict:
    same stubs, same futures, same routing/migration machinery — but the
    call lands in a continuous-batching engine instead of a latency model.

    ``encode(*args, **kwargs)`` maps the stub call to prompt token ids;
    ``decode(request)`` maps the finished engine request to the future's
    value (defaults: :func:`hash_tokenize` / :class:`GenerationResult`).
    Per-call ``_hint={"out_tokens": n}`` overrides the generation length,
    mirroring how the emulated ``LLMLatency`` consumes hints.
    """

    bridge: EngineBridge
    sampling: SamplingParams = field(
        default_factory=lambda: SamplingParams(max_new_tokens=16))
    encode: Optional[Callable[..., List[int]]] = None
    decode: Optional[Callable[[Request], Any]] = None

    def __post_init__(self) -> None:
        if self.encode is None:
            vocab = self.bridge.engine.cfg.vocab_size
            self.encode = lambda *a, **kw: hash_tokenize(
                " ".join(str(x) for x in a), vocab)

    def capacity(self) -> int:
        e = self.bridge.engine
        if e.max_queue:
            # bounded admission: overshoot slots+queue so the engine's
            # admission bound — not an invisible controller-side buffer —
            # is what says no.  Overflow fails fast through the retry
            # ladder (backoff / reroute / shed) instead of parking
            # upstream until it times out, which is exactly the unbounded
            # pathology the bound exists to prevent.
            return e.max_batch * 2 + e.max_queue
        # keep the wait queue primed one batch deep so freed slots refill
        # without a controller round-trip
        return e.max_batch * 2

    def launch(self, batch: List[Future], controller) -> None:
        for fut in batch:
            try:
                self.bridge.submit_future(fut, controller, self)
            except BaseException as e:  # noqa: BLE001 — bad encode/args must
                # fail only this future, not batch-mates already submitted
                controller.complete_async(fut, error=e)

    def make_value(self, req: Request, engine_id: str) -> Any:
        if self.decode is not None:
            return self.decode(req)
        return GenerationResult(
            request_id=req.request_id, session_id=req.session_id,
            tokens=list(req.generated), prompt_tokens=len(req.prompt),
            prefix_reused_tokens=req.prefix_reused_tokens,
            engine_id=engine_id)


def register_engine_agent(runtime, name: str, engine: InferenceEngine, *,
                          methods: Tuple[str, ...] = ("generate",),
                          sampling: Optional[SamplingParams] = None,
                          encode: Optional[Callable[..., List[int]]] = None,
                          decode: Optional[Callable[[Request], Any]] = None,
                          node: Optional[str] = None,
                          resources: Optional[Dict[str, float]] = None):
    """Register a real-engine-backed agent type on ``runtime``.

    Returns the stub.  The engine becomes the single instance of the agent
    type: its telemetry, KV residency and managed state are all tagged with
    the provisioned NALAR instance id, so the Router's cache-locality rule
    (§4.3.2) and session migration see one coherent component.

    Requires ``NalarRuntime(simulate=False)``: engine completions arrive in
    wall-clock time, which the virtual-time SimKernel cannot await.
    """
    from ..core.clock import RealTimeKernel
    if not isinstance(runtime.kernel, RealTimeKernel):
        raise RuntimeError(
            "engine-backed agents need a real-time runtime; construct "
            "NalarRuntime(simulate=False) (the SimKernel's virtual time "
            "cannot wait on wall-clock engine completions)")

    bridge = EngineBridge(runtime, engine, agent_type=name)
    m = EngineMethod(bridge=bridge,
                     sampling=sampling or SamplingParams(max_new_tokens=16),
                     encode=encode, decode=decode)
    spec = AgentSpec(
        name=name,
        methods={mn: m for mn in methods},
        directives=Directives(max_instances=1, min_instances=1,
                              uses_managed_state=True,
                              resources=resources or {}))
    node = node or next(iter(runtime.nodes))
    stub = runtime.register_agent(spec, nodes=[node], instances=1)
    iid = runtime.instances_of_type(name)[0]
    bridge.attach(iid, node)
    runtime.engine_backends[name] = bridge
    return stub
