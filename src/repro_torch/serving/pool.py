"""Multi-replica engine pool: real ``InferenceEngine`` replicas behind one
agent type, with policy-driven routing and live session migration.

The bridge makes a *single* engine a NALAR component; this module makes N
of them (possibly heterogeneous configs) the instances of one agent type, so
the paper's two-level control machinery — ``route`` / ``route_weighted`` /
``migrate`` actions computed by the ``GlobalController`` — resolves to
concrete replicas instead of simulated instances:

* **Placement is KV-aware.**  Each replica is an ordinary ``AgentInstance``;
  the Router's precedence (pin → KV locality → managed-state locality →
  weighted table → least-ETA) applies unchanged, so a session's follow-up
  lands where its prefix KV lives without any pool-specific routing code.
* **Migration ships pages when it can, replays tokens when it must.**
  ``migrate(session_id, src, dst)`` physically rebuilds the session on the
  destination.  When both replicas run geometry-compatible paged pools, the
  source's K/V pages are exported *before* the registry frees them and
  imported at the destination (deduplicated against its prefix index), so
  ``warm_session`` finds the prefix resident and prefills only the
  transcript tail — a page transfer instead of a full re-prefill.
  Otherwise (heterogeneous configs, opaque caches, ``page_migration``
  off) the managed-state layer materializes the ``SessionTranscript`` at
  the destination node and the destination engine prefills it straight
  into its cache pool (``InferenceEngine.warm_session``).  Either way the
  ``KVRegistry`` re-homes reuse expectations and the session's next call
  is a warm continuation on the new replica.
* **In-flight futures are never broken.**  If the session has a call running
  on the source engine, the migration defers until it resolves
  (``EngineBridge.defer_until_idle``); queued same-session calls move with
  the session and execute on the destination, in order.  (Same-session
  serialization is per-bridge: a call issued concurrently — mid-migration,
  or routed cache-blind to another replica — may run cold in parallel.
  That is always *safe*: the engine's fallback-prompt path rebuilds context
  at admission; what is lost is the warm-cache saving, not correctness of
  completion.)
* **Retry behavior is consistent.**  A migration to a dead or unknown
  replica falls back to the least-loaded live replica; a repeated migration
  to the session's current home is a no-op (no second replay prefill).

Layering: like ``bridge.py``, this file sees both sides; ``repro_torch.core``
still never imports serving.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.directives import Directives
from ..core.executor import EngineBackedMethod
from ..core.future import FutureState
from ..core.stubs import AgentSpec
from .bridge import EngineBridge, EngineMethod
from .engine import InferenceEngine
from .kv_cache import PagedKVPool
from .sampler import SamplingParams


class _UnboundPoolMethod(EngineBackedMethod):
    """Placeholder in the pool's ``AgentSpec``: every live replica gets its
    own per-instance ``EngineMethod``, so this only executes if an instance
    was provisioned outside ``register_engine_pool`` (e.g. a bare
    ``provision`` policy action).  Fail loudly instead of silently sharing
    another replica's engine."""

    def __init__(self, agent_type: str) -> None:
        self.agent_type = agent_type

    def capacity(self) -> int:
        return 1

    def launch(self, batch, controller) -> None:
        err = RuntimeError(
            f"instance {controller.inst.instance_id} of pool "
            f"{self.agent_type!r} has no engine replica bound; add replicas "
            f"through repro_torch.serving.pool.register_engine_pool")
        for f in batch:
            controller.complete_async(f, error=err)


class EnginePool:
    """N engine replicas serving one agent type.

    Owned by the runtime via ``runtime.engine_backends[name]``; the
    ``ComponentController`` delegates session migration commands here (the
    global controller's ``migrate`` action), and benchmarks read
    ``telemetry()`` / ``migrations`` for the paper's prefill-token evidence.
    """

    def __init__(self, runtime, name: str) -> None:
        self.rt = runtime
        self.name = name
        self.bridges: Dict[str, EngineBridge] = {}   # instance_id -> bridge
        self._lock = threading.Lock()
        # audit log of completed physical migrations (benchmarks assert on it)
        self.migrations: List[Dict[str, Any]] = []
        self.stats: Dict[str, int] = {
            "migrations": 0, "migrations_deferred": 0,
            "migrations_fallback": 0, "migrations_noop": 0,
            "futures_rerouted": 0, "replayed_tokens": 0,
            "migrations_page_shipped": 0, "pages_shipped": 0,
            "replica_failures": 0, "failed_inflight": 0,
            "sessions_recovered": 0,
        }
        # page-shipping fast path for migrate (export/import K/V pages
        # instead of transcript-replay re-prefill); benchmarks/tests can
        # force the replay path by clearing this
        self.page_migration = True

    # -------------------------------------------------------------- replicas
    def add_replica(self, instance_id: str, bridge: EngineBridge) -> None:
        with self._lock:
            self.bridges[instance_id] = bridge

    def _bump(self, key: str, n: int = 1) -> None:
        # counters are hit from controller threads and pump threads alike
        with self._lock:
            self.stats[key] += n

    @property
    def instance_ids(self) -> List[str]:
        with self._lock:
            return list(self.bridges)

    def bridge_of(self, instance_id: str) -> Optional[EngineBridge]:
        with self._lock:
            return self.bridges.get(instance_id)

    def live_replicas(self) -> List[str]:
        out = []
        for iid in self.instance_ids:
            inst = self.rt.instance(iid)
            if inst is not None and inst.alive:
                out.append(iid)
        return out

    def drain(self, timeout: float = 5.0) -> int:
        """Graceful pool shutdown: drain every replica's bridge (stop
        admitting, wait for in-flight work, fail-fast leftovers).  Futures
        mid-stream when their replica's timeout hits fail like any other
        in-flight work — their chunk iterators wake with the failure, so
        HTTP streams and pipelined consumers terminate promptly instead of
        hanging on a half-delivered answer.  Returns total futures
        failed-fast (0 = clean drain)."""
        failed = 0
        for iid in self.instance_ids:
            bridge = self.bridge_of(iid)
            if bridge is not None:
                failed += bridge.drain(timeout)
        if failed:
            self._bump("failed_inflight", failed)
        return failed

    # ------------------------------------------------------- replica failure
    def on_replica_killed(self, instance_id: str) -> None:
        """Fault-injection hook: ``runtime.kill_instance(iid, hard=True)``.

        The replica's engine results will never arrive, so (1) every
        in-flight and bridge-queued future fails with ``InstanceDied`` and
        travels the retry ladder — with retries enabled, the global
        controller's RetryPolicy reroutes each one to a surviving replica;
        (2) every session whose KV cache lived on the dead replica is
        proactively recovered on a survivor by ``SessionTranscript`` replay
        (the migration machinery with a fallback destination), so
        retried and follow-up calls resume warm instead of cold.  The pump
        is stopped so no zombie completion can race a retried attempt.
        """
        bridge = self.bridge_of(instance_id)
        if bridge is None:
            return
        n_failed = bridge.on_replica_killed(instance_id)
        recovered = 0
        for sid in self.rt.kv_registry.instance_sessions(instance_id):
            try:
                # empty destination -> _resolve_dst falls back to the
                # least-loaded surviving replica; replays the transcript
                if self.migrate_session(sid, instance_id, "") > 0:
                    recovered += 1
            except Exception:  # noqa: BLE001 — best-effort per session
                pass
        with self._lock:
            self.stats["replica_failures"] += 1
            self.stats["failed_inflight"] += n_failed
            self.stats["sessions_recovered"] += recovered

    # ------------------------------------------------------------- migration
    def _resolve_dst(self, dst_iid: str, avoid: str) -> Optional[str]:
        """Destination replica, with consistent-retry fallback: a dead or
        unknown destination becomes the least-loaded live replica."""
        inst = self.rt.instance(dst_iid)
        if inst is not None and inst.alive and self.bridge_of(dst_iid) is not None:
            return dst_iid
        now = self.rt.kernel.now()
        cands = [self.rt.instance(i) for i in self.instance_ids if i != avoid]
        cands = [i for i in cands if i is not None and i.alive]
        if not cands:
            return None
        self._bump("migrations_fallback")
        return min(cands, key=lambda i: i.load_score(now)).instance_id

    def migrate_session(self, session_id: str, src_iid: str,
                        dst_iid: str) -> int:
        """Move ``session_id`` from ``src_iid`` to ``dst_iid`` (Table 2
        ``migrate`` resolved against real replicas).

        Returns the number of futures re-routed plus one for the physical
        re-home, 0 for a no-op (already at the destination, no live
        destination, or the session lives on neither replica).  If the
        session has an in-flight call on the source, the move is scheduled
        to run the moment that call resolves and 1 is returned.

        Streaming composes with deferral for free: a partially-streamed
        in-flight call keeps streaming from the source until it completes
        (its chunks carry the source's owner fence), and only then does the
        session re-home — a consumer's chunk iterator never straddles two
        replicas mid-attempt.
        """
        if not session_id:
            return 0
        dst = self._resolve_dst(dst_iid, avoid=src_iid)
        if dst is None or dst == src_iid:
            self._bump("migrations_noop")
            return 0
        info = self.rt.kv_registry.lookup(session_id)
        home = info.instance_id if info is not None else None
        if home == dst:
            self._bump("migrations_noop")   # double-migrate: idempotent
            return 0
        if home is not None and home != src_iid and home in self.bridges:
            # stale command: the session has already moved elsewhere in the
            # pool; migrating it "from src" would race the real owner
            self._bump("migrations_noop")
            return 0

        src_bridge = self.bridge_of(src_iid)
        if src_bridge is not None:
            deferred = src_bridge.defer_until_idle(
                session_id,
                lambda queued: self._do_migrate(session_id, src_iid, dst,
                                                queued))
            if deferred:
                self._bump("migrations_deferred")
                return 1
        return self._do_migrate(session_id, src_iid, dst, [])

    def _do_migrate(self, sid: str, src_iid: str, dst_iid: str,
                    queued: List[Tuple[Any, Any, Any]]) -> int:
        """The physical move.  Runs with no same-session call in flight."""
        # A deferred move fires after an arbitrary delay (the in-flight call
        # ran to completion), so the destination chosen at schedule time may
        # have died in between — re-validate, with the same fallback.
        resolved = self._resolve_dst(dst_iid, avoid=src_iid)
        dst_ctrl = self.rt.controller_of(resolved) if resolved else None
        dst_bridge = self.bridge_of(resolved) if resolved else None
        if resolved is None or dst_ctrl is None or dst_bridge is None:
            # no live destination left: the session stays home and its
            # queued calls continue on the source, in order
            src_bridge = self.bridge_of(src_iid)
            for fut, controller, method in queued:
                try:
                    if src_bridge is None:
                        raise RuntimeError(
                            f"pool {self.name!r}: no live replica to run "
                            f"session {sid!r}")
                    src_bridge.submit_future(fut, controller, method)
                except BaseException as e:  # noqa: BLE001 — fail this call
                    controller.complete_async(fut, error=e)
            self._bump("migrations_noop")
            return 0
        dst_iid = resolved
        now = self.rt.kernel.now()

        # 0. Page-shipping fast path: snapshot the session's K/V pages at
        #    the source *before* the registry migrate frees them.  Only
        #    possible when both replicas run geometry-compatible paged
        #    pools, the destination can reuse a token-tagged prefix, and
        #    the source cache isn't opaque (no token provenance).
        transcript = dst_bridge.transcript.tokens(sid)
        payload = self._export_pages(src_iid, dst_bridge.engine, sid,
                                     transcript)

        # 1. Registry re-homes reuse expectations first: ``migrate`` moves
        #    the residency record and fires migrate_out at the source pool,
        #    freeing its pages.  (Must precede the replay — warm_session's
        #    ``touch`` would otherwise re-create the record at dst and turn
        #    the registry migrate into a no-op that never frees the source.)
        self.rt.kv_registry.migrate(sid, src_iid, dst_iid)

        # 2. State layer does the rebuild: reading the transcript through the
        #    destination bridge materializes it at the destination node.  If
        #    the page snapshot landed, warm_session finds the prefix already
        #    resident and prefills only the transcript tail; otherwise the
        #    destination engine prefills the full transcript straight into
        #    its session cache pool (touching the registry with the replayed
        #    count).  A follow-up racing this window hits the engine's
        #    fallback_prompt path — cold-at-admission is always safe.
        shipped = 0
        if payload is not None:
            if dst_bridge.engine.pool.import_session(sid, payload, now=now):
                shipped = int(payload["k"].shape[1])
        replayed = dst_bridge.engine.warm_session(sid, transcript)

        # 3. Any other managed state of the session follows it.
        self.rt.migrate_session_state(sid, self.name, dst_ctrl.inst.node_id)

        # 4. Routing re-home: new futures land on the destination.
        self.rt.router.pin(sid, self.name, dst_iid)

        # 5. Re-route work that was waiting behind the in-flight call:
        #    first the bridge's session queue (already launched, in order),
        #    then anything still sitting in the source controller's queue.
        src_ctrl = self.rt.controller_of(src_iid)
        ctl_queued: List[Any] = []
        if src_ctrl is not None:
            ctl_queued = src_ctrl.take_session_futures(sid)
        moved = 0
        for fut, _ctrl, _method in queued:
            moved += self._reroute(fut, src_ctrl, dst_ctrl)
        for fut in ctl_queued:
            moved += self._reroute(fut, src_ctrl, dst_ctrl)

        with self._lock:
            self.migrations.append(dict(
                session_id=sid, src=src_iid, dst=dst_iid,
                replayed_tokens=replayed, futures_moved=moved, at=now,
                mode="pages" if shipped else "replay",
                pages_shipped=shipped))
            self.stats["migrations"] += 1
            self.stats["futures_rerouted"] += moved
            self.stats["replayed_tokens"] += replayed
            if shipped:
                self.stats["migrations_page_shipped"] += 1
                self.stats["pages_shipped"] += shipped
        return moved + 1

    def _export_pages(self, src_iid: str, dst_engine: InferenceEngine,
                      sid: str, transcript: List[int]
                      ) -> Optional[Dict[str, Any]]:
        """Session K/V payload for page-shipping, or ``None`` when the
        replicas cannot exchange pages: ``page_migration`` off, either pool
        unpaged or geometry-incompatible, the destination engine unable to
        extend a resident prefix (sharing disabled), or the source cache
        opaque (no token provenance — the destination could not verify what
        the bytes cover, so the transcript replay is the safe path).

        The payload is trimmed to the longest source-cache prefix that
        matches the transcript: a multi-turn cache skips each turn's final
        generated token (sampled but never fed), so only the prefix up to
        the first such hole is worth shipping — the destination's
        ``warm_session`` prefills the rest from the transcript."""
        if not self.page_migration:
            return None
        src_bridge = self.bridge_of(src_iid)
        if src_bridge is None:
            return None
        src_pool = src_bridge.engine.pool
        dst_pool = dst_engine.pool
        if not (isinstance(src_pool, PagedKVPool)
                and isinstance(dst_pool, PagedKVPool)
                and getattr(dst_engine, "_prefix_share_ok", False)
                and src_pool.compatible_with(dst_pool)):
            return None
        try:
            payload = src_pool.export_session(sid)
        except Exception:  # noqa: BLE001 — fall back to transcript replay
            return None
        if (payload is None or not payload.get("tokens")
                or len(payload.get("token_ids") or ())
                != payload["tokens"]):
            return None
        ids = payload["token_ids"]
        common = 0
        for a, b in zip(ids, transcript):
            if int(a) != int(b):
                break
            common += 1
        if common == 0:
            return None
        if common < payload["tokens"]:
            pages = -(-common // payload["page_size"])     # ceil div
            payload = dict(payload, k=payload["k"][:, :pages],
                           v=payload["v"][:, :pages],
                           tokens=common, token_ids=list(ids[:common]))
        return payload

    def _reroute(self, fut, src_ctrl, dst_ctrl) -> int:
        """Hand one not-yet-executed session future to the destination."""
        if fut is None or fut.available:
            return 0
        if src_ctrl is not None:
            src_ctrl.detach_running(fut)
        fut._set_state(FutureState.PENDING)
        self.rt.telemetry.on_migration(
            fut, src_ctrl.inst.instance_id if src_ctrl else "",
            dst_ctrl.inst.instance_id, self.rt.kernel.now())
        dst_ctrl.submit(fut)
        return 1

    def cancel_inflight(self, fid: str, instance_id: str = "") -> bool:
        """Hedge-loser cancellation resolved to the owning replica bridge."""
        bridge = self.bridge_of(instance_id)
        if bridge is not None:
            return bridge.cancel_inflight(fid, instance_id)
        return False

    # ------------------------------------------------------------- telemetry
    def saturation_of(self, instance_id: str) -> float:
        """Wait-queue saturation of one replica (Router shed hook)."""
        bridge = self.bridge_of(instance_id)
        return bridge.engine.saturation() if bridge is not None else 0.0

    def instance_metrics(self, instance_id: str) -> Dict[str, Any]:
        """Per-replica engine gauges for the controller's metrics mirror."""
        bridge = self.bridge_of(instance_id)
        return bridge.instance_metrics(instance_id) if bridge else {}

    def telemetry(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"pool": self.name, "stats": dict(self.stats),
                               "replicas": {}}
        for iid in self.instance_ids:
            bridge = self.bridge_of(iid)
            if bridge is not None:
                out["replicas"][iid] = bridge.telemetry()
        return out


def register_engine_pool(runtime, name: str,
                         engines: List[InferenceEngine], *,
                         methods: Tuple[str, ...] = ("generate",),
                         sampling: Optional[SamplingParams] = None,
                         encode: Optional[Callable[..., List[int]]] = None,
                         decode: Optional[Callable] = None,
                         nodes: Optional[List[str]] = None,
                         resources: Optional[Dict[str, float]] = None):
    """Register ``len(engines)`` real-engine replicas as one agent type.

    Returns the stub.  Each engine becomes one NALAR agent instance with its
    own ``EngineBridge`` and pump thread; the ``EnginePool`` is installed as
    the agent type's backend (``runtime.engine_backends[name]``) so global
    ``migrate`` actions replay transcripts across replicas.  Replicas may be
    heterogeneous (different ``max_batch`` / ``max_seq`` / model configs):
    routing weights and ETAs are per-instance, and migration moves tokens
    rather than cache pages.

    Requires ``NalarRuntime(simulate=False)`` for the same reason as
    ``register_engine_agent``: engine completions arrive in wall-clock time.
    """
    from ..core.clock import RealTimeKernel
    if not isinstance(runtime.kernel, RealTimeKernel):
        raise RuntimeError(
            "engine pools need a real-time runtime; construct "
            "NalarRuntime(simulate=False) (the SimKernel's virtual time "
            "cannot wait on wall-clock engine completions)")
    if not engines:
        raise ValueError("engine pool needs at least one engine")

    pool = EnginePool(runtime, name)
    spec = AgentSpec(
        name=name,
        methods={mn: _UnboundPoolMethod(name) for mn in methods},
        directives=Directives(max_instances=len(engines), min_instances=1,
                              uses_managed_state=True,
                              resources=resources or {}))
    stub = runtime.register_agent(spec, nodes=nodes or list(runtime.nodes),
                                  instances=len(engines))
    iids = runtime.instances_of_type(name)
    if len(iids) != len(engines):
        raise RuntimeError(
            f"pool {name!r}: provisioned {len(iids)} of {len(engines)} "
            f"replicas (node resources exhausted?)")
    default_sampling = sampling or SamplingParams(max_new_tokens=16)
    for iid, engine in zip(iids, engines):
        inst = runtime.instance(iid)
        bridge = EngineBridge(runtime, engine, agent_type=name)
        bridge.attach(iid, inst.node_id)
        method = EngineMethod(bridge=bridge, sampling=default_sampling,
                              encode=encode, decode=decode)
        inst.methods = {mn: method for mn in methods}
        pool.add_replica(iid, bridge)
    runtime.engine_backends[name] = pool
    # publish each replica's mirror now that the backend is installed:
    # engine gauges (tier label, saturation) must reach the ClusterView
    # before first traffic, or an idle replica stays invisible to
    # tier/shed policies until something routes to it by accident
    for iid in iids:
        ctrl = runtime.controller_of(iid)
        if ctrl is not None:
            ctrl._publish_metrics()
    return stub
