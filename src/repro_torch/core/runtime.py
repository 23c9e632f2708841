"""The NALAR runtime: deployment, routing, and the glue between layers.

``NalarRuntime`` owns the kernel, node stores, future table, session registry,
state layer, KV registry, telemetry, agent instances and their controllers,
and the global controller.  ``deployment`` (bottom) is the thin user-facing
entry mirroring the paper's ``deployment.main(...)``.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from .clock import Kernel, RealTimeKernel, SimKernel
from .controller_global import GlobalController
from .controller_local import ComponentController
from .directives import Directives
from .executor import AgentInstance, EmulatedMethod, EngineBackedMethod
from .future import DeadlineExceeded, Future, FutureState, FutureTable
from .kv_registry import KVRegistry
from .node_store import StoreCluster
from .policy import Policy, default_policies
from .session import (SessionRegistry, clear_context, get_context,
                      get_current_deadline, set_context, set_current_deadline)
from .state import SessionStateStore
from .stubs import AgentSpec, Stub
from .telemetry import Telemetry

_current_runtime: Optional["NalarRuntime"] = None
_rt_lock = threading.Lock()


def current_runtime() -> Optional["NalarRuntime"]:
    return _current_runtime


def _set_current(rt: Optional["NalarRuntime"]) -> None:
    global _current_runtime
    with _rt_lock:
        _current_runtime = rt


@dataclass
class EscalationRecord:
    """A failure a component controller could not absorb locally, parked
    until the global controller's RetryPolicy decides its fate."""

    fut: Future
    error: BaseException
    src_instance: str
    reason: str               # "budget_exhausted" | "instance_death"
    at: float


class Router:
    """Routing decisions for newly created futures.

    Precedence: session pin (stateful / route primitive) → managed-state
    locality → weighted table (load-balance policy) → least-ETA default.
    """

    def __init__(self, runtime: "NalarRuntime") -> None:
        self.rt = runtime
        self._pins: Dict[tuple, str] = {}        # (sid, agent_type) -> iid
        self._weights: Dict[str, tuple] = {}     # agent_type -> (iids, cum_w)
        self._tiers: Dict[str, Dict[str, List[str]]] = {}  # at -> tier -> iids
        self._rng = random.Random(0xA11CE)
        # default-routing capability: "least_eta" (NALAR's native policy-1
        # load balancing), "least_qlen" (queue-length only — blind to
        # in-flight service time, the HoL trap), "round_robin"
        self.mode = "least_eta"
        self._rr: Dict[str, int] = {}
        # native cache/state locality (steps 2a/2b below).  On by default —
        # disabling it models baseline systems that spray sessions across
        # replicas and pay a full-context rebuild per call (the pooled-
        # routing benchmark compares exactly this), or lets an explicit
        # KVAffinityPolicy own the decision through `route` pins instead.
        self.kv_affinity = True
        # admission-control shedding: when an engine-backed instance's wait
        # queue is above this saturation fraction and a less-saturated
        # sibling exists, route there instead — even past a session pin or
        # KV-affinity hit (paying a cold prefill beats queueing into
        # collapse).  None disables shedding.
        self.shed_watermark: Optional[float] = 0.75

    def _saturation_fn(self, agent_type: str):
        """Backend queue-saturation probe, if the agent is engine-backed."""
        if self.shed_watermark is None:
            return None
        backend = self.rt.engine_backends.get(agent_type)
        if backend is None or not hasattr(backend, "saturation_of"):
            return None
        return backend.saturation_of

    def pin(self, session_id: str, agent_type: str, instance: str) -> None:
        self._pins[(session_id, agent_type)] = instance

    def unpin(self, session_id: str, agent_type: str) -> None:
        self._pins.pop((session_id, agent_type), None)

    def set_weights(self, agent_type: str, instances: List[str],
                    weights: List[float]) -> None:
        cum, s = [], 0.0
        for w in weights:
            s += w
            cum.append(s)
        self._weights[agent_type] = (list(instances), cum)

    def set_tiers(self, agent_type: str,
                  tiers: Dict[str, List[str]]) -> None:
        """Install the ``route_tier`` table: tier label -> instance ids."""
        self._tiers[agent_type] = {t: list(ids) for t, ids in tiers.items()}

    def route(self, fut: Future) -> Optional[AgentInstance]:
        at = fut.meta.agent_type
        sid = fut.meta.session_id
        live = self.rt.live_instances(at)
        if not live:
            return None
        spec = self.rt.spec_of(at)
        sat_of = self._saturation_fn(at)

        def shed(inst: AgentInstance) -> bool:
            """True when ``inst`` is past the watermark and a fresher
            sibling exists: fall through to load-based routing."""
            if sat_of is None:
                return False
            if sat_of(inst.instance_id) < self.shed_watermark:
                return False
            return any(sat_of(i.instance_id) < self.shed_watermark
                       for i in live if i.instance_id != inst.instance_id)

        # 1. explicit/stateful pin
        pin = self._pins.get((sid, at))
        if pin is not None:
            inst = self.rt.instance(pin)
            if inst is not None and inst.alive:
                # stateful sessions are never shed: they may not migrate
                # (§5), and falling through would re-pin them elsewhere
                if spec.directives.stateful or not shed(inst):
                    return inst
                # saturated: shed this call (keep the pin — follow-ups
                # return home once the queue drains)
            else:
                self.unpin(sid, at)
        if spec.directives.stateful and sid:
            inst = min(live, key=lambda i: i.load_score(self.rt.kernel.now()))
            self.pin(sid, at, inst.instance_id)  # sticky forever (§5)
            return inst
        # 2a. K,V-cache locality: route the session to the instance holding
        # its cache (§4.3.2 — "scheduling is rendered sticky").  NALAR's HoL
        # policy relieves this by *migrating the cache*, after which the
        # registry points follow-ups at the new instance.
        if self.kv_affinity and spec.directives.uses_managed_state and sid:
            info = self.rt.kv_registry.lookup(sid)
            if info is not None:
                inst = self.rt.instance(info.instance_id)
                if (inst is not None and inst.alive
                        and inst.agent_type == at and not shed(inst)):
                    return inst
        # 2b. managed-state locality: prefer the node holding session state
        if self.kv_affinity and spec.directives.uses_managed_state and sid:
            names = self.rt.state_store.session_state_names(sid, at)
            if names:
                node = self.rt.state_store.placement_of(sid, at, names[0])
                local = [i for i in live if i.node_id == node
                         and not shed(i)]
                if local:
                    return min(local, key=lambda i: i.load_score(self.rt.kernel.now()))
        # 2c. model-tier hint (route_tier primitive): restrict the candidate
        # pool to the hinted tier's replicas.  SLO-aware fallback: when the
        # whole tier sits at/above the shed watermark while another tier
        # still has a fresh replica, the hint yields to the shed — a hint
        # is a preference, never a hard pin.
        tier_pool = None
        tiers = self._tiers.get(at)
        tier_hint = fut.meta.work_hint.get("model_tier") if tiers else None
        if tier_hint is not None:
            ids = set(tiers.get(str(tier_hint), ()))
            pool = [i for i in live if i.instance_id in ids]
            if pool and not (
                    sat_of is not None
                    and not any(sat_of(i.instance_id) < self.shed_watermark
                                for i in pool)
                    and any(sat_of(i.instance_id) < self.shed_watermark
                            for i in live)):
                tier_pool = pool
                live = pool
        # shed saturated replicas from default/weighted selection while a
        # below-watermark sibling exists (backpressure-aware routing)
        if sat_of is not None:
            fresh = [i for i in live
                     if sat_of(i.instance_id) < self.shed_watermark]
            if fresh:
                live = fresh
        # 3. weighted table installed by the global policy
        wt = self._weights.get(at)
        if wt is not None:
            iids, cum = wt
            allowed = {i.instance_id for i in live}
            valid = [(i, c) for i, c in zip(iids, cum)
                     if self.rt.instance(i) is not None
                     and self.rt.instance(i).alive
                     and (i in allowed or not (sat_of or tier_pool))]
            if valid:
                r = self._rng.random() * valid[-1][1]
                for iid, c in valid:
                    if r <= c:
                        inst = self.rt.instance(iid)
                        if inst is not None:
                            return inst
        # 4. default routing, per capability mode
        if self.mode == "round_robin":
            idx = self._rr.get(at, 0)
            self._rr[at] = idx + 1
            return live[idx % len(live)]
        if self.mode == "least_qlen":
            return min(live, key=lambda i: (i.qsize(), i.instance_id))
        return min(live, key=lambda i: i.load_score(self.rt.kernel.now()))


class NalarRuntime:
    def __init__(self, *, simulate: bool = True,
                 nodes: Optional[Dict[str, Dict[str, float]]] = None,
                 policy: Optional[Policy] = None,
                 control_interval: float = 0.25,
                 net_latency_same_node: float = 5e-5,
                 net_latency_cross_node: float = 5e-4,
                 state_bandwidth: float = 1e9,
                 future_gc_threshold: int = 4096,
                 seed: int = 0) -> None:
        self.kernel: Kernel = SimKernel() if simulate else RealTimeKernel()
        self.stores = StoreCluster()
        self.futures = FutureTable(gc_threshold=future_gc_threshold)
        self.sessions = SessionRegistry()
        self.telemetry = Telemetry()
        self.kv_registry = KVRegistry()
        self.state_store = SessionStateStore(self.stores)
        self.router = Router(self)
        self.rng = random.Random(seed)
        self._net_same = net_latency_same_node
        self._net_cross = net_latency_cross_node
        self._state_bw = state_bandwidth
        # cluster resources
        self.nodes: Dict[str, Dict[str, float]] = dict(
            nodes or {"n0": {"GPU": 8, "CPU": 64}})
        self._used: Dict[str, Dict[str, float]] = {
            n: {k: 0.0 for k in caps} for n, caps in self.nodes.items()}
        for n in self.nodes:
            self.stores.get(n)  # materialize node stores
        # agents
        self._specs: Dict[str, AgentSpec] = {}
        self._stubs: Dict[str, Stub] = {}
        self._instances: Dict[str, AgentInstance] = {}
        self._controllers: Dict[str, ComponentController] = {}
        self._instance_counter: Dict[str, int] = {}
        self._agent_ctx = threading.local()
        # real execution backends (serving bridges) attached to agent types;
        # populated by repro_torch.serving.bridge.register_engine_agent
        self.engine_backends: Dict[str, Any] = {}
        # failure handling: escalated futures awaiting a RetryPolicy decision,
        # and instances the router must never pick again (dead replicas)
        self._esc_lock = threading.Lock()
        self.escalations: Dict[str, EscalationRecord] = {}
        self.blacklist: set = set()
        # hedged dispatch (latency-fault handling): fid -> (src, dst) for
        # futures currently racing a duplicate attempt.  First completion
        # wins (terminal-state guard in complete_async); the loser is
        # cancelled/detached by on_future_resolved.
        self._hedge_lock = threading.Lock()
        self._hedges: Dict[str, tuple] = {}
        self._hedge_claimed: set = set()
        self.hedges_issued = 0
        self._shutdown_hooks: List[Callable[[], None]] = []
        self.global_controller = GlobalController(
            self, policy or default_policies(), interval=control_interval)
        _set_current(self)

    # ---------------------------------------------------------- agent mgmt
    def register_agent(self, spec: AgentSpec,
                       nodes: Optional[List[str]] = None,
                       instances: Optional[int] = None) -> Stub:
        spec.validate()
        self._specs[spec.name] = spec
        stub = Stub(self, spec)
        self._stubs[spec.name] = stub
        n = instances if instances is not None else spec.directives.min_instances
        node_list = nodes or list(self.nodes)
        for i in range(n):
            self.provision_instance(spec.name, node_list[i % len(node_list)])
        return stub

    def apply_directives(self, agent_type: str, overrides: Dict[str, Any]) -> None:
        spec = self._specs[agent_type]
        spec.directives = spec.directives.merged(**overrides)
        # already-provisioned instances adopt the new directives too —
        # ``stub.init(...)`` runs at deployment time, after ``register_agent``
        # provisioned the min_instances floor
        for inst in self._instances.values():
            if inst.agent_type == agent_type:
                inst.directives = spec.directives

    def spec_of(self, agent_type: str) -> AgentSpec:
        return self._specs[agent_type]

    def stub(self, agent_type: str) -> Stub:
        return self._stubs[agent_type]

    def provision_instance(self, agent_type: str, node: str) -> Optional[str]:
        spec = self._specs[agent_type]
        live = self.live_instances(agent_type)
        if len(live) >= spec.directives.max_instances:
            return None
        if not self._reserve(node, spec.directives.resources):
            return None
        idx = self._instance_counter.get(agent_type, 0)
        self._instance_counter[agent_type] = idx + 1
        iid = f"{agent_type}:{node}/{idx}"
        inst = AgentInstance(agent_type, iid, node, spec.methods,
                             spec.directives)
        self._instances[iid] = inst
        self._controllers[iid] = ComponentController(self, inst)
        return iid

    def kill_instance(self, instance_id: str,
                      drain_to: Optional[str] = None,
                      hard: bool = False) -> None:
        """Stop an instance.

        Graceful (default): respects the ``min_instances`` floor and lets
        in-flight work finish (the policy-layer ``kill`` action).
        ``hard=True`` is the fault-injection API: the instance *dies* —
        no floor (real failures don't respect one), queued work re-routes,
        and in-flight futures fail with ``InstanceDied`` and travel the
        retry ladder.  Engine-backed instances additionally recover their
        resident sessions on surviving replicas by transcript replay
        (``on_replica_killed`` on the serving backend).
        """
        inst = self._instances.get(instance_id)
        if inst is None or not inst.alive:
            return
        spec = self._specs[inst.agent_type]
        if not hard:
            live = self.live_instances(inst.agent_type)
            if len(live) <= spec.directives.min_instances:
                return  # never go below the floor (Table 1 min_instances)
        ctrl = self._controllers[instance_id]
        ctrl.shutdown(drain_to=drain_to, hard=hard)
        if hard:
            backend = self.engine_backends.get(inst.agent_type)
            if backend is not None and hasattr(backend, "on_replica_killed"):
                backend.on_replica_killed(instance_id)
        self._release(inst.node_id, spec.directives.resources)

    def instance(self, instance_id: str) -> Optional[AgentInstance]:
        return self._instances.get(instance_id)

    def controller_of(self, instance_id: str) -> Optional[ComponentController]:
        return self._controllers.get(instance_id)

    def live_instances(self, agent_type: str) -> List[AgentInstance]:
        return [i for i in self._instances.values()
                if i.agent_type == agent_type and i.alive
                and i.instance_id not in self.blacklist]

    def instances_of_type(self, agent_type: str) -> List[str]:
        return [i.instance_id for i in self.live_instances(agent_type)]

    def node_of_instance(self, caller: str) -> str:
        inst = self._instances.get(caller)
        if inst is not None:
            return inst.node_id
        return next(iter(self.nodes))  # drivers live on the entry node

    # ------------------------------------------------------------ resources
    def _reserve(self, node: str, res: Dict[str, float]) -> bool:
        caps = self.nodes.get(node)
        if caps is None:
            return False
        used = self._used[node]
        for k, v in res.items():
            if used.get(k, 0.0) + v > caps.get(k, 0.0):
                return False
        for k, v in res.items():
            used[k] = used.get(k, 0.0) + v
        return True

    def _release(self, node: str, res: Dict[str, float]) -> None:
        used = self._used.get(node, {})
        for k, v in res.items():
            used[k] = max(0.0, used.get(k, 0.0) - v)

    def free_resources(self) -> Dict[str, Dict[str, float]]:
        return {n: {k: caps[k] - self._used[n].get(k, 0.0) for k in caps}
                for n, caps in self.nodes.items()}

    # --------------------------------------------------------------- network
    def net_latency(self, src_node: str, dst_node: str) -> float:
        return self._net_same if src_node == dst_node else self._net_cross

    def state_transfer_delay(self, src_node: str, dst_node: str,
                             nbytes: int) -> float:
        if src_node == dst_node:
            return self._net_same
        return self._net_cross + nbytes / self._state_bw

    # -------------------------------------------------------------- dispatch
    def add_future(self, fut: Future) -> None:
        """Register a newly created future; opportunistically retire resolved
        ones (and their node-store mirrors) once the table outgrows its
        threshold, keeping long-running deployments memory-flat."""
        self.futures.add(fut)
        if self.futures.needs_sweep():
            scrub: Dict[str, List[str]] = {}
            for f in self.futures.sweep():
                for node in f.meta.mirror_nodes:
                    scrub.setdefault(node, []).append(f"future:{f.fid}")
            for node, keys in scrub.items():
                self.stores.get(node).delete_many(keys)

    def dispatch(self, fut: Future) -> None:
        self.mirror_future(fut)
        inst = self.router.route(fut)
        if inst is None:
            fut.fail(RuntimeError(
                f"no live instance of agent {fut.meta.agent_type!r}"),
                self.kernel.now())
            # reachable mid-run since hard kills: parked dependents must
            # observe the failure or they stay parked forever
            self.push_ready(fut)
            return
        ctrl = self._controllers[inst.instance_id]
        src_node = self.node_of_instance(fut.meta.creator)
        delay = self.net_latency(src_node, inst.node_id)
        self.kernel.schedule(delay, lambda: ctrl.submit(fut), tag="dispatch")

    def register_consumer(self, fut: Future) -> None:
        """Driver/agent blocked on ``fut.value()`` — record consumership."""
        _, _, caller = get_context()
        if caller not in fut.meta.consumers:
            fut.meta.consumers.append(caller)
            self.mirror_future(fut)

    def register_dep_consumer(self, dep_fid: str,
                              ctrl: ComponentController) -> None:
        dep = self.futures.get(dep_fid)
        if dep is None:
            ctrl.on_dep_ready(dep_fid)
            return
        iid = ctrl.inst.instance_id
        if iid not in dep.meta.consumers:
            dep.meta.consumers.append(iid)
        if dep.available:
            # value already materialized: push immediately
            prod = self._instances.get(dep.meta.executor)
            src = prod.node_id if prod else ctrl.inst.node_id
            delay = self.net_latency(src, ctrl.inst.node_id)
            self.kernel.schedule(delay, lambda: ctrl.on_dep_ready(dep_fid))

    def mirror_future(self, fut: Future) -> None:
        """Write the metadata mirror into the executor/creator node store.

        The mirror is single-homed: re-homing (migration, escalated reroute)
        scrubs the copy from every previous node so exactly one store holds
        each future's metadata — the incremental ClusterView would otherwise
        have to arbitrate between divergent stale copies."""
        node = self.node_of_instance(fut.meta.executor or fut.meta.creator)
        for prev in fut.meta.mirror_nodes:
            if prev != node:
                self.stores.get(prev).delete(f"future:{fut.fid}")
        fut.meta.mirror_nodes = [node]
        self.stores.get(node).hset_many(f"future:{fut.fid}", {
            "state": fut.state.value,
            "agent_type": fut.meta.agent_type,
            "session": fut.meta.session_id,
            "executor": fut.meta.executor,
            "consumers": list(fut.meta.consumers),
            "dependencies": list(fut.meta.dependencies),
            "priority": fut.meta.priority,
            "created_at": fut.meta.created_at,
            "attempt": fut.meta.attempt,
        })

    def reprioritize_session(self, session_id: str) -> None:
        sess = self.sessions.get(session_id)
        if sess is None:
            return
        # by-session index: O(session's futures), not O(table)
        for fut in self.futures.futures_of_session(session_id):
            if not fut.available:
                fut.meta.priority = sess.priority_for(fut.meta.agent_type)

    # ------------------------------------------------------- fault handling
    def push_ready(self, fut: Future, src_node: Optional[str] = None) -> None:
        """Notify every consumer controller that ``fut`` resolved.

        Runtime-level counterpart of the producing controller's
        ``_push_consumers`` (which keeps a same-controller inline fast path);
        used by resolution paths that have no producing controller — a
        dispatch with no live instance, a RetryPolicy ``fail_future``, a
        cancellation of an unrouted future."""
        src = src_node or self.node_of_instance(fut.meta.executor
                                                or fut.meta.creator)
        for consumer in list(fut.meta.consumers):
            ctrl = self._controllers.get(consumer)
            if ctrl is not None:
                self.kernel.schedule(
                    self.net_latency(src, ctrl.inst.node_id),
                    lambda c=ctrl, f=fut.fid: c.on_dep_ready(f))

    def on_future_partial(self, fut: Future) -> None:
        """A streaming producer appended a chunk to ``fut``.

        Partial counterpart of :meth:`push_ready`: consumer controllers get
        a chance to unpark dependents whose ``stream_min_tokens`` hint is
        now satisfied, so inter-step pipelining starts before the producer
        resolves.  Fired per chunk — chunk counts are bounded by
        ``max_new_tokens``, and controllers ignore deps they aren't parked
        on, so the fan-out stays cheap."""
        if not fut.meta.consumers:
            return
        streamed = fut.streamed()
        src = self.node_of_instance(fut.meta.executor or fut.meta.creator)
        for consumer in list(fut.meta.consumers):
            ctrl = self._controllers.get(consumer)
            if ctrl is not None:
                self.kernel.schedule(
                    self.net_latency(src, ctrl.inst.node_id),
                    lambda c=ctrl, f=fut.fid, n=streamed:
                        c.on_dep_partial(f, n))

    def escalate(self, fut: Future, error: BaseException, src_instance: str,
                 reason: str) -> bool:
        """Rung 2 of the retry ladder: park the future (PENDING) for the
        global controller's RetryPolicy and nudge an off-cycle policy round.

        The nudge is a *non-periodic* kernel event, so under the SimKernel
        an escalation keeps virtual time alive until it is resolved — the
        periodic global tick alone would let the simulation quiesce with
        the future stranded.
        """
        if not fut.reset_for_retry(self.kernel.now()):
            return False        # already resolved (e.g. cancelled)
        fut.meta.escalations += 1
        with self._esc_lock:
            self.escalations[fut.fid] = EscalationRecord(
                fut=fut, error=error, src_instance=src_instance,
                reason=reason, at=self.kernel.now())
        self.mirror_future(fut)
        spec = self._specs.get(fut.meta.agent_type)
        delay = spec.directives.retry_backoff if spec is not None else 0.05
        self.kernel.schedule(delay, self.global_controller.handle_escalations,
                             tag=f"escalate:{fut.fid}")
        return True

    def pending_escalations(self) -> List[EscalationRecord]:
        with self._esc_lock:
            return list(self.escalations.values())

    def take_escalation(self, fid: str) -> Optional[EscalationRecord]:
        with self._esc_lock:
            return self.escalations.pop(fid, None)

    def apply_retry(self, fid: str, dst_instance: str) -> bool:
        """Enact a RetryPolicy ``retry_future`` decision: re-dispatch the
        escalated future on the chosen surviving replica."""
        rec = self.take_escalation(fid)
        if rec is None:
            return False
        fut = rec.fut
        if fut.state != FutureState.PENDING:
            return False        # cancelled while parked
        ctrl = self._controllers.get(dst_instance)
        if ctrl is None or not ctrl.inst.alive:
            self.dispatch(fut)  # destination vanished: let the router pick
            return True
        ctrl.inst.metrics.retries += 1
        sid = fut.meta.session_id
        spec = self._specs.get(fut.meta.agent_type)
        if sid and spec is not None and spec.directives.stateful:
            # the "sticky forever" pin points at the dead instance; re-home it
            self.router.pin(sid, fut.meta.agent_type, dst_instance)
        self.mirror_future(fut)
        ctrl.submit(fut)
        return True

    def fail_escalated(self, fid: str, reason: str = "") -> None:
        """Enact a RetryPolicy ``fail_future`` decision: the ladder is out of
        rungs — resolve the future with its original error."""
        rec = self.take_escalation(fid)
        if rec is None:
            return
        fut = rec.fut
        now = self.kernel.now()
        fut.fail(rec.error, now)
        self.telemetry.on_future_done(fut, None, now)
        # push readiness so parked dependents observe the failure
        self.push_ready(fut, src_node=self.node_of_instance(rec.src_instance))

    def blacklist_instance(self, instance_id: str) -> None:
        """Never route to ``instance_id`` again (dead/poisoned replica)."""
        self.blacklist.add(instance_id)

    # ------------------------------------------------------- hedged dispatch
    def hedge_candidates(self) -> List[Dict[str, Any]]:
        """In-flight *leaf* futures eligible for a hedged duplicate: running
        on a live instance, not already hedged.  The global controller feeds
        this into ``ClusterView.hedge_candidates`` each round; HedgePolicy
        compares ``elapsed`` against the pool's typical service time."""
        now = self.kernel.now()
        with self._hedge_lock:
            hedged = set(self._hedges)
        out: List[Dict[str, Any]] = []
        for iid, ctrl in list(self._controllers.items()):
            inst = ctrl.inst
            if not inst.alive:
                continue
            for f in list(inst.running):
                if (f.available or f.fid in hedged
                        or f.state != FutureState.RUNNING):
                    continue
                method = inst.methods.get(f.meta.method)
                if not isinstance(method, (EngineBackedMethod,
                                           EmulatedMethod)):
                    continue    # composite bodies cannot race (shared epoch)
                out.append(dict(fid=f.fid, instance=iid,
                                agent_type=inst.agent_type,
                                session=f.meta.session_id,
                                elapsed=now - f.meta.started_at))
        return out

    def apply_hedge(self, fid: str, dst_instance: str) -> bool:
        """Enact a HedgePolicy ``hedge_future`` decision: launch a duplicate
        of the straggling in-flight future on ``dst_instance``.

        The duplicate shares the original's run id — first completion wins
        through ``complete_async``'s terminal-state guard, and the loser's
        late result is dropped.  Only leaf methods (engine-backed or
        emulated) may race: a composite body would double-open the attempt's
        state epoch."""
        fut = self.futures.get(fid)
        if fut is None or fut.state != FutureState.RUNNING:
            return False
        src = fut.meta.executor
        if src == dst_instance:
            return False
        ctrl = self._controllers.get(dst_instance)
        if (ctrl is None or not ctrl.inst.alive
                or dst_instance in self.blacklist):
            return False
        method = ctrl.inst.methods.get(fut.meta.method)
        if not isinstance(method, (EngineBackedMethod, EmulatedMethod)):
            return False
        with self._hedge_lock:
            if fid in self._hedges:
                return False
            self._hedges[fid] = (src, dst_instance)
            self.hedges_issued += 1
        with ctrl._lock:
            ctrl.inst.running.append(fut)
        try:
            if isinstance(method, EngineBackedMethod):
                method.launch([fut], ctrl)
            else:
                ctrl._execute_emulated([fut], method)
        except BaseException:  # noqa: BLE001 — duplicate submit failed
            with self._hedge_lock:
                self._hedges.pop(fid, None)
            ctrl.detach_running(fut)
            return False
        ctrl._publish_metrics()
        return True

    def on_future_resolved(self, fut: Future) -> None:
        """Resolution hook: if ``fut`` was hedged, cancel/clean up the losing
        duplicate — detach it from both instances' running sets and abort the
        engine-side request so its slot and KV pages free up."""
        if not self._hedges:
            return
        with self._hedge_lock:
            rec = self._hedges.pop(fut.fid, None)
            self._hedge_claimed.discard(fut.fid)
        if rec is None:
            return
        src_iid, dst_iid = rec

        # deferred: we are inside a controller's completion path — touching
        # the sibling controller's bookkeeping here would re-enter its lock
        def cleanup() -> None:
            backend = self.engine_backends.get(fut.meta.agent_type)
            if backend is None:
                # emulated loser: its own completion event detaches it when
                # the service time elapses — the instance genuinely was busy
                # with the duplicate until then, so don't free it early
                return
            for iid in (src_iid, dst_iid):
                ctrl = self._controllers.get(iid)
                if ctrl is not None:
                    ctrl.detach_running(fut)
                if hasattr(backend, "cancel_inflight"):
                    backend.cancel_inflight(fut.fid, iid)

        self.kernel.schedule(0.0, cleanup, tag=f"hedge-cleanup:{fut.fid}")

    def claim_hedge_completion(self, fid: str) -> bool:
        """First-completion fence for hedged engine calls.  The winning
        bridge claims before extending the transcript / resolving the
        future; the simultaneous loser sees False and must stand down
        (drop its result entirely).  Unhedged futures always claim —
        the normal single-completion path is unaffected."""
        with self._hedge_lock:
            if fid not in self._hedges:
                return True
            if fid in self._hedge_claimed:
                return False
            self._hedge_claimed.add(fid)
            return True

    def cancel_future(self, fut: Future, reason: str = "cancelled") -> bool:
        """Cancel a future wherever it currently is — parked, queued, or in
        flight.  Queued work is dequeued; in-flight work keeps running but
        its completion is discarded (terminal-state + run-id guards).
        Returns False when the future is already resolved."""
        if fut.available:
            return False
        self.take_escalation(fut.fid)    # un-park if awaiting a retry ruling
        ctrl = self._controllers.get(fut.meta.executor)
        if ctrl is not None:
            return ctrl.cancel_local(fut, reason)
        if not fut.cancel(self.kernel.now(), reason):
            return False
        self.telemetry.on_future_done(fut, None, self.kernel.now())
        self.push_ready(fut)
        return True

    def cancel_session(self, session_id: str,
                       reason: str = "session cancelled") -> int:
        """Cancel every unresolved future of a session (user abandoned it).
        Returns the number of futures cancelled."""
        n = 0
        for fut in self.futures.futures_of_session(session_id):
            if not fut.available:
                n += bool(self.cancel_future(fut, reason))
        return n

    # ------------------------------------------------- managed-state support
    def migrate_session_state(self, session_id: str, agent_type: str,
                              dst_node: str) -> int:
        if not session_id:
            return 0
        return self.state_store.migrate_session(session_id, agent_type,
                                                dst_node)

    def mark_uses_managed_state(self, agent_type: str) -> None:
        spec = self._specs.get(agent_type)
        if spec is not None and not spec.directives.uses_managed_state:
            spec.directives.uses_managed_state = True
            spec.directives.validate()

    def enter_agent_context(self, fut: Future, inst: AgentInstance) -> None:
        prev = get_context() + (get_current_deadline(),)
        stack = getattr(self._agent_ctx, "stack", None)
        if stack is None:
            stack = []
            self._agent_ctx.stack = stack
        stack.append(prev)
        set_context(fut.meta.session_id, fut.meta.request_id,
                    inst.instance_id)
        # child calls made by this execution inherit the running future's
        # remaining deadline budget (stubs read it and take the min)
        set_current_deadline(fut.meta.deadline)
        # open the attempt's state epoch: managed-state writes made by this
        # execution are journaled under (fid, attempt) so a failed attempt
        # rolls back before any retry (exactly-once across retries)
        self.state_store.begin_epoch((fut.fid, fut.meta.attempt))

    def exit_agent_context(self) -> None:
        self.state_store.end_epoch_binding()
        stack = getattr(self._agent_ctx, "stack", None)
        if stack:
            sid, rid, caller, deadline = stack.pop()
            set_context(sid, rid, caller)
            set_current_deadline(deadline)
        else:
            clear_context()

    # --------------------------------------------------------------- drivers
    def submit_request(self, driver_fn: Callable[..., Any], *args,
                       session: Optional[str] = None, priority: float = 0.0,
                       delay: float = 0.0, deadline_s: Optional[float] = None,
                       on_done: Optional[Callable[[Any, Optional[BaseException]], None]] = None,
                       **kwargs) -> str:
        """Run a workflow driver as a request (optionally after ``delay``).

        ``deadline_s`` gives the whole request a budget: every future created
        by the driver (and transitively by agents it calls) inherits the
        remaining budget as an absolute deadline."""
        if session is None:
            session = self.sessions.new_session(self.kernel.now(),
                                                priority).session_id
        rid = self.sessions.new_request(session)

        def launch() -> None:
            self.telemetry.start_request(
                rid, session, self.kernel.now(),
                deadline_s=deadline_s if deadline_s is not None else -1.0)

            def body() -> None:
                set_context(session, rid, f"driver:{rid}")
                abs_deadline = -1.0
                if deadline_s is not None:
                    abs_deadline = self.kernel.now() + deadline_s
                    set_current_deadline(abs_deadline)
                err: Optional[BaseException] = None
                out: Any = None
                try:
                    out = driver_fn(*args, **kwargs)
                except BaseException as e:  # noqa: BLE001 — §5 fault reporting
                    err = e
                finally:
                    clear_context()
                    # the real deadline outcome: a stub call expired, or
                    # the driver finished after its budget ran out
                    missed = isinstance(err, DeadlineExceeded) or (
                        0 <= abs_deadline < self.kernel.now())
                    self.telemetry.end_request(rid, self.kernel.now(),
                                               failed=err is not None,
                                               deadline_exceeded=missed)
                if on_done is not None:
                    on_done(out, err)

            self.kernel.spawn_driver(body, name=f"request:{rid}")

        if delay > 0:
            self.kernel.schedule(delay, launch, tag="request-arrival")
        else:
            launch()
        return rid

    # ------------------------------------------------------------------- run
    def start(self) -> None:
        self.global_controller.start()

    def run(self, max_time: float = float("inf")) -> float:
        t = self.kernel.run(max_time=max_time)
        self.global_controller.stop()
        return t

    def add_shutdown_hook(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` on shutdown (engine bridges stop their pump threads)."""
        self._shutdown_hooks.append(fn)

    def shutdown(self) -> None:
        self.global_controller.stop()
        for fn in reversed(self._shutdown_hooks):
            try:
                fn()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        self._shutdown_hooks.clear()
        if current_runtime() is self:
            _set_current(None)


class deployment:
    """Paper-style entry: ``deployment.main(driver, *args)`` builds a default
    runtime (if none is active), runs one request to completion, returns the
    result."""

    @staticmethod
    def main(driver_fn: Callable[..., Any], *args,
             runtime: Optional[NalarRuntime] = None, **kwargs) -> Any:
        rt = runtime or current_runtime()
        if rt is None:
            raise RuntimeError("no active NalarRuntime; construct one first")
        result: Dict[str, Any] = {}

        def done(out, err):
            result["out"], result["err"] = out, err

        rt.start()
        rt.submit_request(driver_fn, *args, on_done=done, **kwargs)
        rt.run()
        if result.get("err") is not None:
            raise result["err"]
        return result.get("out")
