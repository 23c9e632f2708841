"""Policy interface and primitives (paper §4.2, Table 2).

Policies are ordinary Python programs run by the global controller's
single-threaded, push-based loop.  They inspect a ``ClusterView`` (metrics
aggregated from node stores) and emit actions through the canonical
primitives:

    route(session_id, agent_type, instance)            session pinning
    route_weighted(agent_type, instances, weights)     weighted spraying
    route_tier(agent_type, {tier: [instances]})        model-tier routing
    set_priority(session_id, value[, agent_type])
    migrate(session_id, src_instance, dst_instance)
    migrate_future(fid, dst_instance)
    kill(instance)
    provision(agent_type, node)
    install_schedule(agent_type, LocalSchedule)        local queue ordering

Actions are *written to node stores*; component controllers consume them
asynchronously, keeping the global controller off the critical path.

The library at the bottom contains the paper's three default serving policies
(§6.1) plus the two §6.2 case studies (SRTF ≈12 lines, LPT ≈12 lines).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .controller_local import LocalSchedule


# ------------------------------------------------------------- cluster view
@dataclass
class InstanceView:
    instance_id: str
    agent_type: str
    node: str
    qsize: int
    busy: bool
    busy_until: float
    ema_service: float
    completed: int
    failed: int
    alive: bool
    waiting_sessions: List[str]
    # futures currently executing (async engine-backed instances carry many)
    inflight: int = 0
    # failure-handling telemetry (mirrors InstanceMetrics)
    retries: int = 0
    cancelled: int = 0
    # deadline enforcement: futures resolved DeadlineExceeded at launch on
    # this instance, and engine requests expired at admission/mid-decode
    expired: int = 0
    engine_expired: int = 0
    # data-plane backpressure (engine-backed instances only): wait-queue
    # depth, depth as a fraction of the admission bound (0.0 = unbounded or
    # empty, >= 1.0 = hard-rejecting), and rejections so far.  Policies use
    # the saturation watermark to shed/reroute *before* collapse.
    engine_queue: int = 0
    engine_saturation: float = 0.0
    engine_rejects: int = 0
    # cross-session prefix-cache effectiveness on this replica: admissions
    # that found a shared prefix resident, and the prefill tokens those hits
    # skipped.  KV-affinity-style policies read these to judge how much
    # prefix residency a replica actually converts into saved prefill.
    engine_prefix_hits: int = 0
    engine_prefix_tokens: int = 0
    # model-tier label of the replica's engine ("" = untiered) plus the
    # speculative-decode gauges: verifier acceptance rate and the
    # acceptance-weighted decode tokens/step (> 1 = speculation paying).
    # TierRoutePolicy builds its tier table from these.
    engine_tier: str = ""
    engine_spec_acceptance: float = 0.0
    engine_decode_tokens_per_step: float = 0.0

    def eta(self, now: float) -> float:
        rem = max(0.0, self.busy_until - now) if self.busy else 0.0
        ema = max(self.ema_service, 1e-3)
        if self.busy and rem == 0.0:
            # async backends never publish busy_until; charge in-flight
            # work at the EMA rate so least-ETA policies see engine load
            rem = self.inflight * ema
        return rem + self.qsize * ema


@dataclass
class ClusterView:
    now: float
    instances: Dict[str, InstanceView] = field(default_factory=dict)
    # agent_type -> [instance_id]
    by_type: Dict[str, List[str]] = field(default_factory=dict)
    # session_id -> priority
    session_priority: Dict[str, float] = field(default_factory=dict)
    # future metadata mirrors collected from node stores (Fig. 10 measures this)
    futures: Dict[str, dict] = field(default_factory=dict)
    # node -> free resources
    node_resources: Dict[str, Dict[str, float]] = field(default_factory=dict)
    # session_id -> (instance holding its K,V cache, cached tokens) — the
    # §4.3.2 residency snapshot, so policies can route for cache affinity
    kv_residency: Dict[str, tuple] = field(default_factory=dict)
    # failures escalated by component controllers awaiting a rerouting
    # decision: dicts with fid/agent_type/session/executor/attempt/
    # escalations/reason/error (consumed by RetryPolicy)
    escalated: List[Dict[str, Any]] = field(default_factory=list)
    # instances the runtime will no longer route to (dead replicas)
    blacklisted: set = field(default_factory=set)
    # in-flight leaf futures eligible for a hedged duplicate: dicts with
    # fid/instance/agent_type/session/elapsed (consumed by HedgePolicy)
    hedge_candidates: List[Dict[str, Any]] = field(default_factory=list)
    # --- delta-maintenance internals (incremental view collection) ---
    # raw (unpruned) waiting_sessions per instance as last read from its
    # mirror, plus the reverse index session -> instances naming it; kept so
    # a session whose liveness flips can re-filter exactly the affected
    # instances instead of rescanning every mirror
    _raw_waiting: Dict[str, List[str]] = field(default_factory=dict,
                                               repr=False, compare=False)
    _waiting_index: Dict[str, set] = field(default_factory=dict,
                                           repr=False, compare=False)
    # which node's store currently homes each future mirror — a stale-copy
    # delete from a previous home must not evict the fresh entry
    _future_home: Dict[str, str] = field(default_factory=dict,
                                         repr=False, compare=False)

    def instances_of(self, agent_type: str) -> List[InstanceView]:
        return [self.instances[i] for i in self.by_type.get(agent_type, [])
                if self.instances[i].alive]

    def idle_instances(self, agent_type: str) -> List[InstanceView]:
        return [iv for iv in self.instances_of(agent_type)
                if not iv.busy and iv.qsize == 0]

    # ------------------------------------------------------------- delta API
    # The global controller maintains ONE long-lived ClusterView and patches
    # it with node-store deltas each round (per-round cost scales with churn,
    # not population).  These are the only mutators it uses; a periodic full
    # rebuild is the drift-correction escape hatch.

    def upsert_instance(self, iid: str, m: Dict[str, Any], default_node: str,
                        is_live) -> InstanceView:
        """Patch (or create) the view of instance ``iid`` from its metrics
        mirror ``m``.  ``is_live(session_id)`` prunes the waiting list."""
        raw = list(m.get("waiting_sessions", []))
        for s in self._raw_waiting.get(iid, ()):
            ids = self._waiting_index.get(s)
            if ids is not None:
                ids.discard(iid)
                if not ids:
                    self._waiting_index.pop(s, None)
        self._raw_waiting[iid] = raw
        for s in raw:
            self._waiting_index.setdefault(s, set()).add(iid)
        iv = InstanceView(
            instance_id=iid,
            agent_type=m.get("agent_type", ""),
            node=m.get("node", default_node),
            qsize=int(m.get("qsize", 0)),
            busy=bool(m.get("busy", False)),
            busy_until=float(m.get("busy_until", 0.0)),
            ema_service=float(m.get("ema_service", 0.0)),
            completed=int(m.get("completed", 0)),
            failed=int(m.get("failed", 0)),
            alive=bool(m.get("alive", True)),
            waiting_sessions=[s for s in raw if is_live(s)],
            inflight=int(m.get("inflight", 0)),
            retries=int(m.get("retries", 0)),
            cancelled=int(m.get("cancelled", 0)),
            expired=int(m.get("expired", 0)),
            engine_expired=int(m.get("engine_expired", 0)),
            engine_queue=int(m.get("engine_queue", 0)),
            engine_saturation=float(m.get("engine_saturation", 0.0)),
            engine_rejects=int(m.get("engine_rejects", 0)),
            engine_prefix_hits=int(m.get("engine_shared_prefix_hits", 0)),
            engine_prefix_tokens=int(m.get("engine_shared_prefix_tokens", 0)),
            engine_tier=str(m.get("engine_tier", "")),
            engine_spec_acceptance=float(
                m.get("engine_spec_acceptance", 0.0)),
            engine_decode_tokens_per_step=float(
                m.get("engine_decode_tokens_per_step", 0.0)),
        )
        old = self.instances.get(iid)
        self.instances[iid] = iv
        if old is None:
            self.by_type.setdefault(iv.agent_type, []).append(iid)
        elif old.agent_type != iv.agent_type:   # defensive: never in practice
            peers = self.by_type.get(old.agent_type, [])
            if iid in peers:
                peers.remove(iid)
            self.by_type.setdefault(iv.agent_type, []).append(iid)
        return iv

    def evict_instance(self, iid: str) -> None:
        iv = self.instances.pop(iid, None)
        for s in self._raw_waiting.pop(iid, ()):
            ids = self._waiting_index.get(s)
            if ids is not None:
                ids.discard(iid)
                if not ids:
                    self._waiting_index.pop(s, None)
        if iv is not None:
            peers = self.by_type.get(iv.agent_type, [])
            if iid in peers:
                peers.remove(iid)
            if not peers:
                self.by_type.pop(iv.agent_type, None)

    def upsert_future_mirror(self, fid: str, h: Dict[str, Any],
                             node: str) -> None:
        self.futures[fid] = h
        self._future_home[fid] = node

    def evict_future_mirror(self, fid: str, node: str) -> None:
        """Drop the mirror iff ``node`` is its current home: the delete of a
        stale copy on a previous home (mirror re-homed by migration or an
        escalated reroute) must not shadow the fresh upsert."""
        if self._future_home.get(fid) == node:
            self.futures.pop(fid, None)
            self._future_home.pop(fid, None)

    def refresh_waiting(self, sessions, is_live) -> None:
        """Re-filter the waiting lists of every instance naming one of
        ``sessions`` (their liveness flipped since the last round)."""
        stale = set()
        for sid in sessions:
            stale |= self._waiting_index.get(sid, set())
        for iid in stale:
            iv = self.instances.get(iid)
            if iv is not None:
                iv.waiting_sessions = [
                    s for s in self._raw_waiting.get(iid, []) if is_live(s)]


# ------------------------------------------------------------------ actions
@dataclass
class Action:
    kind: str
    payload: Dict[str, Any]


class ActionSink:
    """Collects primitive calls during one policy step."""

    def __init__(self) -> None:
        self.actions: List[Action] = []

    def route(self, session_id: str, agent_type: str, instance: str) -> None:
        self.actions.append(Action("route", dict(session_id=session_id,
                                                 agent_type=agent_type,
                                                 instance=instance)))

    def route_weighted(self, agent_type: str, instances: List[str],
                       weights: List[float]) -> None:
        self.actions.append(Action("route_weighted", dict(
            agent_type=agent_type, instances=instances, weights=weights)))

    def route_tier(self, agent_type: str,
                   tiers: Dict[str, List[str]]) -> None:
        """Install a model-tier routing table: futures carrying a
        ``model_tier`` work hint are routed within ``tiers[hint]`` (with
        shed-watermark fallback to the other tiers — see Router.route)."""
        self.actions.append(Action("route_tier", dict(
            agent_type=agent_type, tiers=tiers)))

    def set_priority(self, session_id: str, priority_value: float,
                     agent: Optional[str] = None) -> None:
        self.actions.append(Action("set_priority", dict(
            session_id=session_id, value=priority_value, agent=agent)))

    def migrate(self, session_id: str, src: str, dst: str) -> None:
        self.actions.append(Action("migrate", dict(
            session_id=session_id, src=src, dst=dst)))

    def migrate_future(self, fid: str, dst: str) -> None:
        self.actions.append(Action("migrate_future", dict(fid=fid, dst=dst)))

    def kill(self, instance: str, drain_to: Optional[str] = None) -> None:
        self.actions.append(Action("kill", dict(instance=instance,
                                                drain_to=drain_to)))

    def provision(self, agent_type: str, node: str) -> None:
        self.actions.append(Action("provision", dict(agent_type=agent_type,
                                                     node=node)))

    def install_schedule(self, agent_type: str, policy: LocalSchedule) -> None:
        self.actions.append(Action("install_schedule", dict(
            agent_type=agent_type, policy=policy)))

    def retry_future(self, fid: str, instance: str) -> None:
        """Re-dispatch an escalated future on ``instance`` (rung 2 of the
        retry ladder: reroute to a surviving replica)."""
        self.actions.append(Action("retry_future", dict(fid=fid,
                                                        instance=instance)))

    def fail_future(self, fid: str, reason: str = "") -> None:
        """Give up on an escalated future: fail it with its original error."""
        self.actions.append(Action("fail_future", dict(fid=fid,
                                                       reason=reason)))

    def blacklist(self, instance: str) -> None:
        """Remove ``instance`` from every routing decision from now on."""
        self.actions.append(Action("blacklist", dict(instance=instance)))

    def hedge_future(self, fid: str, instance: str) -> None:
        """Dispatch a duplicate of a straggling in-flight future on
        ``instance`` (first completion wins; the loser is cancelled)."""
        self.actions.append(Action("hedge_future", dict(fid=fid,
                                                        instance=instance)))


class Policy:
    """Base class.  ``step`` runs once per global-controller period."""

    name = "base"

    def step(self, view: ClusterView, act: ActionSink) -> None:
        raise NotImplementedError


class PolicyChain(Policy):
    def __init__(self, *policies: Policy) -> None:
        self.policies = list(policies)
        self.name = "+".join(p.name for p in policies)

    def step(self, view: ClusterView, act: ActionSink) -> None:
        for p in self.policies:
            p.step(view, act)


# ---------------------------------------------------------------- library
class LoadBalancePolicy(Policy):
    """Default policy 1 (§6.1): balance load across instances via routing.

    Installs weighted routing inversely proportional to instance ETA.
    """

    name = "load_balance"

    def step(self, view: ClusterView, act: ActionSink) -> None:
        for agent_type, ids in view.by_type.items():
            ivs = view.instances_of(agent_type)
            if len(ivs) < 2:
                continue
            etas = [iv.eta(view.now) for iv in ivs]
            # a replica whose admission queue is saturated is about to
            # hard-reject: spray almost nothing its way until it drains
            weights = [(1.0 / (0.05 + e))
                       * (0.01 if iv.engine_saturation >= 1.0 else 1.0)
                       for iv, e in zip(ivs, etas)]
            s = sum(weights)
            act.route_weighted(agent_type, [iv.instance_id for iv in ivs],
                               [w / s for w in weights])


class TierRoutePolicy(Policy):
    """Just-in-time model-tier routing: publish a tier table built from each
    replica's self-reported ``engine_tier`` so the router can steer cheap
    steps (futures hinted ``model_tier="small"``) to small-tier replicas and
    hard steps to large ones.  The SLO-aware part lives in the router: a
    tier whose every replica sits at or above the shed watermark falls
    through to the remaining tiers, composing with the fresh-traffic shed
    rather than fighting it — a hint is a preference, never a hard pin.
    """

    name = "tier_route"

    def __init__(self) -> None:
        self._last: Dict[str, Dict[str, List[str]]] = {}

    def step(self, view: ClusterView, act: ActionSink) -> None:
        for agent_type in view.by_type:
            tiers: Dict[str, List[str]] = {}
            for iv in view.instances_of(agent_type):
                if iv.engine_tier:
                    tiers.setdefault(iv.engine_tier, []).append(
                        iv.instance_id)
            for ids in tiers.values():
                ids.sort()
            if not tiers:           # untiered pool: nothing to install
                continue
            if self._last.get(agent_type) != tiers:
                act.route_tier(agent_type, tiers)
                self._last[agent_type] = tiers


class HoLMitigationPolicy(Policy):
    """Default policy 2 (§6.1): migrate sessions stuck behind long work.

    If a session waits in a busy instance's queue while a sibling instance is
    idle, migrate the session there.  (Generalizes the Fig. 6 example.)
    """

    name = "hol_mitigation"

    def __init__(self, wait_threshold: float = 0.5) -> None:
        self.wait_threshold = wait_threshold

    def step(self, view: ClusterView, act: ActionSink) -> None:
        for agent_type in view.by_type:
            ivs = view.instances_of(agent_type)
            idle = [iv for iv in ivs if not iv.busy and iv.qsize == 0]
            if not idle:
                continue
            busy = sorted((iv for iv in ivs if iv.qsize > 0),
                          key=lambda iv: -iv.eta(view.now))
            for iv in busy:
                if iv.eta(view.now) < self.wait_threshold or not idle:
                    break
                # prefer the highest-priority waiting session
                sessions = sorted(
                    iv.waiting_sessions,
                    key=lambda s: -view.session_priority.get(s, 0.0))
                if not sessions:
                    continue
                dst = idle.pop(0)
                act.migrate(sessions[0], iv.instance_id, dst.instance_id)


class ResourceReassignmentPolicy(Policy):
    """Default policy 3 (§6.1): move capacity from low-load to high-load types.

    If an agent type's average queue exceeds ``hot`` while another type sits
    idle (< ``cold``) and shares a resource profile, kill one cold instance
    and provision a hot one on the freed node.
    """

    name = "resource_reassignment"

    def __init__(self, hot: float = 4.0, cold: float = 0.25,
                 cooldown: float = 5.0) -> None:
        self.hot = hot
        self.cold = cold
        self.cooldown = cooldown
        self._last_change = -1e9

    def step(self, view: ClusterView, act: ActionSink) -> None:
        if view.now - self._last_change < self.cooldown:
            return
        load: Dict[str, float] = {}
        for agent_type in view.by_type:
            ivs = view.instances_of(agent_type)
            if ivs:
                load[agent_type] = sum(iv.qsize for iv in ivs) / len(ivs)
        if not load:
            return
        hot_type = max(load, key=load.get)
        cold_candidates = [t for t, l in load.items()
                           if t != hot_type and l <= self.cold
                           and len(view.instances_of(t)) > 1]
        if load[hot_type] < self.hot or not cold_candidates:
            return
        cold_type = min(cold_candidates, key=lambda t: load[t])
        victims = sorted(view.instances_of(cold_type),
                         key=lambda iv: iv.eta(view.now))
        victim = victims[0]
        survivors = [iv for iv in view.instances_of(cold_type)
                     if iv.instance_id != victim.instance_id]
        act.kill(victim.instance_id,
                 drain_to=survivors[0].instance_id if survivors else None)
        act.provision(hot_type, victim.node)
        self._last_change = view.now


class SRTFSchedule(LocalSchedule):
    """Shortest-remaining-time-first local queue order (§6.2 Minimize JCT).

    In call-graph workloads, later-stage calls have less remaining work, so
    deeper futures run first; ties broken by expected service time.
    """

    name = "srtf"

    def order_key(self, fut, now: float):
        depth = fut.meta.work_hint.get("graph_depth", 0)
        est = fut.meta.work_hint.get("est_service", 1.0)
        return (-depth, est, fut.meta.created_at)


class SRTFPolicy(Policy):
    """The paper's 12-line JCT policy: install SRTF ordering everywhere."""

    name = "srtf"

    def step(self, view: ClusterView, act: ActionSink) -> None:
        for agent_type in view.by_type:
            act.install_schedule(agent_type, SRTFSchedule())


class LPTSchedule(LocalSchedule):
    """Longest-processing-time-first (§6.2 Control Makespan): re-entrant
    (retried) jobs first, then longest estimated service."""

    name = "lpt"

    def order_key(self, fut, now: float):
        # re-entrance comes from either the driver's own retry loop (the
        # "retry" hint, Fig. 4 style) or the runtime's retry ladder (the
        # attempt counter on re-dispatched futures)
        retries = max(fut.meta.work_hint.get("retry", 0),
                      getattr(fut.meta, "attempt", 0))
        est = fut.meta.work_hint.get("est_service", 1.0)
        return (-retries, -est, fut.meta.created_at)


class LPTPolicy(Policy):
    name = "lpt"

    def step(self, view: ClusterView, act: ActionSink) -> None:
        for agent_type in view.by_type:
            act.install_schedule(agent_type, LPTSchedule())


class KVAffinityPolicy(Policy):
    """Pin every session to the instance holding its K,V cache (§4.3.2
    expressed as a ~10-line §4.2 policy).

    A session whose prefix cache is warm on replica X pays only the new
    suffix on X but a full-context rebuild anywhere else, so the ``route``
    pin is installed for the cache's home replica.  With an
    ``imbalance_eta`` threshold the policy trades affinity for load: when
    the home replica's ETA exceeds the best sibling's by more than the
    threshold, it *migrates* the session there instead — the cache follows
    (transcript replay on engine pools), re-creating affinity at the
    destination instead of fighting it.
    """

    name = "kv_affinity"

    def __init__(self, agent_types: Optional[List[str]] = None,
                 imbalance_eta: Optional[float] = None,
                 max_migrations_per_step: int = 1) -> None:
        self.agent_types = agent_types
        self.imbalance_eta = imbalance_eta
        # migrations are issued against a static view, so each one invisibly
        # shifts the very ETAs the next decision would read; moving one
        # session per round (the next round sees the result) avoids herding
        # every resident session onto the same "best" sibling at once
        self.max_migrations_per_step = max_migrations_per_step

    def step(self, view: ClusterView, act: ActionSink) -> None:
        migrated = 0
        for sid, (iid, _tokens) in view.kv_residency.items():
            home = view.instances.get(iid)
            if home is None or not home.alive:
                continue
            if self.agent_types and home.agent_type not in self.agent_types:
                continue
            if (self.imbalance_eta is not None
                    and migrated < self.max_migrations_per_step
                    # only sessions with pending work are worth a physical
                    # move: waiting_sessions is pruned to live futures at
                    # aggregation, so finished/idle sessions never pay a
                    # transcript replay on the strength of a stale record
                    and sid in home.waiting_sessions):
                siblings = [iv for iv in view.instances_of(home.agent_type)
                            if iv.instance_id != iid]
                if siblings:
                    # prefix-residency tiebreak: among equally loaded
                    # siblings, prefer the replica that has demonstrably
                    # converted resident prefixes into skipped prefill —
                    # its index likely already holds this session's shared
                    # preamble, making the post-migration rebuild cheaper
                    best = min(siblings,
                               key=lambda iv: (iv.eta(view.now),
                                               -iv.engine_prefix_tokens,
                                               iv.instance_id))
                    if (home.eta(view.now) - best.eta(view.now)
                            > self.imbalance_eta):
                        act.migrate(sid, iid, best.instance_id)
                        migrated += 1
                        continue
            act.route(sid, home.agent_type, iid)


class RetryPolicy(Policy):
    """Rung 2 of the retry ladder (§5 fault handling as a §4.2 policy).

    Component controllers retry failures *in place* up to the agent's
    ``max_retries`` budget; what they cannot fix locally — the budget ran
    out, or the instance itself died — they escalate.  Escalations appear in
    ``ClusterView.escalated``; for each one this policy

      1. blacklists the failed executor if it is dead (``ClusterView``
         marks it, and the runtime stops routing there for good),
      2. reroutes the future to the least-loaded *surviving* replica of the
         same agent type (never the one that just failed it), or
      3. fails the future with its original error when no survivor remains
         or the future has been rerouted ``max_reroutes`` times already.

    Installed by default on the global controller (it also runs between
    periodic rounds when a controller nudges an escalation), and swappable
    like any other policy — e.g. a custom subclass could provision a fresh
    replica instead of failing on rung 3.
    """

    name = "retry"

    def __init__(self, max_reroutes: int = 2) -> None:
        self.max_reroutes = max_reroutes

    def step(self, view: ClusterView, act: ActionSink) -> None:
        for rec in view.escalated:
            src = rec.get("executor", "")
            src_view = view.instances.get(src)
            if src_view is not None and not src_view.alive \
                    and src not in view.blacklisted:
                act.blacklist(src)
            if rec.get("escalations", 0) > self.max_reroutes:
                act.fail_future(rec["fid"], reason="reroute budget exhausted")
                continue
            cands = [iv for iv in view.instances_of(rec["agent_type"])
                     if iv.instance_id != src
                     and iv.instance_id not in view.blacklisted]
            if not cands:
                act.fail_future(rec["fid"], reason="no surviving replica")
                continue
            # prefer the session's KV home: replica failure recovery just
            # replayed the transcript there (§4.3.2) — retrying anywhere
            # else pays a cold full-context prefill for nothing
            dst = None
            home = view.kv_residency.get(rec.get("session", ""))
            if home is not None:
                dst = next((iv for iv in cands
                            if iv.instance_id == home[0]), None)
            if dst is None:
                dst = min(cands, key=lambda iv: iv.eta(view.now))
            act.retry_future(rec["fid"], dst.instance_id)


class HedgePolicy(Policy):
    """Hedged dispatch against stragglers (latency faults as a §4.2 policy).

    A replica that is merely *slow* — not dead — stalls every dependent
    future without tripping the retry ladder.  Each round this policy scans
    ``ClusterView.hedge_candidates`` (in-flight leaf futures) and, when one
    has been running ``factor``× longer than the pool's typical service time
    (the *median* of the type's per-replica EMAs, so a straggler's own
    inflated EMA cannot mask it), emits ``hedge_future`` to launch a
    duplicate on the least-loaded below-watermark sibling.  Run-id fencing
    and the terminal-state completion guard make first-completion-wins safe;
    the runtime cancels the loser.

    Two brakes bound the extra work: a global budget (total hedges stay
    under ``budget_frac`` of pool-wide completions, so steady state pays at
    most ~``budget_frac`` extra dispatches) and the shed watermark (no
    sibling below it → no hedge: duplicating work into a saturated pool
    trades one tail for a worse one — composes with the engines' admission shedding
    rather than fighting it).
    """

    name = "hedge"

    def __init__(self, factor: float = 3.0, min_delay: float = 0.05,
                 budget_frac: float = 0.1, shed_watermark: float = 0.75,
                 agent_types: Optional[List[str]] = None,
                 max_per_round: int = 8) -> None:
        self.factor = factor
        self.min_delay = min_delay
        self.budget_frac = budget_frac
        self.shed_watermark = shed_watermark
        self.agent_types = agent_types
        self.max_per_round = max_per_round
        self.issued = 0

    def _typical_service(self, view: ClusterView, agent_type: str) -> float:
        emas = sorted(iv.ema_service
                      for iv in view.instances_of(agent_type)
                      if iv.ema_service > 0)
        if not emas:
            return 0.0
        return emas[len(emas) // 2]

    def step(self, view: ClusterView, act: ActionSink) -> None:
        cands = view.hedge_candidates
        if not cands:
            return
        completed = sum(iv.completed for iv in view.instances.values())
        # budget brake: never more than budget_frac of all completions (a
        # small floor lets hedging start before completions accumulate)
        budget = max(2.0, self.budget_frac * completed)
        this_round = 0
        for c in sorted(cands, key=lambda c: -c["elapsed"]):
            if self.issued >= budget or this_round >= self.max_per_round:
                return
            at = c["agent_type"]
            if self.agent_types and at not in self.agent_types:
                continue
            typical = self._typical_service(view, at)
            delay = max(self.min_delay, self.factor * typical)
            if c["elapsed"] < delay:
                continue
            siblings = [iv for iv in view.instances_of(at)
                        if iv.instance_id != c["instance"]
                        and iv.instance_id not in view.blacklisted
                        and iv.engine_saturation < self.shed_watermark]
            if not siblings:
                continue        # pool saturated: shed the hedge entirely
            dst = min(siblings, key=lambda iv: (iv.eta(view.now),
                                                iv.instance_id))
            act.hedge_future(c["fid"], dst.instance_id)
            self.issued += 1
            this_round += 1


class HighPrioritySessionPolicy(Policy):
    """Fig. 6 verbatim: boost one session and migrate it away from busy
    instances whenever a sibling instance has an empty queue."""

    name = "high_priority_session"

    def __init__(self, session_id: str, agents: Optional[List[str]] = None,
                 priority_value: float = 10.0) -> None:
        self.session_id = session_id
        self.agents = agents
        self.priority_value = priority_value
        self._boosted = False

    def step(self, view: ClusterView, act: ActionSink) -> None:
        if not self._boosted:
            act.set_priority(self.session_id, self.priority_value)
            self._boosted = True
        for agent_type in (self.agents or list(view.by_type)):
            for iv in view.instances_of(agent_type):
                if self.session_id in iv.waiting_sessions and iv.busy:
                    for other in view.instances_of(agent_type):
                        if other.instance_id != iv.instance_id and \
                                other.qsize == 0 and not other.busy:
                            act.migrate(self.session_id, iv.instance_id,
                                        other.instance_id)
                            return


def default_policies() -> PolicyChain:
    """The three §6.1 defaults, < 100 lines cumulatively."""
    return PolicyChain(LoadBalancePolicy(), HoLMitigationPolicy(),
                       ResourceReassignmentPolicy())
