"""Global controller: periodic policy computation (paper §4.1, §4.2).

Single-threaded, push-based loop.  Each period it:
 1. aggregates metrics + future-metadata mirrors from every node store
    (modelled per-node fetch latency — this is what Fig. 10 measures),
 2. runs the operator's policy program over the ClusterView,
 3. writes the resulting decisions (routing tables, priorities, migrations,
    provisioning) back into node stores, where component controllers consume
    them asynchronously.

The global controller is never on the execution fast path; a slow loop only
delays policy refresh, not request progress.

View collection is *incremental*: the controller keeps one long-lived
``ClusterView`` and patches it each round from per-store delta scans
(``NodeStore.scan_changed``), so per-round collect cost scales with churn —
futures created/resolved and mirrors republished since the previous round —
not with the total population.  A periodic full rebuild
(``full_rebuild_interval`` rounds) is the drift-correction escape hatch;
``collect_view(full=True)`` forces one on demand.  This is what takes the
Fig. 10 claim (131K futures, sub-500 ms global loop, policy logic dominating)
from aspiration to measured.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional, Tuple

from .policy import ActionSink, ClusterView, Policy, RetryPolicy

#: key prefixes the cluster view is built from
VIEW_PREFIXES = ("metrics:", "future:")


class GlobalController:
    def __init__(self, runtime, policy: Policy, interval: float = 0.25,
                 node_fetch_latency: float = 0.0,
                 full_rebuild_interval: int = 64) -> None:
        self.runtime = runtime
        self.policy = policy
        self.interval = interval
        # virtual-time cost to poll one node's store (network RTT model);
        # real wall-clock compute cost is measured separately for Fig. 10.
        self.node_fetch_latency = node_fetch_latency
        # always-on rung 2 of the retry ladder: decides the fate of failures
        # component controllers escalated (reroute to a survivor / give up).
        # Swappable like the main policy, but kept separate from it so
        # escalations are never lost to an operator policy chain that
        # doesn't know about them.
        self.retry_policy: Policy = RetryPolicy()
        # every ``full_rebuild_interval`` rounds the persistent view is
        # rebuilt from scratch (drift correction); 0 disables the periodic
        # rebuild (delta-only after the bootstrap round)
        self.full_rebuild_interval = full_rebuild_interval
        self._running = False
        # rounds are logically single-threaded; under the RealTimeKernel an
        # escalation nudge fires on a timer thread and must not interleave
        # with a periodic tick now that the view is persistent shared state
        self._round_lock = threading.RLock()
        # rolling histories (bounded: the loop ticks forever in long-lived
        # deployments; Telemetry.control_rounds keeps the canonical record)
        self.loop_wall_times: "deque[float]" = deque(maxlen=4096)
        self.loop_breakdown: "deque[Dict[str, float]]" = deque(maxlen=4096)
        # incremental-collection state
        self._view: Optional[ClusterView] = None
        self._cursors: Dict[Tuple[str, str], int] = {}  # (node, prefix) -> seq
        self._rounds_since_rebuild = 0
        self.rebuild_rounds = 0      # full rebuilds performed (incl. bootstrap)
        self.delta_rounds = 0        # delta-patched rounds
        self._last_collected = 0     # entries read from stores last round

    # ------------------------------------------------------------- lifecycle
    def start(self) -> None:
        self._running = True
        self._schedule_next(0.0)

    def stop(self) -> None:
        self._running = False

    def _schedule_next(self, delay: float) -> None:
        if self._running:
            self.runtime.kernel.schedule(delay, self._tick, tag="global-tick",
                                         periodic=True)

    def _tick(self) -> None:
        if not self._running:
            return
        self.run_once()
        self._schedule_next(self.interval)

    # ------------------------------------------------------------- one round
    def collect_view(self, full: bool = False) -> ClusterView:
        with self._round_lock:
            due = (full or self._view is None
                   or (self.full_rebuild_interval
                       and self._rounds_since_rebuild
                       >= self.full_rebuild_interval))
            view = self._collect_full() if due else self._collect_delta()
            self._refresh_dynamic(view)
            return view

    def _apply_entries(self, view: ClusterView, prefix: str, node_id: str,
                       changed: Dict[str, dict], deleted, is_live) -> int:
        """Upsert/evict one prefix's entries into the view.  Shared by the
        full-rebuild and delta paths so the two can never drift on how a
        mirror is interpreted."""
        plen = len(prefix)
        n = 0
        if prefix == "metrics:":
            for key, m in changed.items():
                if not m:
                    continue
                view.upsert_instance(key[plen:], m, node_id, is_live)
                n += 1
            for key in deleted:
                view.evict_instance(key[plen:])
        else:   # "future:"
            for key, h in changed.items():
                view.upsert_future_mirror(key[plen:], h, node_id)
                n += 1
            for key in deleted:
                view.evict_future_mirror(key[plen:], node_id)
        return n

    def _collect_full(self) -> ClusterView:
        """Rebuild the view from scratch (bootstrap round / escape hatch)."""
        rt = self.runtime
        view = ClusterView(now=rt.kernel.now())
        # drain BEFORE snapshotting liveness: a session flipping after the
        # drain re-marks itself for the next delta round, whereas the
        # reverse order could swallow a flip the snapshot never saw
        rt.futures.drain_dirty_sessions()    # rebuilt from scratch: reset
        live = rt.futures.live_sessions()
        is_live = live.__contains__
        n = 0
        for store in rt.stores.all_stores():
            for prefix in VIEW_PREFIXES:
                # scanning resets the journal (drain semantics) and advances
                # the cursor; writes racing the key scan below re-report
                # next round (upserts are idempotent)
                _, _, cur = store.scan_changed(
                    prefix, self._cursors.get((store.node_id, prefix), 0))
                self._cursors[(store.node_id, prefix)] = cur
                keys = store.keys(prefix)
                n += self._apply_entries(view, prefix, store.node_id,
                                         store.hgetall_many(keys), (),
                                         is_live)
        self._view = view
        self._rounds_since_rebuild = 0
        self.rebuild_rounds += 1
        self._last_collected = n
        return view

    def _collect_delta(self) -> ClusterView:
        """Patch the persistent view with what moved since the last round."""
        rt = self.runtime
        view = self._view
        view.now = rt.kernel.now()
        table = rt.futures
        is_live = lambda sid: table.live_count(sid) > 0  # noqa: E731
        n = 0
        for store in rt.stores.all_stores():
            nid = store.node_id
            for prefix in VIEW_PREFIXES:
                changed, deleted, cur = store.scan_changed(
                    prefix, self._cursors.get((nid, prefix), 0))
                self._cursors[(nid, prefix)] = cur
                hashes = store.hgetall_many(changed) if changed else {}
                n += self._apply_entries(view, prefix, nid, hashes, deleted,
                                         is_live)
        # sessions whose liveness flipped re-filter exactly the waiting
        # lists that name them (stale-session pruning without a full pass)
        dirty = table.drain_dirty_sessions()
        if dirty:
            view.refresh_waiting(dirty, is_live)
        self._rounds_since_rebuild += 1
        self.delta_rounds += 1
        self._last_collected = n
        return view

    def _refresh_dynamic(self, view: ClusterView) -> None:
        """Non-mirrored view fields, recomputed every round.  All are small
        (O(sessions) / O(escalations)), never O(total futures)."""
        rt = self.runtime
        view.session_priority = {s.session_id: s.priority
                                 for s in rt.sessions.all()}
        view.node_resources = rt.free_resources()
        view.kv_residency = rt.kv_registry.residency_map()
        view.blacklisted = set(rt.blacklist)
        view.escalated = [
            dict(fid=rec.fut.fid,
                 agent_type=rec.fut.meta.agent_type,
                 session=rec.fut.meta.session_id,
                 executor=rec.src_instance,
                 attempt=rec.fut.meta.attempt,
                 escalations=rec.fut.meta.escalations,
                 reason=rec.reason,
                 error=repr(rec.error))
            for rec in rt.pending_escalations()]
        view.hedge_candidates = rt.hedge_candidates()

    def handle_escalations(self) -> None:
        """Off-cycle retry round, nudged by ``runtime.escalate``.

        Escalated failures must not wait for the next periodic tick (under
        the SimKernel there might never be one — periodic events don't keep
        the simulation alive), so controllers schedule this directly.  Only
        the retry policy runs; the operator's policy chain stays periodic.
        """
        if not self.runtime.pending_escalations():
            return
        with self._round_lock:
            view = self.collect_view()
            sink = ActionSink()
            self.retry_policy.step(view, sink)
            self.apply(sink)

    def run_once(self) -> Dict[str, float]:
        """One policy round.  Returns wall-clock breakdown (collect/policy/push)."""
        with self._round_lock:
            return self._run_once_locked()

    def _run_once_locked(self) -> Dict[str, float]:
        t0 = time.perf_counter()
        rebuilds_before = self.rebuild_rounds
        view = self.collect_view()
        t1 = time.perf_counter()
        sink = ActionSink()
        self.policy.step(view, sink)
        if view.escalated:
            self.retry_policy.step(view, sink)
        t2 = time.perf_counter()
        self.apply(sink)
        t3 = time.perf_counter()
        # model the per-node fetch RTT in virtual time
        if self.node_fetch_latency:
            pass  # accounted by the benchmark harness, not the fast path
        breakdown = {
            "collect": t1 - t0,
            "policy": t2 - t1,
            "push": t3 - t2,
            "total": t3 - t0,
            "n_instances": float(len(view.instances)),
            "n_futures": float(len(view.futures)),
            # entries actually fetched from stores this round (== churn on
            # delta rounds, == population on rebuild rounds)
            "n_collected": float(self._last_collected),
            "rebuild": float(self.rebuild_rounds > rebuilds_before),
        }
        self.loop_wall_times.append(breakdown["total"])
        self.loop_breakdown.append(breakdown)
        self.runtime.telemetry.on_control_round(
            view.now, breakdown["collect"], breakdown["policy"],
            breakdown["push"], int(self._last_collected),
            self.rebuild_rounds > rebuilds_before)
        return breakdown

    # ----------------------------------------------------------- enforcement
    def apply(self, sink: ActionSink) -> None:
        """Enact one round's actions.

        Store-mediated commands (migrations, schedule installs) are
        coalesced into one ``hset_many`` per destination command key —
        component controllers consume a batch per run of commands instead
        of a write per action.  Policy action *order* is preserved: a direct
        runtime action (kill, provision, retry, ...) first flushes every
        pending command write, so e.g. a migrate emitted before a kill
        still lands before the kill executes.
        """
        rt = self.runtime
        # (node, key) -> {field: payload}
        writes: Dict[Tuple[str, str], Dict[str, dict]] = {}

        def emit(node: str, key: str, fld: str, payload: dict) -> None:
            writes.setdefault((node, key), {})[fld] = payload

        def flush() -> None:
            for (node, key), mapping in writes.items():
                rt.stores.get(node).hset_many(key, mapping)
            writes.clear()

        _STORE_MEDIATED = ("migrate", "migrate_future", "install_schedule")
        for a in sink.actions:
            p = a.payload
            if writes and a.kind not in _STORE_MEDIATED:
                flush()     # ordering barrier before any direct action
            if a.kind == "route":
                rt.router.pin(p["session_id"], p["agent_type"], p["instance"])
            elif a.kind == "route_weighted":
                rt.router.set_weights(p["agent_type"], p["instances"],
                                      p["weights"])
            elif a.kind == "route_tier":
                rt.router.set_tiers(p["agent_type"], p["tiers"])
            elif a.kind == "set_priority":
                rt.sessions.set_priority(p["session_id"], p["value"],
                                         p.get("agent"))
                rt.reprioritize_session(p["session_id"])
            elif a.kind == "migrate":
                ctrl = rt.controller_of(p["src"])
                if ctrl is not None:
                    emit(ctrl.inst.node_id, f"cmd:{p['src']}",
                         f"mig:{p['session_id']}",
                         dict(kind="migrate_session",
                              session_id=p["session_id"], dst=p["dst"]))
            elif a.kind == "migrate_future":
                fut = rt.futures.get(p["fid"])
                if fut is None:
                    continue
                ctrl = rt.controller_of(fut.meta.executor)
                if ctrl is not None:
                    emit(ctrl.inst.node_id, f"cmd:{fut.meta.executor}",
                         f"migf:{p['fid']}",
                         dict(kind="migrate_future", fid=p["fid"],
                              dst=p["dst"]))
            elif a.kind == "kill":
                rt.kill_instance(p["instance"], drain_to=p.get("drain_to"))
            elif a.kind == "provision":
                rt.provision_instance(p["agent_type"], p["node"])
            elif a.kind == "retry_future":
                rt.apply_retry(p["fid"], p["instance"])
            elif a.kind == "hedge_future":
                rt.apply_hedge(p["fid"], p["instance"])
            elif a.kind == "fail_future":
                rt.fail_escalated(p["fid"], p.get("reason", ""))
            elif a.kind == "blacklist":
                rt.blacklist_instance(p["instance"])
            elif a.kind == "install_schedule":
                for iid in list(rt.instances_of_type(p["agent_type"])):
                    ctrl = rt.controller_of(iid)
                    if ctrl is not None:
                        emit(ctrl.inst.node_id, f"cmd:{iid}", "sched",
                             dict(kind="set_schedule", policy=p["policy"]))
        flush()
