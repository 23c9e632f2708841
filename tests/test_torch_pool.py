"""The port's multi-replica engine pool against the JAX package's.

The scenarios of the reference's ``tests/test_engine_pool.py`` on both
packages: three (or two) replicas of the float32 smoke engine behind one
agent type, the same weights on both sides.  Each scenario returns the
greedy tokens, the placements and the pool's counters; the port's must
equal the reference's.  Covered: round-robin placement then KV affinity,
migration by transcript replay and by page shipping (which must equal
replay: the same destination cache within 2e-4, the reference's bound,
and the same next tokens), a migration deferred while a call is in
flight, a dead or unknown destination, a destination dying during the
deferral, a hard-killed replica whose sessions are recovered and whose
in-flight call is retried, a cancelled queued call, ``warm_session`` and
its shared-prefix fast path.  Last, the straggler case of the reference's
hedging tests (``serving.chaos.slow_instance``): a hedged duplicate wins
on a healthy sibling and the straggler's late completion changes nothing.
"""

import time

import numpy as np
import pytest

pytest.importorskip("jax")

from _torch_nalar import build_stacks, same  # noqa: E402


@pytest.fixture(scope="module")
def stacks():
    return build_stacks()


def _session(rt):
    return next(iter(rt.sessions._sessions))


def test_round_robin_spreads_then_affinity_sticks(stacks):
    def scenario(s):
        rt, pool = s.pool_runtime()
        rt.router.mode = "round_robin"
        out = []
        try:
            for i in range(3):
                r1 = s.run_turn(rt, None, f"session {i} opening line")
                sid = list(rt.sessions._sessions)[-1]
                r2 = s.run_turn(rt, sid, "short follow up")
                out.append((r1.engine_id, r2.engine_id, list(r1.tokens),
                            list(r2.tokens), r2.prefix_reused_tokens))
            return out, sorted(pool.instance_ids)
        finally:
            rt.shutdown()

    turns, iids = same(stacks, scenario)
    assert all(a == b and reused > 0 for a, b, _, _, reused in turns)
    assert sorted(t[0] for t in turns) == iids


def test_migrate_replays_transcript_and_next_turn_is_warm(stacks):
    def scenario(s):
        rt, pool = s.pool_runtime()
        try:
            s.run_turn(rt, None, "the quick brown fox jumps over")
            sid = _session(rt)
            r2 = s.run_turn(rt, sid, "and keeps running")
            src = r2.engine_id
            dst = next(i for i in pool.instance_ids if i != src)
            dst_engine = pool.bridge_of(dst).engine
            pt0 = dst_engine.metrics.prefill_tokens
            moved = pool.migrate_session(sid, src, dst)
            replay = dst_engine.metrics.prefill_tokens - pt0
            home = rt.kv_registry.lookup(sid).instance_id == dst
            freed = pool.bridge_of(src).engine.pool.session(sid) is None
            pt1 = dst_engine.metrics.prefill_tokens
            r3 = s.run_turn(rt, sid, "post migration turn")
            again = pool.migrate_session(sid, src, dst)
            return dict(moved=moved, replay=replay, home=home, freed=freed,
                        r3=(r3.engine_id == dst, list(r3.tokens),
                            r3.prefix_reused_tokens),
                        no_rebuild=dst_engine.metrics.prefill_tokens == pt1,
                        again=again, stats=dict(pool.stats))
        finally:
            rt.shutdown()

    got = same(stacks, scenario)
    assert got["moved"] >= 1 and got["replay"] > 0
    assert got["home"] and got["freed"] and got["no_rebuild"]
    assert got["r3"][0] and got["r3"][2] > 0 and got["again"] == 0
    assert got["stats"]["migrations"] == 1
    assert got["stats"]["migrations_noop"] >= 1


def _hold_in_flight(bridge, sid):
    with bridge._cv:
        bridge._session_active.add(sid)


def test_migrate_with_inflight_future_defers_until_resolution(stacks):
    def scenario(s):
        rt, pool = s.pool_runtime()
        try:
            s.run_turn(rt, None, "warm up this session first")
            sid = _session(rt)
            src = rt.kv_registry.lookup(sid).instance_id
            dst = next(i for i in pool.instance_ids if i != src)
            src_bridge = pool.bridge_of(src)
            dst_engine = pool.bridge_of(dst).engine
            _hold_in_flight(src_bridge, sid)
            pt0 = dst_engine.metrics.prefill_tokens
            scheduled = pool.migrate_session(sid, src, dst)
            before = (rt.kv_registry.lookup(sid).instance_id == src,
                      dst_engine.metrics.prefill_tokens == pt0,
                      dict(pool.stats))
            src_bridge._advance_session(sid)
            after = (rt.kv_registry.lookup(sid).instance_id == dst,
                     dst_engine.metrics.prefill_tokens - pt0)
            r = s.run_turn(rt, sid, "after deferred migration")
            return (scheduled, before, after, r.engine_id == dst,
                    list(r.tokens), r.prefix_reused_tokens)
        finally:
            rt.shutdown()

    scheduled, before, after, on_dst, _, reused = same(stacks, scenario)
    assert scheduled == 1 and before[0] and before[1]
    assert before[2]["migrations_deferred"] == 1
    assert after[0] and after[1] > 0 and on_dst and reused > 0


def test_migrate_to_dead_replica_falls_back_to_live_one(stacks):
    def scenario(s):
        rt, pool = s.pool_runtime()
        try:
            s.run_turn(rt, None, "place this session somewhere")
            sid = _session(rt)
            src = rt.kv_registry.lookup(sid).instance_id
            dead, alive = [i for i in pool.instance_ids if i != src]
            rt.kill_instance(dead)
            moved = pool.migrate_session(sid, src, dead)
            fallbacks = pool.stats["migrations_fallback"]
            home = rt.kv_registry.lookup(sid).instance_id
            r = s.run_turn(rt, sid, "retry lands on the fallback")
            moved2 = pool.migrate_session(sid, alive, "llm:n0/does-not-exist")
            return (moved, fallbacks, home == alive,
                    r.engine_id == alive, list(r.tokens),
                    r.prefix_reused_tokens, moved2,
                    rt.kv_registry.lookup(sid).instance_id != alive)
        finally:
            rt.shutdown()

    got = same(stacks, scenario)
    assert got[0] >= 1 and got[1] == 1 and got[2] and got[3]
    assert got[5] > 0 and got[6] >= 1 and got[7]


def test_deferred_migration_revalidates_dead_destination(stacks):
    def scenario(s):
        rt, pool = s.pool_runtime()
        try:
            s.run_turn(rt, None, "seed the session transcript")
            sid = _session(rt)
            src = rt.kv_registry.lookup(sid).instance_id
            dst, fallback = [i for i in pool.instance_ids if i != src]
            src_bridge = pool.bridge_of(src)
            _hold_in_flight(src_bridge, sid)
            deferred = pool.migrate_session(sid, src, dst)
            rt.kill_instance(dst)
            src_bridge._advance_session(sid)
            home = rt.kv_registry.lookup(sid).instance_id
            r = s.run_turn(rt, sid, "post migration turn")
            return (deferred, home == fallback, r.engine_id == fallback,
                    list(r.tokens), r.prefix_reused_tokens)
        finally:
            rt.shutdown()

    deferred, home_ok, on_fallback, _, reused = same(stacks, scenario)
    assert deferred == 1 and home_ok and on_fallback and reused > 0


def _park_follow_up(s, rt, bridge, sid, text, done):
    """Hold ``sid`` in flight on ``bridge`` and submit a follow-up call,
    which parks in the bridge's session queue; waits until it is there."""
    _hold_in_flight(bridge, sid)
    rt.start()
    rt.submit_request(
        lambda: rt.stub("llm").generate(text).value(timeout=240),
        session=sid, on_done=lambda o, e: done.update(out=o, err=e))
    deadline = time.time() + 120
    while time.time() < deadline:
        with bridge._cv:
            if bridge._session_q.get(sid):
                return
        time.sleep(0.02)
    raise AssertionError("the follow-up never parked")


def test_hard_kill_recovers_sessions_and_retries_inflight(stacks):
    def scenario(s):
        rt, pool = s.pool_runtime(replicas=2)
        try:
            rt.apply_directives("llm", {"max_retries": 1})
            s.run_turn(rt, None, "hello from a doomed replica")
            sid = _session(rt)
            victim = rt.kv_registry.lookup(sid).instance_id
            survivor = next(i for i in pool.instance_ids if i != victim)
            survivor_engine = pool.bridge_of(survivor).engine
            done = {}
            _park_follow_up(s, rt, pool.bridge_of(victim), sid,
                            "the follow up", done)
            pt0 = survivor_engine.metrics.prefill_tokens
            rt.kill_instance(victim, hard=True)
            rt.run()
            r3 = s.run_turn(rt, sid, "and one more turn")
            st = pool.stats
            # the retried call's tokens are not compared: whether it reaches
            # the survivor before or after the session's recovery replay is
            # a race on both packages (cold full context or warm resume)
            return (done["err"], done["out"].engine_id == survivor,
                    len(done["out"].tokens),
                    rt.kv_registry.lookup(sid).instance_id == survivor,
                    survivor_engine.metrics.prefill_tokens > pt0,
                    st["replica_failures"], st["failed_inflight"] >= 1,
                    st["sessions_recovered"] >= 1, victim in rt.blacklist,
                    rt.instance(victim).alive, r3.engine_id == survivor,
                    len(r3.tokens))
        finally:
            rt.shutdown()

    got = same(stacks, scenario)
    assert got[0] is None and got[1] and got[2] == 3 and got[3] and got[4]
    assert got[5:10] == (1, True, True, True, False) and got[10]


def test_cancelled_session_queued_call_never_hits_engine(stacks):
    def scenario(s):
        rt, pool = s.pool_runtime(replicas=2)
        try:
            s.run_turn(rt, None, "open the session")
            sid = _session(rt)
            bridge = pool.bridge_of(rt.kv_registry.lookup(sid).instance_id)
            done = {}
            _park_follow_up(s, rt, bridge, sid, "never runs", done)
            fut = bridge._session_q[sid][0][0]
            cancelled = rt.cancel_future(fut, "user abandoned")
            pt0 = bridge.engine.metrics.prefill_tokens
            bridge._advance_session(sid)
            rt.run()
            with bridge._cv:
                idle = sid not in bridge._session_active
            return (cancelled, type(done["err"]).__name__,
                    bridge.engine.metrics.prefill_tokens == pt0, idle)
        finally:
            rt.shutdown()

    assert same(stacks, scenario) == (True, "FutureCancelled", True, True)


def test_engine_warm_session_populates_cache(stacks):
    def scenario(s):
        engine = s.engine(max_batch=2, max_seq=64)
        toks = list(range(1, 20))
        cached = engine.warm_session("s-warm", toks)
        pt = engine.metrics.prefill_tokens
        req = engine.generate([7, 8, 9], session_id="s-warm",
                              sampling=s.serving.SamplingParams(
                                  max_new_tokens=2))
        return (cached, req.prefix_reused_tokens,
                engine.metrics.prefill_tokens == pt, list(req.generated),
                engine.warm_session("s-warm", []))

    cached, reused, no_prefill, _, empty = same(stacks, scenario)
    assert cached >= 19 and reused == cached and no_prefill and empty == 0


def test_migrate_ships_pages_and_matches_replay(stacks):
    """Page shipping is a pure optimisation: the destination's cache equals
    the replay path's within 2e-4 and the next turn decodes the same
    tokens, at a fraction of the prefill cost; on both packages."""
    def one_run(s, page_migration):
        rt, pool = s.pool_runtime()
        pool.page_migration = page_migration
        try:
            r1 = s.run_turn(rt, None, "the quick brown fox jumps over")
            sid = _session(rt)
            src = r1.engine_id
            dst = next(i for i in pool.instance_ids if i != src)
            dst_engine = pool.bridge_of(dst).engine
            pt0 = dst_engine.metrics.prefill_tokens
            assert pool.migrate_session(sid, src, dst) >= 1
            prefilled = dst_engine.metrics.prefill_tokens - pt0
            k, v, tokens = dst_engine.pool.gather_contiguous(sid, 64)
            dst_engine.pool.check_invariants()
            r2 = s.run_turn(rt, sid, "and keeps running")
            kv = (np.array(k[:, :tokens], np.float32),
                  np.array(v[:, :tokens], np.float32))
            return kv, (tokens, list(r2.tokens), prefilled,
                        dict(pool.stats),
                        [(m["mode"], m["pages_shipped"])
                         for m in pool.migrations])
        finally:
            rt.shutdown()

    def scenario(s):
        kv_r, replay = one_run(s, False)
        kv_p, pages = one_run(s, True)
        for a, b in zip(kv_p, kv_r):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)
        return replay, pages

    replay, pages = same(stacks, scenario)
    assert replay[3]["migrations_page_shipped"] == 0
    assert replay[4][0][0] == "replay"
    assert pages[3]["migrations_page_shipped"] == 1
    assert pages[3]["pages_shipped"] >= 1 and pages[4][0][0] == "pages"
    assert 0 < pages[2] < replay[2]
    assert pages[0] == replay[0] and pages[1] == replay[1]


def test_migrate_page_ship_deferred_while_inflight(stacks):
    def scenario(s):
        rt, pool = s.pool_runtime()
        try:
            s.run_turn(rt, None, "warm up this session first")
            sid = _session(rt)
            src = rt.kv_registry.lookup(sid).instance_id
            dst = next(i for i in pool.instance_ids if i != src)
            src_bridge = pool.bridge_of(src)
            dst_engine = pool.bridge_of(dst).engine
            _hold_in_flight(src_bridge, sid)
            pt0 = dst_engine.metrics.prefill_tokens
            deferred = pool.migrate_session(sid, src, dst)
            shipped_before = pool.stats["migrations_page_shipped"]
            src_bridge._advance_session(sid)
            transcript = pool.bridge_of(dst).transcript.tokens(sid)
            rebuilt = dst_engine.metrics.prefill_tokens - pt0
            dst_engine.pool.check_invariants()
            r = s.run_turn(rt, sid, "after deferred migration")
            return (deferred, shipped_before,
                    rt.kv_registry.lookup(sid).instance_id == dst,
                    dict(pool.stats), rebuilt, len(transcript),
                    r.engine_id == dst, list(r.tokens),
                    r.prefix_reused_tokens)
        finally:
            rt.shutdown()

    got = same(stacks, scenario)
    assert got[0] == 1 and got[1] == 0 and got[2]
    assert got[3]["migrations_page_shipped"] == 1
    assert got[3]["pages_shipped"] >= 1 and 0 < got[4] < got[5]
    assert got[6] and got[8] > 0


def test_warm_session_shared_prefix_skips_redundant_prefill(stacks):
    def scenario(s):
        engine = s.engine(max_batch=2, max_seq=64)
        toks = list(range(1, 39))
        warmed = engine.warm_session("first", toks)
        m = engine.metrics
        before = (m.prefills, m.prefill_tokens, m.decode_steps)
        warmed2 = engine.warm_session("second", toks)
        after = (m.prefills, m.prefill_tokens, m.decode_steps)
        engine.pool.check_invariants()
        again = engine.warm_session("first", toks)
        return (warmed, warmed2, before == after, again,
                m.prefill_tokens == before[1], dict(engine.pool.stats))

    got = same(stacks, scenario)
    assert got[:5] == (38, 38, True, 38, True)


def test_straggler_hedge_first_completion_wins(stacks):
    """The reference's hedging case over ``serving.chaos.slow_instance``:
    three emulated replicas in virtual time, one slowed 50x; a call
    trapped on the straggler is hedged onto a healthy sibling, which wins,
    and the straggler's completion ten virtual seconds later neither
    re-materializes the future nor re-arms it (run-id fencing)."""
    def scenario(s):
        core = s.core
        chain = core.default_policies()
        chain.policies.append(core.HedgePolicy(
            factor=2.0, min_delay=0.5, budget_frac=1.0, agent_types=("e",)))
        rt = core.NalarRuntime(simulate=True,
                               nodes={"n0": {"CPU": 16}, "n1": {"CPU": 16}},
                               policy=chain, control_interval=0.25)
        runs = {"n": 0}

        def work(x):
            runs["n"] += 1
            return x * 2

        rt.register_agent(core.AgentSpec(
            name="e", methods={"run": core.emulated(core.FixedLatency(0.2),
                                                    work)},
            directives=core.Directives(max_instances=3,
                                       resources={"CPU": 1})), instances=3)
        victim = rt.instances_of_type("e")[0]
        slowed = s.chaos.slow_instance(rt, victim, factor=50.0)
        healthy = [i for i in rt.instances_of_type("e") if i != victim]

        def driver():
            r = s.current_runtime()
            sid = core.get_context()[0]
            for iid in healthy:
                r.router.pin(sid, "e", iid)
                r.stub("e").run(0).value()
            r.router.pin(sid, "e", victim)
            f = r.stub("e").run(21)
            r.router.unpin(sid, "e")
            t0 = r.kernel.now()
            v = f.value()
            t_won = r.kernel.now() - t0
            winner, run_id = f.meta.executor, f._run_id
            r.kernel.sleep(15.0)
            return (v, f.value() == v, f.meta.executor == winner,
                    f._run_id == run_id, winner != victim, t_won < 2.0)

        try:
            out = core.deployment.main(driver, runtime=rt)
            return (slowed, out, runs["n"], rt.hedges_issued,
                    rt.telemetry.deadline_outcomes()["requests"],
                    s.chaos.restore_instance(rt, victim))
        finally:
            rt.shutdown()

    slowed, out, runs, hedges, requests, restored = same(stacks, scenario)
    assert slowed == 1 and restored == 1 and hedges == 1 and requests == 1
    assert out == (42, True, True, True, True, True)
    # two warm-ups and the winning duplicate: the straggler's late
    # completion found the future resolved and never ran the function
    assert runs == 3
