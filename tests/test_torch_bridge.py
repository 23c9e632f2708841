"""The port's runtime <-> engine bridge against the JAX package's.

The scenarios of the reference's ``tests/test_engine_bridge.py`` run on
both packages' Nalar runtimes (``repro.core`` and the port's copy
``repro_torch.core``), each with its own ``EngineBridge`` over its own
``InferenceEngine``, the same float32 smoke weights on both.  Every
scenario returns the greedy tokens and the counters it asserts on; the
port's must equal the reference's.  Covered: a future resolved with the
engine's output, prefix reuse and transcript within one session, six
sessions batched on one engine, the raw ``submit_async`` / poll surface,
ordering of concurrent same-session calls, an encode failure confined to
its future, the queue-full failure and its retry ladder rerouting to a
sibling, the router's shed watermark, engine gauges in the global view,
and the real-time-kernel requirement.
"""

import pytest

pytest.importorskip("jax")

from _torch_nalar import build_stacks, same  # noqa: E402


@pytest.fixture(scope="module")
def stacks():
    return build_stacks()


def _engine_runtime(s, max_new_tokens=4, **kw):
    rt = s.core.NalarRuntime(simulate=False)
    engine = s.engine(max_batch=4, max_seq=128, **kw)
    s.serving.register_engine_agent(
        rt, "llm", engine,
        sampling=s.serving.SamplingParams(max_new_tokens=max_new_tokens))
    return rt, engine


def test_future_resolves_with_engine_output(stacks):
    def scenario(s):
        rt, engine = _engine_runtime(s)

        def driver():
            fut = s.current_runtime().stub("llm").generate(
                "hello engine world")
            assert not fut.available
            return fut.value(timeout=300)

        out = s.core.deployment.main(driver, runtime=rt)
        try:
            assert isinstance(out, s.serving.GenerationResult)
            assert all(0 <= t < s.cfg.vocab_size for t in out.tokens)
            assert out.engine_id == rt.instances_of_type("llm")[0]
            return (list(out.tokens), out.prompt_tokens,
                    engine.metrics.completed, engine.telemetry()["tier"])
        finally:
            rt.shutdown()

    toks, _, completed, _ = same(stacks, scenario)
    assert len(toks) == 4 and completed == 1


def test_same_session_calls_reuse_prefix_kv(stacks):
    def scenario(s):
        rt, engine = _engine_runtime(s)

        def driver():
            llm = s.current_runtime().stub("llm")
            r1 = llm.generate("the quick brown fox jumps over").value(
                timeout=300)
            t_first = engine.metrics.prefill_tokens
            r2 = llm.generate("and keeps running").value(timeout=300)
            return r1, r2, t_first

        r1, r2, t_first = s.core.deployment.main(driver, runtime=rt)
        try:
            bridge = rt.engine_backends["llm"]
            sid = next(iter(rt.sessions._sessions))
            return dict(tokens=[list(r1.tokens), list(r2.tokens)],
                        reused=[r1.prefix_reused_tokens,
                                r2.prefix_reused_tokens],
                        prompt=[r1.prompt_tokens, r2.prompt_tokens],
                        prefill_first=t_first,
                        prefill=engine.metrics.prefill_tokens,
                        prefix_hits=engine.metrics.prefix_hits,
                        kv=dict(rt.kv_registry.stats),
                        transcript=bridge.transcript.tokens(sid))
        finally:
            rt.shutdown()

    got = same(stacks, scenario)
    assert got["reused"][0] == 0 and got["reused"][1] > 0
    assert got["prefix_hits"] == 1 and got["prefill"] == got["prefill_first"]
    assert got["prompt"][1] == 3 and got["kv"]["reuse_hits"] >= 1
    assert len(got["transcript"]) == sum(got["prompt"]) + 8


def test_concurrent_futures_share_engine_batch(stacks):
    def scenario(s):
        rt, engine = _engine_runtime(s, max_new_tokens=3)
        results = []

        def driver(i):
            out = s.current_runtime().stub("llm").generate(
                f"query number {i}").value(timeout=300)
            return i, list(out.tokens)

        rt.start()
        for i in range(6):
            rt.submit_request(driver, i, on_done=lambda out, err:
                              results.append((out, err)))
        rt.run()
        try:
            assert all(err is None for _, err in results)
            return sorted(out for out, _ in results), engine.metrics.completed
        finally:
            rt.shutdown()

    outs, completed = same(stacks, scenario)
    assert len(outs) == 6 and completed == 6


def test_engine_submit_async_and_poll(stacks):
    def scenario(s):
        engine = s.engine(max_batch=2, max_seq=64)
        done = []
        req = s.serving.Request.make(
            list(range(5)), sampling=s.serving.SamplingParams(
                max_new_tokens=3))
        engine.submit_async(req, on_done=done.append)
        engine.run_until_idle()
        polled = engine.poll_finished()
        return (req.finished, polled == [req], done, engine.poll_finished(),
                engine.drain_completions(), list(req.generated))

    finished, polled, done, again, drained, toks = same(stacks, scenario)
    assert finished and polled and done == [] and again == []
    assert drained == 0 and len(toks) == 3


def test_concurrent_same_session_calls_stay_ordered(stacks):
    def scenario(s):
        rt, engine = _engine_runtime(s)

        def fanout():
            llm = s.current_runtime().stub("llm")
            futs = [llm.generate(f"concurrent turn {i}") for i in range(3)]
            return [f.value(timeout=300) for f in futs]

        outs = s.core.deployment.main(fanout, runtime=rt)
        try:
            bridge = rt.engine_backends["llm"]
            sid = next(iter(rt.sessions._sessions))
            # the order in which the bridge serializes the three calls is
            # the controller threads' race on both packages: compare what
            # does not depend on it
            return (sorted(o.prefix_reused_tokens for o in outs),
                    [o.prompt_tokens for o in outs],
                    sum(len(o.tokens) for o in outs),
                    len(bridge.transcript.tokens(sid)))
        finally:
            rt.shutdown()

    reused, prompts, generated, transcript = same(stacks, scenario)
    assert sum(r > 0 for r in reused) == 2 and prompts == [3, 3, 3]
    assert transcript == sum(prompts) + generated


def test_encode_failure_fails_only_that_future(stacks):
    def scenario(s):
        rt = s.core.NalarRuntime(simulate=False)
        engine = s.engine(max_batch=4, max_seq=128)

        def encode(q):
            if "poison" in str(q):
                raise ValueError("unencodable input")
            return s.serving.hash_tokenize(q, s.cfg.vocab_size)

        s.serving.register_engine_agent(
            rt, "llm", engine, encode=encode,
            sampling=s.serving.SamplingParams(max_new_tokens=3))

        def fanout():
            llm = s.current_runtime().stub("llm")
            futs = [llm.generate("fine one"), llm.generate("poison pill"),
                    llm.generate("fine two")]
            out, errs = [], []
            for f in futs:
                try:
                    out.append(len(f.value(timeout=300).tokens))
                except ValueError as e:
                    errs.append(str(e))
            return out, errs

        # the three calls share the driver's session, and the order in
        # which the bridge serializes them (so each one's history and
        # tokens) is the controller threads' race on both packages
        try:
            return s.core.deployment.main(fanout, runtime=rt)
        finally:
            rt.shutdown()

    out, errs = same(stacks, scenario)
    assert out == [3, 3] and errs == ["unencodable input"]


def test_queue_full_fails_future_as_retryable_error(stacks):
    def scenario(s):
        rt = s.core.NalarRuntime(simulate=False)
        engine = s.engine(max_batch=1, max_seq=64, max_queue=1)
        s.serving.register_engine_agent(
            rt, "llm", engine,
            sampling=s.serving.SamplingParams(max_new_tokens=2))
        iid = rt.instances_of_type("llm")[0]
        rt.router.shed_watermark = None
        engine.queue.push(s.serving.Request.make([1, 2, 3]))

        def driver():
            return s.current_runtime().stub("llm").generate(
                "over capacity").value(timeout=60)

        try:
            with pytest.raises(s.serving.EngineOverloaded):
                s.core.deployment.main(driver, runtime=rt)
            return (engine.queue.rejected >= 1,
                    rt.controller_of(iid).inst.metrics.failed,
                    engine.overloaded())
        finally:
            rt.shutdown()

    assert same(stacks, scenario) == (True, 1, True)


def _two_replicas(s):
    rt = s.core.NalarRuntime(simulate=False)
    eng_a = s.engine(max_batch=1, max_seq=64, max_queue=1)
    eng_b = s.engine(max_batch=2, max_seq=64)
    s.serving.register_engine_pool(
        rt, "llm", [eng_a, eng_b],
        sampling=s.serving.SamplingParams(max_new_tokens=2))
    return rt, eng_a, eng_b


def test_queue_full_retry_ladder_reroutes_to_sibling(stacks):
    def scenario(s):
        rt, eng_a, eng_b = _two_replicas(s)
        rt.apply_directives("llm", {"max_retries": 1, "retry_backoff": 0.01})
        iid_a, iid_b = rt.instances_of_type("llm")
        rt.router.shed_watermark = None
        eng_a.queue.push(s.serving.Request.make(
            list(range(8)),
            sampling=s.serving.SamplingParams(max_new_tokens=60)))
        sid = rt.sessions.new_session(0.0, 0.0).session_id
        rt.router.pin(sid, "llm", iid_a)
        out, errs = [], []

        def driver():
            return s.current_runtime().stub("llm").generate(
                "needs a reroute").value(timeout=120)

        rt.start()
        rt.submit_request(driver, session=sid,
                          on_done=lambda o, e: (out.append(o),
                                                errs.append(e)))
        rt.run()
        try:
            return (errs, out[0].engine_id == iid_b, list(out[0].tokens),
                    eng_a.queue.rejected >= 2, eng_b.metrics.completed)
        finally:
            rt.shutdown()

    errs, on_b, toks, rejected, completed = same(stacks, scenario)
    assert errs == [None] and on_b and rejected and completed >= 1
    assert len(toks) == 2


def test_router_sheds_from_saturated_replica(stacks):
    def scenario(s):
        rt, eng_a, eng_b = _two_replicas(s)
        iid_a, iid_b = rt.instances_of_type("llm")
        eng_a.queue.push(s.serving.Request.make([1, 2, 3]))
        assert eng_a.saturation() >= rt.router.shed_watermark
        sid = rt.sessions.new_session(0.0, 0.0).session_id
        rt.router.pin(sid, "llm", iid_a)

        def driver():
            return s.current_runtime().stub("llm").generate(
                "shed me").value(timeout=60)

        rt.start()
        res = {}
        rt.submit_request(driver, session=sid,
                          on_done=lambda o, e: res.update(out=o, err=e))
        rt.run()
        try:
            return (res["err"], res["out"].engine_id == iid_b,
                    list(res["out"].tokens), eng_a.queue.rejected)
        finally:
            rt.shutdown()

    err, on_b, toks, rejected = same(stacks, scenario)
    assert err is None and on_b and rejected == 0 and len(toks) == 2


def test_engine_metrics_reach_instance_view(stacks):
    def scenario(s):
        rt = s.core.NalarRuntime(simulate=False)
        engine = s.engine(max_batch=2, max_seq=64, max_queue=4)
        s.serving.register_engine_agent(
            rt, "llm", engine,
            sampling=s.serving.SamplingParams(max_new_tokens=2))
        iid = rt.instances_of_type("llm")[0]
        for i in range(3):
            engine.queue.push(s.serving.Request.make([i + 1]))
        rt.controller_of(iid)._publish_metrics()
        iv = rt.global_controller.collect_view(full=True).instances[iid]
        try:
            return (iv.engine_queue, iv.engine_saturation,
                    sorted(rt.engine_backends["llm"].instance_metrics()))
        finally:
            rt.shutdown()

    queue, saturation, _ = same(stacks, scenario)
    assert queue == 3 and saturation == pytest.approx(0.75)


def test_engine_agent_rejected_on_sim_kernel(stacks):
    for s in stacks:
        rt = s.core.NalarRuntime(simulate=True)
        engine = s.engine(max_batch=2, max_seq=64)
        with pytest.raises(RuntimeError, match="simulate=False"):
            s.serving.register_engine_agent(rt, "llm", engine)
        with pytest.raises(RuntimeError, match="simulate=False"):
            s.serving.register_engine_pool(rt, "llm", [engine])
        rt.shutdown()
