"""The port's token-streaming data plane and HTTP front end against the JAX
package's.

The scenarios of the reference's ``tests/test_streaming.py`` on both
packages, over the same float32 smoke weights: the futures' run-id and
stream-owner fences (a retry truncates the chunk log, a hedge loser cannot
interleave, the winner's seal replaces a loser's stream); an engine that
emits one chunk per step whose concatenation is the completion; the
streamed and the completion-only routed drivers through a two-replica
pool (identical tokens, and equal to the reference's); chunks that
concatenate to the completion value with TTFT stamped; and a bridge
drained in the middle of a stream, which fails the request fast instead
of hanging its consumer.  Then the port's own entry points: its
``launch.serve.selftest`` over real TCP on the CPU (streamed text byte
for byte the non-streamed answer), and ``build_pool_runtime``'s
speculating replicas and tiered pools (qwen3-1.7b as the large tier).
"""

import threading
import time

import pytest

pytest.importorskip("jax")

from _torch_nalar import build_stacks, run_request, same  # noqa: E402


@pytest.fixture(scope="module")
def stacks():
    return build_stacks()


def _future(s, rt):
    f = s.future.Future(rt, s.future.FutureMetadata())
    rt.futures.add(f)
    return f


def test_retry_truncates_log_and_fences_stale_appends(stacks):
    def scenario(s):
        f = _future(s, s.core.NalarRuntime(simulate=False))
        stale = f._run_id
        out = [f.append_chunk([9, 9], expect_run=stale),
               f.reset_for_retry(1.0), f.partial(), f.streamed(),
               f.streaming, f.append_chunk([9], expect_run=stale),
               f.append_chunk([1, 2], expect_run=f._run_id), f.partial()]
        return out

    assert same(stacks, scenario) == [True, True, [], 0, False, False, True,
                                      [1, 2]]


def test_hedge_loser_cannot_interleave_and_winner_seal_replaces(stacks):
    def scenario(s):
        rt = s.core.NalarRuntime(simulate=False)
        f = _future(s, rt)
        run = f._run_id
        owner = [f.append_chunk([1], expect_run=run, owner="engine-A"),
                 f.append_chunk([9], expect_run=run, owner="engine-B"),
                 f.append_chunk([2], expect_run=run, owner="engine-A")]
        f.seal_stream([1, 2, 3], owner="engine-A", expect_run=run)
        sealed = f.partial()
        g = _future(s, rt)
        run = g._run_id
        claimed = g.append_chunk([9, 9], expect_run=run, owner="engine-B")
        gen = g._chunk_gen
        g.seal_stream([1, 2, 3], owner="engine-A", expect_run=run)
        g.materialize("w", now=0.0)
        chunks = [t for c in g.iter_chunks(timeout=5.0) for t in c]
        return owner, sealed, claimed, g._chunk_gen - gen, chunks

    assert same(stacks, scenario) == ([True, False, True], [1, 2, 3], True,
                                      1, [1, 2, 3])


def test_engine_emits_incremental_chunks(stacks):
    def scenario(s):
        engine = s.engine(max_batch=2, max_seq=64)
        chunks, done = [], []
        req = s.serving.Request.make(
            list(range(5)), sampling=s.serving.SamplingParams(
                max_new_tokens=4))
        engine.submit_async(req, on_done=done.append,
                            on_chunk=lambda r, c: chunks.append(list(c)))
        for _ in range(200):
            if done:
                break
            engine.step()
            engine.drain_completions()
        qdone = []
        other = s.serving.Request.make(
            list(range(4)), sampling=s.serving.SamplingParams(
                max_new_tokens=3))
        engine.submit_async(other, on_done=qdone.append)
        engine.run_until_idle()
        engine.drain_completions()
        return (done == [req], chunks, list(req.generated), req.streamed,
                qdone == [other], list(other.generated))

    ok, chunks, toks, streamed, qok, qtoks = same(stacks, scenario)
    assert ok and qok and len(toks) == 4 and len(qtoks) == 3
    assert len(chunks) >= 2 and [t for c in chunks for t in c] == toks
    assert streamed == 4


def _pool_runtime(s):
    """The reference test's ``pool_rt``: ``build_pool_runtime(replicas=2,
    max_batch=4, max_new_tokens=16)`` with the stack's weights, and the
    pipelining classifier."""
    rt = s.core.NalarRuntime(simulate=False,
                             nodes={"n0": {"GPU": 2, "CPU": 8}}, seed=0)
    engines = [s.engine(max_batch=4, max_seq=128) for _ in range(2)]
    s.serving.register_engine_pool(
        rt, "llm", engines,
        sampling=s.serving.SamplingParams(max_new_tokens=16),
        resources={"GPU": 1})
    s.router.add_stream_classifier(rt, latency=0.01, k=4)
    rt.start()
    return rt


def test_streamed_and_completion_drivers_byte_identical(stacks):
    def scenario(s):
        rt = _pool_runtime(s)
        try:
            q = "byte identical probe query"
            comp = run_request(rt, s.router.completion_routed_driver, q, 12,
                               4)
            strm = run_request(rt, s.router.streamed_routed_driver, q, 12,
                               4, 4)
            return comp, strm
        finally:
            rt.shutdown()

    comp, strm = same(stacks, scenario)
    assert comp == strm
    assert len(comp["draft"]) == 12 and len(comp["refine"]) == 4


def test_chunks_concatenate_to_completion_value_and_ttft(stacks):
    def scenario(s):
        rt = _pool_runtime(s)

        def driver():
            r = s.current_runtime()
            fut = r.stub("llm").generate("chunk concat probe",
                                         _hint={"out_tokens": 8})
            got = [list(c) for c in fut.iter_chunks(timeout=120.0)]
            return got, [int(t) for t in fut.value().tokens]

        try:
            got, toks = run_request(rt, driver)
            dl = rt.telemetry.deadline_outcomes()
            assert dl["ttft_n"] >= 1
            assert 0 < dl["ttft_p50"] <= dl["ttft_p99"]
            return [t for c in got for t in c], toks, len(got) >= 2
        finally:
            rt.shutdown()

    flat, toks, several = same(stacks, scenario)
    assert flat == toks and len(toks) == 8 and several


def test_drain_fails_partially_streamed_requests_fast(stacks):
    def scenario(s):
        rt = s.core.NalarRuntime(simulate=False)
        engine = s.engine(max_batch=2, max_seq=256)
        s.serving.register_engine_agent(
            rt, "llm", engine,
            sampling=s.serving.SamplingParams(max_new_tokens=192))
        bridge = rt.engine_backends["llm"]
        rt.start()
        box, started = {}, threading.Event()

        def driver():
            fut = s.current_runtime().stub("llm").generate(
                "long streaming request", _hint={"out_tokens": 192})
            box["fut"] = fut
            started.set()
            try:
                for _ in fut.iter_chunks(timeout=60.0):
                    pass
                return "completed"
            except s.future.InstanceDied:
                return "iterator-raised"

        try:
            rt.submit_request(driver, on_done=lambda out, err: box.update(
                out=out, err=err, done=True))
            assert started.wait(120.0)
            fut = box["fut"]
            fut.wait_streamed(1, timeout=120.0)
            t0 = time.monotonic()
            failed = bridge.drain(timeout=0.2)
            deadline = time.monotonic() + 30.0
            while "done" not in box and time.monotonic() < deadline:
                time.sleep(0.02)
            fast = time.monotonic() - t0 < 10.0
            with pytest.raises(s.future.InstanceDied):
                fut.value()
            return failed, box.get("done"), box.get("err"), box.get("out"), \
                fast
        finally:
            rt.shutdown()

    assert same(stacks, scenario) == (1, True, None, "iterator-raised", True)


def test_port_selftest_serves_over_tcp_on_the_cpu(capsys):
    from repro_torch.launch.serve import selftest
    selftest(replicas=1, max_new=8, device="cpu")
    assert "PASS" in capsys.readouterr().out


def _tiered_pool(s):
    """A two-replica pool whose large tier loads qwen3-1.7b's smoke config,
    the Router's tier table installed, one ``tiered_driver`` request per
    tier.  Returns each replica's (tier, arch, completed, tokens)."""
    rt = s.router.build_pool_runtime(
        replicas=2, tiers=["small", "large"],
        tier_archs={"large": "qwen3_1_7b"}, max_new_tokens=4,
        kv_affinity=False, policy=s.core.PolicyChain(), **s.engine_kw)
    backend = rt.engine_backends["llm"]
    iids = sorted(backend.instance_ids)
    rt.router.set_tiers("llm", {backend.bridge_of(i).engine.tier: [i]
                                for i in iids})
    rt.start()
    try:
        for tier in ("large", "small"):
            run_request(rt, s.router.tiered_driver, f"{tier} query", tier, 4)
        out = []
        for iid in iids:
            eng = backend.bridge_of(iid).engine
            out.append((eng.tier, eng.cfg.arch_id, eng.metrics.completed,
                        eng.metrics.tokens_generated))
        return out
    finally:
        rt.shutdown()


def test_port_pool_builder_refuses_what_is_not_ported(stacks):
    from repro_torch.workloads.router import build_pool_runtime
    # speculative decoding is ported: draft_layers arms the replicas
    rt = build_pool_runtime(replicas=1, draft_layers=1, device="cpu")
    try:
        engine = next(iter(rt.engine_backends["llm"].bridges.values())).engine
        assert engine.telemetry()["speculative"] is True
    finally:
        rt.shutdown()
    # every arch is ported (A11): a tiered pool with qwen3-1.7b as its
    # large tier serves a request on each tier, as the reference's does
    assert same(stacks, _tiered_pool) == [
        ("small", "qwen3-0.6b-smoke", 1, 4),
        ("large", "qwen3-1.7b-smoke", 1, 4)]
    rt = build_pool_runtime(replicas=2, device="cpu", prefix_sharing=False)
    try:
        engines = [b.engine for b in rt.engine_backends["llm"].bridges
                   .values()]
        assert [str(e.device) for e in engines] == ["cpu", "cpu"]
        assert not any(e._prefix_share_ok for e in engines)
        assert all(e._paged for e in engines)
    finally:
        rt.shutdown()
