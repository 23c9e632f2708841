"""The port's ``InferenceEngine`` against the JAX package's, on one trace.

Both engines serve the qwen3-0.6b smoke config in float32 on the CPU with
the same weights (carried over by ``interop.params_from_numpy``); the JAX
engine runs its paged plane's gathered-dense path, the port its plain
paged attention.  The trace (numpy seed) mixes sessions with follow-up
turns (resume), a shared system prefix (cross-session prefix sharing), an
anonymous request and more requests than slots, under chunked and
monolithic (``prefill_chunk=0``) admission, then warms sessions through
``warm_session``.  Greedy tokens, ``warm_session`` results, the
``EngineMetrics`` counters and the pool's bookkeeping (``pool.stats`` and
the free-page count) must be identical.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving import batching as jbatching  # noqa: E402
from repro.serving.batching import Request as JRequest  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.sampler import SamplingParams as JSampling  # noqa: E402
import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.serving import batching as tbatching  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.batching import Request as TRequest  # noqa: E402
from repro_torch.serving.engine import InferenceEngine as TEngine  # noqa: E402
from repro_torch.serving.sampler import \
    SamplingParams as TSampling  # noqa: E402

ARCH = "qwen3-0.6b"
COUNTERS = ("completed", "decode_steps", "prefills", "prefill_tokens",
            "prefix_hits", "shared_prefix_hits", "shared_prefix_tokens",
            "tokens_generated", "resume_overflows", "paged_append_failures")
ENGINE_KW = dict(max_batch=3, max_seq=96, page_size=8, rng_seed=0)


@pytest.fixture(scope="module")
def models():
    jmodel = jax_build_model(
        jcfgs.get_smoke_config(ARCH).replace(dtype="float32"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(tcfgs.get_smoke_config(ARCH).replace(
        dtype="float32"))
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    return jmodel, jparams, tmodel, tparams


def _trace(seed):
    """Two waves of (session, prompt, max_new) turns."""
    rng = np.random.default_rng(seed)
    sys_prompt = list(rng.integers(0, 512, 13))

    def fresh(lo, hi):
        return list(rng.integers(0, 512, rng.integers(lo, hi)))

    wave1 = [("a", sys_prompt + fresh(2, 9), 6), ("b", fresh(5, 20), 4),
             ("c", sys_prompt + fresh(1, 6), 5), ("", fresh(3, 11), 3),
             ("d", fresh(9, 30), 7)]
    wave2 = [("a", fresh(2, 6), 5), ("e", sys_prompt + fresh(1, 9), 4),
             ("b", fresh(1, 4), 6), ("f", sys_prompt + fresh(10, 14), 3)]
    return [wave1, wave2]


def _serve(engine, req_cls, sampling_cls, waves):
    out = []
    for wave in waves:
        reqs = []
        for sid, prompt, max_new in wave:
            req = req_cls.make(np.asarray(prompt, np.int32), session_id=sid,
                               sampling=sampling_cls(max_new_tokens=max_new))
            engine.submit(req)
            reqs.append(req)
        engine.run_until_idle()
        assert all(r.finished for r in reqs)
        out += [list(map(int, r.generated)) for r in reqs]
    return out


def _counters(engine):
    return {k: getattr(engine.metrics, k) for k in COUNTERS}


def _pool_state(engine):
    return dict(engine.pool.stats), engine.pool.free_pages()


@pytest.mark.parametrize("prefill_chunk", [4, 0])
def test_same_trace_same_tokens_and_counters(models, prefill_chunk):
    jmodel, jparams, tmodel, tparams = models
    jeng = JEngine(jmodel, jparams, prefill_chunk=prefill_chunk, **ENGINE_KW)
    teng = TEngine(tmodel, tparams, prefill_chunk=prefill_chunk,
                   device="cpu", **ENGINE_KW)
    waves = _trace(1)
    want = _serve(jeng, JRequest, JSampling, waves)
    got = _serve(teng, TRequest, TSampling, waves)
    assert got == want
    assert _counters(teng) == _counters(jeng)
    assert _pool_state(teng) == _pool_state(jeng)
    assert teng.metrics.prefix_hits > 0 and teng.metrics.shared_prefix_hits > 0
    teng.pool.check_invariants()


def test_warm_session_matches(models):
    jmodel, jparams, tmodel, tparams = models
    engines = (JEngine(jmodel, jparams, prefill_chunk=4, **ENGINE_KW),
               TEngine(tmodel, tparams, prefill_chunk=4, device="cpu",
                       **ENGINE_KW))
    rng = np.random.default_rng(2)
    base = [int(t) for t in rng.integers(0, 512, 21)]
    longer = base + [int(t) for t in rng.integers(0, 512, 11)]
    # cold replay (monolithic prefill), full resident coverage, partial
    # coverage extended from another session's indexed prefix, and a
    # session extending its own resident pages
    calls = [("w1", base), ("w1", base[:15]), ("w2", longer),
             ("w1", longer + [5, 6, 7])]
    results, tokens = [], []
    for eng, req_cls, samp in zip(engines, (JRequest, TRequest),
                                  (JSampling, TSampling)):
        results.append([eng.warm_session(sid, toks) for sid, toks in calls])
        tokens.append(_serve(eng, req_cls, samp,
                             [[("w1", [9, 8, 7], 5), ("w2", [3], 4)]]))
    assert results[1] == results[0]
    assert tokens[1] == tokens[0]
    assert _counters(engines[1]) == _counters(engines[0])
    assert _pool_state(engines[1]) == _pool_state(engines[0])
    assert engines[1].metrics.prefix_hits == 2
    engines[1].pool.check_invariants()


def test_admission_control_matches(models):
    """A bounded queue rejects overflow, a request whose deadline already
    passed is refused, an eos hit stops a request early and a cancelled
    request never finishes: on both engines, with equal counters."""
    jmodel, jparams, tmodel, tparams = models
    out = []
    for eng, req_cls, samp, exc in (
            (JEngine(jmodel, jparams, max_queue=3, **ENGINE_KW), JRequest,
             JSampling, jbatching),
            (TEngine(tmodel, tparams, max_queue=3, device="cpu",
                     **ENGINE_KW), TRequest, TSampling, tbatching)):
        probe = eng.generate(list(range(3, 12)),
                             sampling=samp(max_new_tokens=1))
        eos = int(probe.generated[0])
        stopper = req_cls.make(np.arange(3, 12, dtype=np.int32),
                               sampling=samp(max_new_tokens=8,
                                             eos_token=eos))
        friend = req_cls.make(np.arange(20, 31, dtype=np.int32),
                              session_id="f",
                              sampling=samp(max_new_tokens=6))
        doomed = req_cls.make(np.arange(40, 45, dtype=np.int32),
                              sampling=samp(max_new_tokens=6))
        for r in (stopper, friend, doomed):
            eng.submit(r)
        with pytest.raises(exc.EngineOverloaded):
            eng.submit(req_cls.make([1, 2]))
        with pytest.raises(exc.RequestExpired):
            eng.submit(req_cls.make([1, 2], deadline_wall=0.0))
        eng.step()
        assert eng.cancel_request(doomed.request_id)
        eng.run_until_idle()
        assert not doomed.finished and stopper.generated == [eos]
        out.append(([list(map(int, r.generated))
                     for r in (probe, stopper, friend)], _counters(eng),
                    eng.metrics.expired, eng.metrics.admission_rejects))
    assert out[1] == out[0]


def test_stochastic_samples_are_per_request(models):
    """A stochastic request draws from its own generator: batching it with
    other stochastic requests does not change its tokens (the JAX engine's
    invariant; the draws themselves differ from ``jax.random``'s)."""
    _, _, tmodel, tparams = models
    sp = TSampling(temperature=0.7, top_k=8, max_new_tokens=5, seed=123)
    prompt = list(range(2, 12))
    solo = TEngine(tmodel, tparams, device="cpu", **ENGINE_KW).generate(
        prompt, sampling=sp).generated
    eng = TEngine(tmodel, tparams, device="cpu", **ENGINE_KW)
    rng = np.random.default_rng(7)
    others = [TRequest.make(rng.integers(0, 512, size=6),
                            sampling=TSampling(temperature=0.9,
                                               max_new_tokens=5))
              for _ in range(3)]
    target = TRequest.make(prompt, sampling=sp)
    for r in others[:1] + [target] + others[1:]:
        eng.submit(r)
    eng.run_until_idle()
    assert target.generated == solo
    assert len(set(solo)) > 1
    greedy = TEngine(tmodel, tparams, device="cpu", **ENGINE_KW).generate(
        prompt, sampling=TSampling(max_new_tokens=5)).generated
    assert solo != greedy


def test_sample_respects_greedy_and_top_k():
    import torch
    from repro_torch.serving.sampler import sample
    logits = torch.from_numpy(
        np.random.default_rng(3).standard_normal((4, 50)).astype(np.float32))
    top3 = torch.topk(logits, 3, dim=-1).indices
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(sample(logits, TSampling(), None),
                       logits.argmax(-1).int())
    for _ in range(20):
        tok = sample(logits, TSampling(temperature=2.0, top_k=3), gen)
        assert bool((top3 == tok[:, None].long()).any(-1).all())


@pytest.mark.parametrize("temperature,top_k", [(0.7, 0), (1.3, 4)])
def test_sample_draws_the_reference_distribution(temperature, top_k):
    """The port's draws follow the distribution the JAX sampler draws from
    (``target_probs``): total variation under 0.05 over 4000 draws, the
    bound of the reference's own speculative-sampling test."""
    import torch
    from repro.serving.sampler import target_probs
    from repro_torch.serving.sampler import sample
    V, trials = 8, 4000
    logits = np.random.default_rng(1).standard_normal((1, V)).astype(
        np.float32)
    want = target_probs(logits, JSampling(temperature=temperature,
                                          top_k=top_k))[0]
    toks = sample(torch.from_numpy(np.repeat(logits, trials, 0)),
                  TSampling(temperature=temperature, top_k=top_k),
                  torch.Generator().manual_seed(0))
    emp = np.bincount(toks.numpy(), minlength=V) / trials
    assert 0.5 * np.abs(emp - want).sum() < 0.05


def test_expired_requests_are_delivered(models):
    """A request whose deadline has passed when it is admitted comes out of
    ``poll_finished()`` with ``expired=True`` (the bridge resolves its
    future ``DeadlineExceeded`` from there), beside a live request that
    completes; the queue's clock is held at 0 so that submit accepts the
    past deadline, as ``tests/test_failure_handling.py`` does."""
    jmodel, jparams, tmodel, tparams = models
    out = []
    for eng, req_cls, samp in (
            (JEngine(jmodel, jparams, **ENGINE_KW), JRequest, JSampling),
            (TEngine(tmodel, tparams, device="cpu", **ENGINE_KW), TRequest,
             TSampling)):
        eng.queue.clock = lambda: 0.0
        late = req_cls.make([1, 2, 3], deadline_wall=1.0,
                            sampling=samp(max_new_tokens=2))
        live = req_cls.make([4, 5, 6], sampling=samp(max_new_tokens=2))
        eng.submit(late)
        eng.submit(live)
        eng.run_until_idle()
        done = eng.poll_finished()
        out.append(([("late" if r is late else "live", r.expired, r.finished)
                     for r in done], list(map(int, live.generated)),
                    late.generated, eng.metrics.expired,
                    eng.metrics.completed, eng.poll_finished()))
    assert out[1] == out[0]
    assert out[1][0] == [("late", True, True), ("live", False, True)]
