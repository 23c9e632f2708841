"""The port's speculative decoding against the JAX package's, on the CPU.

The reference's scenarios (``tests/test_speculative_decode.py``), run on
both packages where the reference has a side:

* greedy speculative decoding is bitwise the port's plain decode, in tokens
  and in committed K/V bytes, on the qwen3-0.6b and granite-moe smoke
  configs in bf16 (a chunk of T tokens gives the same bits as T one-token
  steps there);
* the port's speculating engine serves a trace with follow-up turns and a
  shared prefix (chunked and monolithic admission) with the reference's
  tokens, spec counters and pool bookkeeping, over the same float32 smoke
  weights (carried over by ``interop.params_from_numpy``);
* the verifier (argmax prefix; the target distribution preserved, with the
  port's generators; a draft equal to the target accepted; a rejected
  point mass never re-emitted), the draft engine's propose / rollback
  protocol, its refusals, the per-session auto-disable, seeded stochastic
  reproducibility, ``truncate_reserved`` and ``build_pool_runtime(
  draft_layers=1)``.

Sampled tokens cannot match the reference's (``torch.Generator`` against
``jax.random``), so stochastic runs are checked within the port.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.batching import Request as JRequest  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.kv_cache import PagedKVPool as JPool  # noqa: E402
from repro.serving import sampler as jsampler  # noqa: E402
from repro.serving import speculative as jspec  # noqa: E402
import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.batching import Request as TRequest  # noqa: E402
from repro_torch.serving.engine import InferenceEngine as TEngine  # noqa: E402
from repro_torch.serving.kv_cache import PagedKVPool as TPool  # noqa: E402
from repro_torch.serving import sampler as tsampler  # noqa: E402
from repro_torch.serving import speculative as tspec  # noqa: E402

QWEN, GRANITE = "qwen3_0_6b", "granite_moe_1b_a400m"
MAX_SEQ = 96
PAGE = 8
ENGINE_KW = dict(max_batch=4, max_seq=MAX_SEQ, page_size=PAGE, rng_seed=0)
SPEC_COUNTERS = ("spec_rounds", "spec_proposed", "spec_accepted",
                 "tokens_generated", "decode_steps", "prefills",
                 "prefix_hits", "shared_prefix_hits", "shared_prefix_tokens",
                 "paged_append_failures")

_MODELS = {}


def _models(arch, dtype=None):
    """(jax model, jax params, port model, port params) of ``arch``'s smoke
    config, the port's weights the JAX package's (seed 0)."""
    if (arch, dtype) not in _MODELS:
        jcfg, tcfg = (m.get_smoke_config(arch) for m in (jcfgs, tcfgs))
        if dtype:
            jcfg, tcfg = jcfg.replace(dtype=dtype), tcfg.replace(dtype=dtype)
        jmodel = jax_build_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        _MODELS[arch, dtype] = (jmodel, jparams, build_model(tcfg),
                                params_from_numpy(jax.device_get(jparams),
                                                  device="cpu"))
    return _MODELS[arch, dtype]


def _port_engine(arch, *, spec=False, **kw):
    """A port engine over ``arch``'s bf16 smoke weights."""
    _, _, model, params = _models(arch)
    if spec:
        dm, dp = tspec.truncated_draft(model, params, 1)
        kw.setdefault("spec_k", 3)
        kw.update(draft_model=dm, draft_params=dp)
    kw.setdefault("prefill_chunk", 4)
    return TEngine(model, params, device="cpu", **ENGINE_KW, **kw)


def _serve(eng, req_cls, sampling_cls, n_req=6, gen_len=16,
           temperature=0.0, seed=None):
    """The reference test's trace: ``n_req`` sessions, prompts 5+j long."""
    vocab = eng.cfg.vocab_size
    sp = sampling_cls(temperature=temperature, max_new_tokens=gen_len,
                      seed=seed)
    reqs = []
    for j in range(n_req):
        prompt = [(7 * j + t) % vocab for t in range(5 + j)]
        r = req_cls.make(prompt, session_id=f"s{j}", sampling=sp)
        eng.submit(r)
        reqs.append(r)
    while eng.step():
        pass
    return reqs


def _session_bytes(eng, sid):
    k, v, tokens = eng.pool.gather_contiguous(sid, eng.max_seq)
    return k[:, :tokens], v[:, :tokens], tokens


# --------------------------------------------- greedy bitwise differential
@pytest.mark.parametrize("arch", [QWEN, GRANITE])
def test_greedy_speculative_matches_plain_bitwise(arch):
    """Same greedy tokens and same committed K/V bytes as the plain paged
    decode, dense and MoE (the MoE layers run the dropless dispatch, whose
    rows do not depend on the batch)."""
    base = _port_engine(arch)
    spec = _port_engine(arch, spec=True, spec_min_accept=0.0)
    b_reqs = _serve(base, TRequest, tsampler.SamplingParams)
    s_reqs = _serve(spec, TRequest, tsampler.SamplingParams)
    assert spec.metrics.spec_rounds > 0 and spec.metrics.spec_proposed > 0
    assert spec.telemetry()["speculative"] is True
    assert base.telemetry()["speculative"] is False
    for rb, rs in zip(b_reqs, s_reqs):
        assert rb.generated == rs.generated, rb.session_id
        kb, vb, tb = _session_bytes(base, rb.session_id)
        ks, vs, ts = _session_bytes(spec, rs.session_id)
        assert tb == ts
        assert kb.dtype == ks.dtype
        assert kb.equal(ks) and vb.equal(vs), rb.session_id
    base.pool.check_invariants()
    spec.pool.check_invariants()
    if arch == QWEN:
        # speculation paid on the dense config, as on the reference
        assert spec.metrics.spec_acceptance > 0.15
        assert (spec.metrics.decode_tokens_per_step
                > base.metrics.decode_tokens_per_step)


# ------------------------------------------------ port against reference
def _trace(seed, vocab):
    """Two waves of (session, prompt, max_new): follow-up turns (resume), a
    shared system prefix (cross-session sharing) and an anonymous
    request."""
    rng = np.random.default_rng(seed)
    sys_prompt = [int(t) for t in rng.integers(0, vocab, 13)]

    def fresh(lo, hi):
        return [int(t) for t in rng.integers(0, vocab, rng.integers(lo, hi))]

    wave1 = [("a", sys_prompt + fresh(2, 9), 9), ("b", fresh(5, 20), 7),
             ("c", sys_prompt + fresh(1, 6), 12), ("", fresh(3, 11), 5),
             ("d", fresh(9, 30), 10)]
    wave2 = [("a", fresh(2, 6), 8), ("e", sys_prompt + fresh(1, 9), 6),
             ("b", fresh(1, 4), 11)]
    return [wave1, wave2]


@pytest.mark.parametrize("arch,prefill_chunk", [
    pytest.param(QWEN, 4, id="4"), pytest.param(QWEN, 0, id="0"),
    pytest.param(GRANITE, 4, id="granite-4")])
def test_speculating_engine_matches_reference(arch, prefill_chunk):
    """Both packages' speculating engines on one trace in float32, stepped
    in lockstep: the same active slots and free pages after every step (the
    rejected tails' reserved pages released alike by
    ``truncate_reserved``), then the same tokens, spec counters and pool
    statistics.  qwen3 at both admissions; granite-moe (MoE layers in the
    verify chunk) at chunked admission."""
    jmodel, jparams, tmodel, tparams = _models(arch, "float32")
    engines = []
    for model, params, truncated_draft, eng_cls, kw in (
            (jmodel, jparams, jspec.truncated_draft, JEngine, {}),
            (tmodel, tparams, tspec.truncated_draft, TEngine,
             {"device": "cpu"})):
        dm, dp = truncated_draft(model, params, 1)
        engines.append(eng_cls(model, params, draft_model=dm,
                               draft_params=dp, spec_k=3, spec_min_accept=0.0,
                               prefill_chunk=prefill_chunk, **ENGINE_KW,
                               **kw))
    jeng, teng = engines
    reqs = ([], [])
    for wave in _trace(3, tmodel.cfg.vocab_size):
        for eng, out, req_cls, sampling_cls in (
                (jeng, reqs[0], JRequest, jsampler.SamplingParams),
                (teng, reqs[1], TRequest, tsampler.SamplingParams)):
            for sid, prompt, max_new in wave:
                r = req_cls.make(np.asarray(prompt, np.int32),
                                 session_id=sid,
                                 sampling=sampling_cls(max_new_tokens=max_new))
                eng.submit(r)
                out.append(r)
        while True:
            active = [e.step() for e in engines]
            assert active[1] == active[0]
            assert teng.pool.free_pages() == jeng.pool.free_pages()
            if active[0] == 0 and not len(jeng.queue):
                break
    assert all(r.finished for r in reqs[0] + reqs[1])
    assert ([[int(t) for t in r.generated] for r in reqs[1]]
            == [[int(t) for t in r.generated] for r in reqs[0]])
    counters = [{k: getattr(e.metrics, k) for k in SPEC_COUNTERS}
                for e in engines]
    assert counters[1] == counters[0]
    assert teng.metrics.spec_rounds > 0 and teng.metrics.prefix_hits > 0
    assert dict(teng.pool.stats) == dict(jeng.pool.stats)
    teng.pool.check_invariants()


def test_truncate_reserved_matches_reference():
    """A session reserves k+1 = 4 positions across a page boundary and
    commits 2: both pools free the same pages and keep the same
    bookkeeping, and the kept pages hold the committed tokens' index."""
    jmodel, _, tmodel, _ = _models(QWEN, "float32")
    state = []
    for pool in (JPool(jmodel.cfg, n_pages=8, page_size=4),
                 TPool(tmodel.cfg, n_pages=8, page_size=4, device="cpu")):
        ids = [5, 6, 7, 8, 9, 10]
        assert pool.begin_append("s", 6)
        pool.commit_append("s", 6, token_ids=ids)
        assert pool.begin_append("s", 4)            # positions 6..9: 3 pages
        pool.commit_append("s", 2, token_ids=[11, 12])
        freed = pool.truncate_reserved("s")
        again = pool.truncate_reserved("s")
        sp = pool.session("s")
        pool.check_invariants()
        state.append((freed, again, list(sp.pages), sp.tokens,
                      list(sp.token_ids), pool.free_pages(), dict(pool.stats),
                      pool.match_prefix(ids + [11, 12]),
                      pool.truncate_reserved("absent")))
    assert state[1] == state[0]
    assert state[1][0] == 1 and state[1][1] == 0


# ------------------------------------------------- sampler-level properties
def test_verify_greedy_walks_argmax_prefix():
    V = 16
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, V)).astype(np.float32)
    g = np.argmax(logits, axis=-1)
    sp = tsampler.SamplingParams(temperature=0.0)
    jsp = jsampler.SamplingParams(temperature=0.0)
    agree = [int(x) for x in g[:3]]
    diverge = [int(g[0]), int((g[1] + 1) % V), int(g[2])]
    for drafts, want in ((agree, ([int(x) for x in g], 3)),
                         (diverge, ([int(g[0]), int(g[1])], 1))):
        got = tsampler.speculative_verify(logits, drafts, sp, None)
        assert got == want
        assert got == jsampler.speculative_verify(logits, drafts, jsp, None)


def test_target_probs_match_reference():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 24)).astype(np.float32)
    for temperature, top_k in ((0.0, 0), (0.7, 0), (1.3, 5)):
        got = tsampler.target_probs(logits, tsampler.SamplingParams(
            temperature=temperature, top_k=top_k))
        want = jsampler.target_probs(logits, jsampler.SamplingParams(
            temperature=temperature, top_k=top_k))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_verify_stochastic_preserves_target_distribution():
    """Point-mass proposal, one draft position: the emitted token's law must
    be exactly the target's (accept d w.p. p(d), else resample from the
    renormalized residual, which marginalizes back to p), over the port's
    per-position generators."""
    V = 8
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, V)).astype(np.float32)
    sp = tsampler.SamplingParams(temperature=0.7)
    p = tsampler.target_probs(logits, sp)[0]
    d = int(np.argmax(p))                      # what an argmax draft proposes
    counts = np.zeros(V)
    trials = 4000
    for i in range(trials):
        toks, _ = tsampler.speculative_verify(logits, [d], sp, i)
        counts[toks[0]] += 1
    tv = 0.5 * np.abs(counts / trials - p).sum()
    assert tv < 0.05, f"total variation {tv:.3f}, p={p}, emp={counts/trials}"


def test_verify_accepts_everything_when_draft_equals_target():
    V = 8
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, V)).astype(np.float32)
    sp = tsampler.SamplingParams(temperature=1.0)
    p = tsampler.target_probs(logits, sp)
    drafts = [3, 5]
    toks, m = tsampler.speculative_verify(logits, drafts, sp, 0,
                                          draft_probs=p[:2])
    assert m == 2 and toks[:2] == drafts and len(toks) == 3


def test_verify_rejection_never_reemits_pointmass_draft():
    """The residual max(p - q, 0) zeroes the rejected argmax-draft token,
    so a rejection never resamples the token it just rejected; the draws
    of a seed do not change between calls."""
    V = 8
    rng = np.random.default_rng(3)
    sp = tsampler.SamplingParams(temperature=0.5)
    rejected = 0
    for i in range(64):
        logits = rng.standard_normal((2, V)).astype(np.float32)
        d = int(np.argmin(logits[0]))          # unlikely draft: often rejected
        toks, m = tsampler.speculative_verify(logits, [d], sp, i)
        assert (toks, m) == tsampler.speculative_verify(logits, [d], sp, i)
        if m == 0:
            rejected += 1
            assert toks[0] != d
    assert rejected > 0


# ----------------------------------------------------- draft engine protocol
def test_draft_engine_refuses_windowed_and_recurrent_drafts():
    """A windowed draft (the qwen3 smoke config given a window) is refused
    by both packages; the port also refuses a recurrent one."""
    jmodel, jparams, tmodel, tparams = _models(QWEN)
    with pytest.raises(ValueError, match="non-windowed"):
        jspec.DraftEngine(jax_build_model(jmodel.cfg.replace(
            sliding_window=16)), jparams, max_batch=2, max_seq=32)
    with pytest.raises(ValueError, match="non-windowed"):
        tspec.DraftEngine(build_model(tmodel.cfg.replace(sliding_window=16)),
                          tparams, max_batch=2, max_seq=32, device="cpu")
    with pytest.raises(ValueError, match="attention model"):
        tspec.DraftEngine(build_model(tcfgs.get_smoke_config("mamba2_130m")),
                          {}, max_batch=2, max_seq=32, device="cpu")
    # nor can a recurrent draft be distilled: its family's training
    # forward is not ported yet
    mamba = build_model(tcfgs.get_smoke_config("mamba2_130m"))
    with pytest.raises(NotImplementedError, match="A14"):
        tspec.distill_draft(mamba, mamba.init(torch.Generator().manual_seed(0),
                                              device="cpu"), tmodel, tparams,
                            lambda g: np.zeros((1, 4), np.int32), steps=1)


def test_draft_engine_propose_rollback_stream_consistency():
    jmodel, jparams, tmodel, tparams = _models(QWEN, "float32")
    dm, dp = tspec.truncated_draft(tmodel, tparams, 1)
    assert dm.cfg.n_layers == 1
    # a view of the target's layers, no copy
    assert (dp["layers"]["attn"]["wq"].data_ptr()
            == tparams["layers"]["attn"]["wq"].data_ptr())
    eng = tspec.DraftEngine(dm, dp, max_batch=2, max_seq=32, device="cpu")
    eng.observe(0, [1, 2, 3])
    props = eng.propose({0: 3})[0]
    assert len(props) == 3
    assert eng._stream[0] == [1, 2, 3] + props
    # the reference's draft proposes the same tokens on the same weights
    jdm, jdp = jspec.truncated_draft(jmodel, jparams, 1)
    jeng = jspec.DraftEngine(jdm, jdp, max_batch=2, max_seq=32)
    jeng.observe(0, [1, 2, 3])
    assert jeng.propose({0: 3})[0] == props
    # the verifier kept only the first proposal: stream truncates, pos
    # rewinds
    eng.rollback(0, 4)
    assert eng._stream[0] == [1, 2, 3, props[0]]
    assert int(eng.cache["pos"][0]) <= 4
    # a fully consumed stream cannot be extended: the engine always
    # observes the verifier's last emission before the next propose
    with pytest.raises(ValueError, match="nothing pending"):
        eng.propose({0: 2})
    # re-proposing after observing the next token is deterministic: the
    # rolled-back cache behaves exactly like a fresh one
    eng.observe(0, [42])
    again = eng.propose({0: 2})[0]
    eng2 = tspec.DraftEngine(dm, dp, max_batch=2, max_seq=32, device="cpu")
    eng2.observe(0, [1, 2, 3, props[0], 42])
    assert eng2.propose({0: 2})[0] == again


def test_spec_auto_disables_per_session_when_acceptance_poor():
    eng = _port_engine(QWEN, spec=True,
                       spec_min_accept=1.01,     # unsatisfiable threshold
                       spec_warmup=4)
    reqs = _serve(eng, TRequest, tsampler.SamplingParams, n_req=2,
                  gen_len=20)
    assert eng.metrics.spec_rounds > 0
    for r in reqs:
        assert r.session_id in eng._spec_off
        assert len(r.generated) == 20            # still served correctly
    eng.pool.check_invariants()


def test_stochastic_speculative_serves_and_is_reproducible():
    """Seeded stochastic speculative decoding completes with exact pool
    provenance, and the same seed gives the same tokens on a fresh
    engine."""
    outs = []
    for _ in range(2):
        eng = _port_engine(QWEN, spec=True, spec_min_accept=0.0)
        reqs = _serve(eng, TRequest, tsampler.SamplingParams, n_req=4,
                      temperature=0.8, seed=17)
        eng.pool.check_invariants()
        assert eng.metrics.spec_rounds > 0
        for r in reqs:
            assert len(r.generated) == r.sampling.max_new_tokens
        outs.append([list(r.generated) for r in reqs])
    assert outs[0] == outs[1]


# ------------------------------------------------- runtime and telemetry
def test_pool_runtime_with_draft_layers_serves_and_reports():
    """``build_pool_runtime(draft_layers=1)`` arms its replica with a
    one-layer self-draft; a request served through the runtime runs
    speculation rounds, and the ClusterView reads the engine's
    acceptance."""
    from repro_torch.core.policy import PolicyChain
    from repro_torch.workloads.router import build_pool_runtime

    rt = build_pool_runtime(replicas=1, draft_layers=1, spec_k=3,
                            max_new_tokens=8, policy=PolicyChain(),
                            device="cpu")
    try:
        engine = next(iter(rt.engine_backends["llm"].bridges.values())).engine
        assert engine.telemetry()["speculative"] is True
        assert engine._spec.model.cfg.n_layers == 1
        box = {}

        def driver():
            box["out"] = rt.stub("llm").generate(
                "speculate on this request please").value(timeout=120)

        rt.submit_request(driver, on_done=lambda out, err: box.update(
            err=err))
        rt.run()
        assert box.get("err") is None and len(box["out"].tokens) == 8
        m = engine.metrics
        assert m.spec_rounds > 0 and m.tokens_generated == 8
        iid = rt.instances_of_type("llm")[0]
        rt.controller_of(iid)._publish_metrics()
        iv = rt.global_controller.collect_view(full=True).instances[iid]
        assert iv.engine_spec_acceptance == pytest.approx(m.spec_acceptance)
        assert iv.engine_decode_tokens_per_step == pytest.approx(
            m.decode_tokens_per_step)
    finally:
        rt.shutdown()
