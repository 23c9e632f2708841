"""The port's ssm family (mamba2) and its state-cache engine against the JAX
package's, on the CPU.

What is held against the reference, with inputs from numpy seeds:

* the SSD chunk scan's plain version (``ssd_chunked_ref``, and the wrapper
  ``ssd_chunk_scan``, which takes it for a CPU tensor) against the
  reference's ``ssd_chunked`` (y and the final state), the Pallas
  ``ssd_fused`` in interpret mode and the token-by-token
  ``ssd_sequential_ref``, on the reference's own sweep plus a ragged last
  chunk, a chunk longer than the sequence and initial states.  Tolerances:
  float32 2e-5 (summation order only); bf16 1e-2 on y (both sides round the
  scores, the decayed score matrix, dt and y to bf16 at the same places;
  the final state is float32 on both); against Pallas 2e-4 and against the
  sequential recurrence 1e-4, the reference sweep's own bounds;
* the mamba2 smoke model, float32 and bf16, with the reference's weights
  (``interop.params_from_numpy``): ``init_params``' tree, ``prefill``
  logits and cache (conv, ssm, pos), three ``decode_step``s, and
  ``decode_chunk`` with a ``valid_len`` mask.  float32 2e-4 (the bound of
  the reference's own pallas-vs-xla decode test); bf16 3e-2 of the largest
  reference value (bf16 rounds every activation, at places the two
  frameworks choose differently);
* the ``StateCachePool`` operations, and the engine with
  ``prefill_chunk=8`` (the fused recurrent plane) and ``prefill_chunk=0``
  (monolithic admission through the chunk scan) on a trace with follow-up
  turns and ``warm_session``: greedy tokens, ``EngineMetrics`` counters
  and warm results identical, the pool's sessions and token counts
  identical and their state rows within 2e-5; the fused step gives the
  per-token masked step's tokens, as the reference pins.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
from repro.kernels.ssd.ops import ssd_fused  # noqa: E402
from repro.kernels.ssd.ref import ssd_sequential_ref  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.batching import Request as JRequest  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.kv_cache import StateCachePool as JPool  # noqa: E402
from repro.serving.sampler import SamplingParams as JSampling  # noqa: E402
import repro_torch as rt  # noqa: E402
import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd.ref import (ssd_chunked_ref,  # noqa: E402
                                         ssd_sequential)
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.batching import Request as TRequest  # noqa: E402
from repro_torch.serving.engine import InferenceEngine as TEngine  # noqa: E402
from repro_torch.serving.kv_cache import StateCachePool  # noqa: E402
from repro_torch.serving.sampler import \
    SamplingParams as TSampling  # noqa: E402

from _torch_cases import SSD_CASES, ssd_case  # noqa: E402
from test_torch_engine import _counters, _serve, _trace  # noqa: E402

ARCH = "mamba2-130m"
F32_TOL = dict(rtol=2e-5, atol=2e-5)
SSD_BF16_TOL = dict(rtol=1e-2, atol=1e-2)
PALLAS_TOL = dict(rtol=2e-4, atol=2e-4)
SEQ_TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": 3e-2}
ENGINE_KW = dict(max_batch=3, max_seq=96, rng_seed=0)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _close(got, want, dtype):
    """float32: elementwise 2e-4; bf16: the largest difference within 3e-2
    of the largest reference value."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    tol = MODEL_TOL[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **tol)
    else:
        assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _ssd_inputs(case, dtype="float32"):
    seed, B, S, H, P, N, chunk, init = case
    x, dt, A, Bm, Cm, h0 = ssd_case(seed, B, S, H, P, N, init)
    tdt = getattr(torch, dtype)
    t = [torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
         torch.from_numpy(A), torch.from_numpy(Bm).to(tdt),
         torch.from_numpy(Cm).to(tdt)]
    j = [jnp.asarray(x, dtype), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(Bm, dtype), jnp.asarray(Cm, dtype)]
    th0 = None if h0 is None else torch.from_numpy(h0)
    jh0 = None if h0 is None else jnp.asarray(h0)
    return t, th0, j, jh0, chunk


# ------------------------------------------------------------------ kernel
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_plain_ssd_matches_ssd_chunked(case, dtype):
    t, th0, j, jh0, chunk = _ssd_inputs(case, dtype)
    n = ssd_ops.ssd_chunk_scan.launches
    y, final = ssd_ops.ssd_chunk_scan(*t, chunk=chunk, init_state=th0)
    assert ssd_ops.ssd_chunk_scan.launches == n      # the CPU runs no kernel
    assert y.dtype == t[0].dtype and y.is_contiguous()
    assert final.dtype == torch.float32
    want_y, want_final = JS.ssd_chunked(*j, chunk, init_state=jh0)
    np.testing.assert_allclose(_np(y), _np(want_y),
                               **(F32_TOL if dtype == "float32"
                                  else SSD_BF16_TOL))
    np.testing.assert_allclose(final.numpy(), _np(want_final), **F32_TOL)


@pytest.mark.parametrize("case", SSD_CASES)
def test_plain_ssd_matches_pallas_and_the_recurrence(case):
    """float32: against the Pallas kernel in interpret mode (which takes
    neither an initial state nor a ragged sequence, and returns no state),
    the reference's sequential recurrence (no initial state either) and the
    port's own, which takes one."""
    t, th0, j, jh0, chunk = _ssd_inputs(case)
    y, final = ssd_chunked_ref(*t, chunk, th0)
    S = t[0].shape[1]
    if th0 is None and S % min(chunk, S) == 0:
        np.testing.assert_allclose(
            y.numpy(), _np(ssd_fused(*j, chunk=chunk)), **PALLAS_TOL)
    if th0 is None:
        np.testing.assert_allclose(y.numpy(), _np(ssd_sequential_ref(*j)),
                                   **SEQ_TOL)
    seq_y, seq_final = ssd_sequential(*t, init_state=th0)
    np.testing.assert_allclose(y.numpy(), seq_y.numpy(), **SEQ_TOL)
    np.testing.assert_allclose(final.numpy(), seq_final.numpy(), **SEQ_TOL)


def test_ragged_tail_is_identity_steps():
    """S=193 in chunks of 64: the final state and y equal, bitwise, those
    of the same sequence padded to 256 with dt=0 steps, and the state
    equals the recurrence's after 193 steps."""
    x, dt, A, Bm, Cm, _ = (torch.from_numpy(a) if a is not None else None
                           for a in ssd_case(6, 2, 193, 2, 32, 32))
    y, final = ssd_ops.ssd_chunk_scan(x, dt, A, Bm, Cm, chunk=64)

    def pad(a):
        return torch.cat([a, torch.zeros((a.shape[0], 63) + a.shape[2:])],
                         dim=1)

    py, pfinal = ssd_ops.ssd_chunk_scan(pad(x), pad(dt), A, pad(Bm),
                                        pad(Cm), chunk=64)
    assert torch.equal(final, pfinal) and torch.equal(y, py[:, :193])
    _, seq_final = ssd_sequential(x, dt, A, Bm, Cm)
    np.testing.assert_allclose(final.numpy(), seq_final.numpy(), **SEQ_TOL)


def test_strided_inputs_are_read_in_place():
    """x, Bm and Cm as slices of one [B,S,H*P+2N] buffer, as the model
    hands them over (time stride H*P+2N), give the contiguous copies'
    results bitwise."""
    x, dt, A, Bm, Cm, _ = ssd_case(7, 2, 70, 3, 16, 32)
    B, S, H, P = x.shape
    buf = torch.from_numpy(np.concatenate(
        [x.reshape(B, S, H * P), Bm, Cm], axis=-1))
    xs, bs, cs = torch.split(buf, [H * P, 32, 32], dim=-1)
    xs = xs.reshape(B, S, H, P)
    assert not xs.is_contiguous() and xs.stride(1) == H * P + 64
    got = ssd_ops.ssd_chunk_scan(xs, torch.from_numpy(dt),
                                 torch.from_numpy(A), bs, cs, chunk=32)
    want = ssd_ops.ssd_chunk_scan(*(torch.from_numpy(a)
                                    for a in (x, dt, A, Bm, Cm)), chunk=32)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_ssd_checks_the_layout_on_every_device():
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in
                        ssd_case(8, 1, 8, 2, 16, 8)[:5])
    scan = ssd_ops.ssd_chunk_scan
    with pytest.raises(ValueError, match="does not match"):
        scan(x, dt[:, :4], A, Bm, Cm, chunk=4)
    with pytest.raises(ValueError, match="contiguous float32"):
        scan(x, dt.bfloat16(), A, Bm, Cm, chunk=4)
    with pytest.raises(ValueError, match="share one type"):
        scan(x.bfloat16(), dt, A, Bm, Cm, chunk=4)
    with pytest.raises(ValueError, match="bf16 or f32"):
        scan(x.half(), dt, A, Bm.half(), Cm.half(), chunk=4)
    with pytest.raises(ValueError, match="head stride"):
        scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, Bm, Cm,
             chunk=4)
    with pytest.raises(ValueError, match="unit inner stride"):
        scan(x, dt, A, Bm.transpose(1, 2).contiguous().transpose(1, 2), Cm,
             chunk=4)
    with pytest.raises(ValueError, match="init_state"):
        scan(x, dt, A, Bm, Cm, chunk=4,
             init_state=torch.zeros(1, 2, 16, 8, dtype=torch.bfloat16))


# ------------------------------------------------------------------- model
def _cfgs(dtype="float32"):
    return (jcfgs.get_smoke_config(ARCH).replace(dtype=dtype),
            tcfgs.get_smoke_config(ARCH).replace(dtype=dtype))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    jcfg, tcfg = _cfgs(request.param)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    return request.param, jmodel, jparams, build_model(tcfg), tparams


def _tree(t, prefix=""):
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
    return out


def test_configs_and_init_params_tree(models):
    dtype, jmodel, jparams, tmodel, tparams = models
    for smoke in (False, True):
        get_j = jcfgs.get_smoke_config if smoke else jcfgs.get_config
        get_t = tcfgs.get_smoke_config if smoke else tcfgs.get_config
        assert dataclasses.asdict(get_t(ARCH)) == dataclasses.asdict(
            get_j("mamba2_130m"))
    own = tmodel.init(torch.Generator().manual_seed(0), device="cpu")
    want = {k: (shape, "bfloat16" if "bfloat16" in str(dt) else dt)
            for k, (shape, dt) in _tree(jax.device_get(jparams)).items()}
    assert _tree(own) == want == _tree(tparams)
    assert own["layers"]["A_log"].dtype == torch.float32
    np.testing.assert_allclose(own["layers"]["A_log"].numpy(),
                               _np(jparams["layers"]["A_log"]), rtol=1e-6)


def test_prefill_and_decode_steps_match(models):
    dtype, jmodel, jparams, tmodel, tparams = models
    toks = np.random.default_rng(1).integers(0, 512, (2, 37)).astype(
        np.int32)       # 37 = 2 chunks of 16 and a ragged 5
    n = ssd_ops.ssd_chunk_scan.launches
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    assert ssd_ops.ssd_chunk_scan.launches == n
    assert tc["conv"].dtype == getattr(torch, dtype)
    assert tc["ssm"].dtype == torch.float32
    for step in range(4):
        if step:
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            jl, jc = jmodel.decode_step(jparams, jnp.asarray(tok), jc)
            tl, tc = tmodel.decode_step(tparams, torch.from_numpy(tok), tc)
        _close(tl, jl, dtype)
        for key in ("conv", "ssm"):
            _close(tc[key], jc[key], dtype)
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))


def test_decode_chunk_masks_rows(models):
    """A random state, valid lengths 4, 2, 1 and 0: the logits of every
    valid position and the new cache; the idle row keeps its state and
    position bitwise."""
    dtype, jmodel, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    rng = np.random.default_rng(6)
    B, T = 4, 4
    cache = tmodel.init_cache(B, 64, device="cpu")
    conv = rng.standard_normal(tuple(cache["conv"].shape)).astype(np.float32)
    ssm = (rng.standard_normal(tuple(cache["ssm"].shape)) * 0.3).astype(
        np.float32)
    pos = rng.integers(0, 40, B).astype(np.int32)
    valid = np.asarray([4, 2, 1, 0], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    tcache = {"conv": torch.from_numpy(conv).to(cfg.torch_dtype),
              "ssm": torch.from_numpy(ssm), "pos": torch.from_numpy(pos)}
    jcache = {"conv": jnp.asarray(conv, dtype), "ssm": jnp.asarray(ssm),
              "pos": jnp.asarray(pos)}
    jl, jc = jmodel.decode_chunk(jparams, jnp.asarray(toks),
                                 jnp.asarray(valid), jcache)
    tl, tc = tmodel.decode_chunk(tparams, torch.from_numpy(toks),
                                 torch.from_numpy(valid), dict(tcache))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for key in ("conv", "ssm"):
        _close(tc[key], jc[key], dtype)
        assert torch.equal(tc[key][:, 3], tcache[key][:, 3])
    for b in range(3):
        k = int(valid[b])
        _close(tl[b, :k], np.asarray(jl, np.float32)[b, :k], dtype)


def test_prefill_equals_the_recurrence():
    """The dual-form invariant within the port (float32): the chunked
    prefill's last logits and state equal those of ``decode_chunk`` fed the
    same prompt from a zero state."""
    _, tcfg = _cfgs()
    model = build_model(tcfg)
    params = model.init(torch.Generator().manual_seed(2), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 512, (2, 29)))
    logits, cache = model.prefill(params, {"tokens": toks})
    step_logits, scache = model.decode_chunk(
        params, toks, torch.full((2,), 29, dtype=torch.int32),
        model.init_cache(2, 64, device="cpu"))
    np.testing.assert_allclose(step_logits[:, -1].numpy(), logits.numpy(),
                               rtol=1e-4, atol=1e-4)
    for key in ("conv", "ssm", "pos"):
        np.testing.assert_allclose(scache[key].float().numpy(),
                                   cache[key].float().numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_build_model_takes_ssm_and_refuses_hybrid():
    _, tcfg = _cfgs()
    model = build_model(tcfg)
    assert model.decode_chunk_paged is None
    assert set(model.init_cache(2, 16, device="cpu")) == {"conv", "ssm",
                                                          "pos"}
    # the hybrid is served (tests/test_torch_rglru.py), and so is the vlm
    # (tests/test_torch_vlm_audio.py): an engine over phi-3-vision's smoke
    # config takes a request with an image prefix
    vcfg = rt.get_smoke_config("phi_3_vision_4_2b")
    vmodel = build_model(vcfg)
    engine = TEngine(vmodel, vmodel.init(torch.Generator(), device="cpu"),
                     max_batch=2, max_seq=64, page_size=8, device="cpu")
    image = np.zeros((vcfg.n_image_tokens, vcfg.d_model), np.float32)
    req = engine.generate(list(range(1, 6)), session_id="v",
                          sampling=TSampling(max_new_tokens=3),
                          image_embeds=image)
    assert len(req.generated) == 3 and req.decode_path == "paged"
    assert engine.pool.session("v").tokens == vcfg.n_image_tokens + 16 + 2


def test_ssm_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = rt.build_model(rt.get_smoke_config(ARCH))
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_cache(1, 16)
    params = model.init(torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.InferenceEngine(model, params, max_batch=1, max_seq=16)


# ------------------------------------------------------------------- pool
def test_state_cache_pool_semantics():
    """The same operations on both pools leave the same sessions."""
    _, tcfg = _cfgs()
    jcfg = jcfgs.get_smoke_config("mamba2_130m")
    pools = (JPool(jcfg), StateCachePool(tcfg))
    for pool in pools:
        for i, sid in enumerate(("a", "b", "c", "d")):
            pool.store(sid, {"ssm": i}, 10 + i)
        pool.store("a", {"ssm": 9}, 30)          # a re-store replaces
        pool.on_hint("b", "drop")
        pool.on_hint("c", "migrate_out")
        pool.on_hint("d", "retain")              # other hints keep it
        pool.release("missing")
        assert pool.import_session("e", pool.export_session("a"))
    states = [{sid: p.load(sid) for sid in "abcde"} for p in pools]
    assert states[0] == states[1] == {"a": ({"ssm": 9}, 30), "b": None,
                                      "c": None, "d": ({"ssm": 3}, 13),
                                      "e": ({"ssm": 9}, 30)}
    assert pools[1].export_session("b") is None


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return (jcfg, jparams, tcfg,
            params_from_numpy(jax.device_get(jparams), device="cpu"))


def _warm(engine):
    rng = np.random.default_rng(2)
    base = [int(t) for t in rng.integers(0, 512, 21)]
    return [engine.warm_session(sid, toks) for sid, toks in
            (("w1", base), ("w2", base + [int(t) for t in
                                          rng.integers(0, 512, 40)]),
             ("a", base[:5]))]


def _sessions(engine, named):
    """The pool's sessions whose ids the trace named: {sid: (tokens,
    {leaf: float32 numpy})}."""
    out = {}
    for sid in named:
        got = engine.pool.load(sid)
        if got is not None:
            state, tokens = got
            out[sid] = (tokens, {k: _np(v) for k, v in state.items()})
    return out


@pytest.mark.parametrize("prefill_chunk", [8, 0])
def test_engine_matches_the_reference(weights, prefill_chunk):
    """The trace of ``test_torch_engine`` (sessions with follow-up turns,
    more requests than slots), then ``warm_session`` replays: the same
    greedy tokens, counters and warm results, the same sessions in the
    pool with the same token counts, and their state rows within 2e-5."""
    jcfg, jparams, tcfg, tparams = weights
    kw = dict(ENGINE_KW, prefill_chunk=prefill_chunk)
    jeng = JEngine(jax_build_model(jcfg), jparams, **kw)
    teng = TEngine(build_model(tcfg), tparams, device="cpu", **kw)
    waves = _trace(1)
    n = ssd_ops.ssd_chunk_scan.launches
    want = _serve(jeng, JRequest, JSampling, waves)
    got = _serve(teng, TRequest, TSampling, waves)
    assert got == want
    assert _warm(teng) == _warm(jeng)
    assert _counters(teng) == _counters(jeng)
    assert ssd_ops.ssd_chunk_scan.launches == n
    named = [sid for wave in waves for sid, _, _ in wave if sid] + [
        "w1", "w2"]
    jpool, tpool = _sessions(jeng, named), _sessions(teng, named)
    assert sorted(tpool) == sorted(jpool) and len(tpool) == 8
    assert len(teng.pool._states) == len(jeng.pool._states)
    for sid, (tokens, state) in jpool.items():
        assert tpool[sid][0] == tokens
        assert sorted(tpool[sid][1]) == sorted(state) == ["conv", "pos",
                                                          "ssm"]
        for key, v in state.items():
            np.testing.assert_allclose(tpool[sid][1][key], v, **F32_TOL)
    tel = teng.telemetry()
    assert tel["paged_decode"] is False and tel["prefix_sharing"] == {}
    assert teng.metrics.prefix_hits == 0      # resumes prefill cold
    assert teng.metrics.completed == len(got)


def test_fused_step_equals_the_masked_step(weights):
    """The reference's ``test_recurrent_fused_chunk_matches_masked`` on
    both packages: the fused ``decode_chunk`` step and the per-token
    masked ``decode_step`` fallback give the same greedy tokens."""
    jcfg, jparams, tcfg, tparams = weights
    kw = dict(ENGINE_KW, prefill_chunk=4)
    model = build_model(tcfg)
    outs = {}
    for fused in (False, True):
        jeng = JEngine(jax_build_model(jcfg), jparams, **kw)
        teng = TEngine(model if fused else
                       dataclasses.replace(model, decode_chunk=None),
                       tparams, device="cpu", **kw)
        if not fused:
            jeng._decode_chunk = None             # force the masked path
        for name, eng, req, sp in (("jax", jeng, JRequest, JSampling),
                                   ("torch", teng, TRequest, TSampling)):
            reqs = [req.make(list(range(1 + i, 14 + 3 * i)),
                             session_id=f"r{i}",
                             sampling=sp(max_new_tokens=6))
                    for i in range(4)]
            for r in reqs:
                eng.submit(r)
            eng.run_until_idle()
            outs[name, fused] = [list(map(int, r.generated)) for r in reqs]
            assert all(r.decode_path == ("fused" if fused else "masked")
                       for r in reqs)
    assert outs["torch", True] == outs["torch", False] \
        == outs["jax", False] == outs["jax", True]


def test_sessions_move_between_engines(weights):
    """``warm_session`` then ``export_session`` -> ``import_session`` on a
    second engine: the same state row and token count, held in tensors of
    its own: an in-place change to the exporter's row leaves the imported
    one as it was."""
    _, _, tcfg, tparams = weights
    model = build_model(tcfg)
    src, dst = (TEngine(model, tparams, device="cpu", **ENGINE_KW)
                for _ in range(2))
    assert src.warm_session("m", list(range(1, 30))) == 32
    payload = src.pool.export_session("m")
    assert dst.pool.import_session("m", payload)
    state, tokens = dst.pool.load("m")
    assert tokens == 32 and int(state["pos"][0]) == 32
    assert set(state) == set(payload[0])
    before = {k: v.clone() for k, v in payload[0].items()}
    for k, v in state.items():
        assert v.data_ptr() != payload[0][k].data_ptr()
        assert torch.equal(v, before[k])
    assert bool(before["ssm"].abs().sum() > 0)
    src.generate([3, 4, 5], session_id="other",
                 sampling=TSampling(max_new_tokens=2))
    for v in payload[0].values():
        v.add_(1)
    for k, v in dst.pool.load("m")[0].items():
        assert torch.equal(v, before[k])
