"""The port's MoE family against the JAX package's, on the CPU.

What is held against the reference, with inputs from numpy seeds:

* the grouped expert-FFN kernel's plain version (``moe_ffn_ref``, and the
  wrapper ``moe_ffn``, which takes it for a CPU tensor) against the Pallas
  ``moe_ffn`` in interpret mode, on the reference's own sweep, with
  contiguous and expanded (stride-0 over the experts) capacity buffers, at
  the reference sweep's tolerance (2e-5 in float32, 3e-2 in bf16: both
  sides round the output to bf16 once);
* routing (gates and indices, with constructed ties, which ``lax.top_k``
  breaks lower index first) and ``moe_block(impl="dropless")``: 2e-5;
* the granite-moe and qwen3-moe smoke models in float32 with the
  reference's weights (``interop.params_from_numpy``): ``prefill``,
  ``decode_chunk_paged`` over a chunked prompt, ``prefill(pad_cache_to)`` +
  three ``decode_step``s, and ``decode_chunk``: logits and caches 2e-4, the
  bound of the reference's own pallas-vs-xla decode test;
* the engine on a granite smoke trace, paged and dense planes: greedy
  tokens, ``EngineMetrics`` counters, ``pool.stats`` and free pages bitwise;
  and, within the port, a prefix hit equals a cold chunked prefill bitwise
  (the reference's ``test_prefix_hit_matches_cold_prefill_chunked``).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
from repro.kernels.moe_ffn.ops import moe_ffn_fused  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.batching import Request as JRequest  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.sampler import SamplingParams as JSampling  # noqa: E402
import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels.moe_ffn import ops as moe_ops  # noqa: E402
from repro_torch.kernels.moe_ffn.ref import moe_ffn_ref  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.batching import Request as TRequest  # noqa: E402
from repro_torch.serving.engine import InferenceEngine as TEngine  # noqa: E402
from repro_torch.serving.sampler import \
    SamplingParams as TSampling  # noqa: E402

from _torch_cases import MOE_CASES, moe_case  # noqa: E402
from test_torch_dense_plane import _warm  # noqa: E402
from test_torch_engine import (_counters, _pool_state, _serve,  # noqa: E402
                               _trace)

GRANITE = "granite-moe-1b-a400m"
QWEN_MOE = "qwen3-moe-235b-a22b"
KERNEL_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
              "bfloat16": dict(rtol=3e-2, atol=3e-2)}
ROUTE_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=2e-4, atol=2e-4)
ENGINE_KW = dict(max_batch=3, max_seq=96, page_size=8, rng_seed=0)


def _cfgs(arch, dtype="float32"):
    return (jcfgs.get_smoke_config(arch).replace(dtype=dtype),
            tcfgs.get_smoke_config(arch).replace(dtype=dtype))


@pytest.fixture(scope="module", params=[GRANITE, QWEN_MOE])
def models(request):
    jcfg, tcfg = _cfgs(request.param)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    return jmodel, jparams, build_model(tcfg), tparams


# ------------------------------------------------------------------ kernel
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("expanded", [False, True])
@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_ffn_plain_matches_pallas(case, expanded, dtype):
    """The 64-row (block_c) and 64/32-column (block_f) tiles of the
    reference sweep, so the interpreted kernel pads C and F."""
    seed, E, C, D, F = case
    xe, wg, wu, wd = moe_case(seed, E, C, D, F)
    if expanded:          # one [C,D] block seen by every expert
        xe = np.broadcast_to(xe[:1], xe.shape)
    bf = 64 if F % 64 == 0 else 32
    want = moe_ffn_fused(*(jnp.asarray(a, dtype) for a in (xe, wg, wu, wd)),
                         block_c=64, block_f=bf)
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy((xe[:1] if expanded else xe).copy())
    tx = tx.to(tdt)
    if expanded:
        tx = tx.expand(E, C, D)
    tw = [torch.from_numpy(a).to(tdt) for a in (wg, wu, wd)]
    n = moe_ops.moe_ffn.launches
    got = moe_ops.moe_ffn(tx, *tw)
    assert moe_ops.moe_ffn.launches == n          # the CPU runs no kernel
    assert got.dtype == tdt and tuple(got.shape) == (E, C, D)
    assert torch.equal(got, moe_ffn_ref(tx, *tw))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **KERNEL_TOL[dtype])


def test_moe_ffn_checks_the_layout_on_every_device():
    xe, wg, wu, wd = (torch.from_numpy(a) for a in moe_case(3, 2, 5, 16, 8))
    with pytest.raises(ValueError, match="does not match"):
        moe_ops.moe_ffn(xe, wg, wu, wd[:, :4].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        moe_ops.moe_ffn(xe, wg.transpose(1, 2).contiguous().transpose(1, 2),
                        wu, wd)
    with pytest.raises(ValueError, match="expert stride"):
        moe_ops.moe_ffn(xe.transpose(0, 1).contiguous().transpose(0, 1),
                        wg, wu, wd)
    with pytest.raises(ValueError, match="bf16 or f32"):
        moe_ops.moe_ffn(xe.half(), wg.half(), wu.half(), wd.half())
    with pytest.raises(ValueError, match="share one type"):
        moe_ops.moe_ffn(xe, wg.bfloat16(), wu, wd)


# ----------------------------------------------------------------- routing
def _route_both(xg, router, arch):
    jcfg, tcfg = _cfgs(arch)
    jg, ji, jp = JM._route(jnp.asarray(xg), jnp.asarray(router), jcfg)
    tg, ti, tp = TM._route(torch.from_numpy(xg), torch.from_numpy(router),
                           tcfg)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **ROUTE_TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **ROUTE_TOL)
    return ti.numpy()


def test_route_matches_the_reference_with_random_logits():
    rng = np.random.default_rng(0)
    D = 16
    jcfg, tcfg = jcfgs.get_config(GRANITE), tcfgs.get_config(GRANITE)
    xg = rng.standard_normal((9, D)).astype(np.float32)   # 32 experts, top-8
    router = rng.standard_normal((D, tcfg.n_experts)).astype(np.float32)
    jg, ji, _ = JM._route(jnp.asarray(xg), jnp.asarray(router), jcfg)
    tg, ti, _ = TM._route(torch.from_numpy(xg), torch.from_numpy(router),
                          tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **ROUTE_TOL)


def test_route_breaks_ties_lower_index_first():
    """Router columns 1 and 3 are equal and the largest, 0 and 2 equal and
    the next: every token's probabilities tie in pairs, and top-2 must be
    (1, 3), never (3, 1); with column 1 lowered, the tie at the k boundary
    must keep expert 0 and drop expert 2."""
    rng = np.random.default_rng(1)
    D = 128
    xg = np.abs(rng.standard_normal((6, D))).astype(np.float32)
    base = np.abs(rng.standard_normal(D)).astype(np.float32) * 0.05
    router = np.stack([base, 2 * base, base, 2 * base], axis=1)
    idx = _route_both(xg, router, GRANITE)
    assert (idx == [1, 3]).all()
    router[:, 1] = 0.0
    idx = _route_both(xg, router, GRANITE)
    assert (idx == [3, 0]).all()


@pytest.mark.parametrize("arch", [GRANITE, QWEN_MOE])
def test_moe_block_dropless_matches(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = JM.init_moe_layer(jax.random.PRNGKey(3), jcfg)
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    x = np.random.default_rng(2).standard_normal(
        (2, 7, jcfg.d_model)).astype(np.float32)
    jy, jaux, jcounts = JM.moe_block(jnp.asarray(x), jp, jcfg,
                                     impl="dropless")
    ty, taux, tcounts = TM.moe_block(torch.from_numpy(x), tp, tcfg,
                                     impl="dropless")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **ROUTE_TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **ROUTE_TOL)
    assert tcounts.dtype == torch.int32
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    # the capacity dispatch (training's default impl) is ported too
    jy, jaux, jcounts = JM.moe_block(jnp.asarray(x), jp, jcfg,
                                     impl="einsum")
    ty, taux, tcounts = TM.moe_block(torch.from_numpy(x), tp, tcfg,
                                     impl="einsum")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **ROUTE_TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **ROUTE_TOL)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))


def test_params_from_numpy_keeps_the_f32_router_of_a_bf16_model():
    jcfg, tcfg = _cfgs(GRANITE, dtype="bfloat16")
    host = jax.device_get(jax_build_model(jcfg).init(jax.random.PRNGKey(4)))
    got = params_from_numpy(host, device="cpu")["layers"]["mlp"]
    want = host["layers"]["mlp"]
    assert got["router"].dtype == torch.float32
    np.testing.assert_array_equal(got["router"].numpy(), want["router"])
    for key in ("w_gate", "w_up", "w_down"):
        assert got[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(got[key].float().numpy(),
                                      np.asarray(want[key], np.float32))
    # and the port's own init draws the same tree, types and shapes
    own = build_model(tcfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")["layers"]["mlp"]
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in got.items()}


# ------------------------------------------------------------------- model
def test_prefill_logits_and_cache_match(models):
    jmodel, jparams, tmodel, tparams = models
    toks = np.random.default_rng(1).integers(0, 512, (2, 19)).astype(
        np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL)


def test_decode_chunk_paged_over_a_chunked_prompt(models):
    """Two sequences prefilled 4 tokens per step straight into the pages
    (permuted tables), the second one stopping a chunk early, then one
    decode token each: logits and pages after every step."""
    jmodel, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    rng = np.random.default_rng(5)
    P, n_pages, max_seq, T = 8, 12, 40, 4
    shape = (cfg.n_layers, n_pages, P, cfg.n_kv_heads, cfg.head_dim_)
    kp = np.zeros(shape, np.float32)
    vp = np.zeros(shape, np.float32)
    pt = np.full((2, max_seq // P), -1, np.int32)
    pt[0, :3] = [7, 2, 9]
    pt[1, :2] = [4, 0]
    prompt = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    pos = np.zeros(2, np.int32)
    steps = [(prompt[:, 0:4], [4, 4]), (prompt[:, 4:8], [4, 4]),
             (prompt[:, 8:12], [4, 0]),
             ((prompt[:, :1] + 1) % cfg.vocab_size, [1, 1])]
    for toks, valid in steps:
        toks = np.pad(toks, ((0, 0), (0, T - toks.shape[1])))
        valid = np.asarray(valid, np.int32)
        jl, jcache, jk, jv = jmodel.decode_chunk_paged(
            jparams, jnp.asarray(toks), jnp.asarray(valid),
            {"pos": jnp.asarray(pos)}, jk, jv, jnp.asarray(pt),
            max_seq=max_seq)
        tl, tcache, _, _ = tmodel.decode_chunk_paged(
            tparams, torch.from_numpy(toks), torch.from_numpy(valid),
            {"pos": torch.from_numpy(pos)}, tk, tv, torch.from_numpy(pt),
            max_seq=max_seq)
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
        for b in range(2):
            n = int(valid[b])
            np.testing.assert_allclose(tl[b, :n].numpy(),
                                       np.asarray(jl)[b, :n], **TOL)
        pos = tcache["pos"].numpy()


def test_prefill_and_decode_steps_match(models):
    jmodel, jparams, tmodel, tparams = models
    toks = np.random.default_rng(11).integers(0, 512, (2, 16)).astype(
        np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                            pad_cache_to=24)
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                            pad_cache_to=24)
    for step in range(4):
        if step:
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            jl, jc = jmodel.decode_step(jparams, jnp.asarray(tok), jc)
            tl, tc = tmodel.decode_step(tparams, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       **TOL)
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))


def test_decode_chunk_matches(models):
    """A random dense cache, ragged positions and valid lengths, one idle
    row."""
    jmodel, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    rng = np.random.default_rng(6)
    B, C, T = 4, 40, 4
    shape = (cfg.n_layers, B, C, cfg.n_kv_heads, cfg.head_dim_)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    pos = rng.integers(0, C - T - 1, B).astype(np.int32)
    valid = np.asarray([4, 2, 1, 0], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    jl, jc = jmodel.decode_chunk(
        jparams, jnp.asarray(toks), jnp.asarray(valid),
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv), "pos": jnp.asarray(pos)})
    tl, tc = tmodel.decode_chunk(
        tparams, torch.from_numpy(toks), torch.from_numpy(valid),
        {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy()),
         "pos": torch.from_numpy(pos)})
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL)
    for b in range(B):
        n = int(valid[b])
        np.testing.assert_allclose(tl[b, :n].numpy(), np.asarray(jl)[b, :n],
                                   **TOL)


def test_build_model_takes_moe_and_refuses_the_rest():
    cfg = tcfgs.get_smoke_config(GRANITE)
    assert build_model(cfg).cfg.family == "moe"
    # a layer-norm MoE is served too (A11): its norms carry "b" and its
    # experts keep the swiglu FFN (the reference's MoE has no gelu form)
    ln = build_model(cfg.replace(norm_type="layer"))
    params = ln.init(torch.Generator().manual_seed(0), device="cpu")
    assert set(params["layers"]["mlp_norm"]) == {"w", "b"}
    logits, _ = ln.prefill(params, {"tokens": torch.arange(1, 7)[None]})
    assert torch.isfinite(logits.float()).all()
    for fam in ("vlm", "audio"):
        assert build_model(cfg.replace(family=fam)).cfg.family == fam
    with pytest.raises(ValueError, match="family"):
        build_model(cfg.replace(family="encoder-only"))


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def granite():
    jcfg, tcfg = _cfgs(GRANITE)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return (jcfg, jparams, tcfg,
            params_from_numpy(jax.device_get(jparams), device="cpu"))


@pytest.mark.parametrize("paged,prefill_chunk", [(True, 4), (True, 0),
                                                 (False, 4)])
def test_engine_matches_the_reference(granite, paged, prefill_chunk):
    """The trace of ``test_torch_engine`` (resumed turns, a shared system
    prefix, an anonymous request, more requests than slots), then the
    ``warm_session`` replays of ``test_torch_dense_plane``, on both
    engines: the same greedy tokens, warm results, counters, pool stats
    and free pages."""
    jcfg, jparams, tcfg, tparams = granite
    kw = dict(ENGINE_KW, prefill_chunk=prefill_chunk, paged_decode=paged)
    jeng = JEngine(jax_build_model(jcfg), jparams, **kw)
    teng = TEngine(build_model(tcfg), tparams, device="cpu", **kw)
    waves = _trace(1)
    want = _serve(jeng, JRequest, JSampling, waves)
    got = _serve(teng, TRequest, TSampling, waves)
    assert got == want
    assert _warm(teng) == _warm(jeng)
    assert _counters(teng) == _counters(jeng)
    assert _pool_state(teng) == _pool_state(jeng)
    m = teng.metrics
    assert m.prefix_hits > 0
    assert teng.telemetry()["paged_decode"] is paged
    teng.pool.check_invariants()


def _gather_bytes(engine, sid):
    k, v, tokens = engine.pool.gather_contiguous(sid, engine.max_seq)
    return k[:, :tokens], v[:, :tokens], tokens


def test_prefix_hit_matches_cold_prefill_chunked():
    """The reference's ``test_prefix_hit_matches_cold_prefill_chunked`` for
    granite-moe, within the port (bf16, the smoke config's own type): a
    session whose 64-token system prompt another session left resident
    prefills only its suffix, and gets the cold prefill's greedy tokens
    and cache bytes, bitwise."""
    cfg = tcfgs.get_smoke_config(GRANITE)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    sysp = list(range(1, 65))                    # 64 tokens == one page
    suf_donor = [(100 + i) % cfg.vocab_size for i in range(8)]
    suf = [(200 + i) % cfg.vocab_size for i in range(8)]
    sp = TSampling(max_new_tokens=4)
    kw = dict(max_batch=2, max_seq=128, prefill_chunk=8, device="cpu")

    cold = TEngine(model, params, **kw)
    r_cold = cold.generate(sysp + suf, session_id="x", sampling=sp)

    shared = TEngine(model, params, **kw)
    shared.generate(sysp + suf_donor, session_id="donor", sampling=sp)
    pt0 = shared.metrics.prefill_tokens
    r_hit = shared.generate(sysp + suf, session_id="x", sampling=sp)

    assert shared.metrics.shared_prefix_hits == 1
    assert shared.metrics.shared_prefix_tokens == 64
    assert shared.metrics.prefill_tokens - pt0 < len(sysp)
    assert r_hit.prefix_reused_tokens == 64
    assert r_hit.generated == r_cold.generated
    kc, vc, tc = _gather_bytes(cold, "x")
    ks, vs, ts = _gather_bytes(shared, "x")
    assert tc == ts
    assert torch.equal(ks, kc) and torch.equal(vs, vc)


def test_dense_plane_gives_the_paged_planes_tokens(granite):
    """Within the port: the dense plane serves a trace with the paged
    plane's greedy tokens."""
    _, _, tcfg, tparams = granite
    toks = [_serve(TEngine(build_model(tcfg), tparams, device="cpu",
                           paged_decode=paged, prefill_chunk=4, **ENGINE_KW),
                   TRequest, TSampling, _trace(3))
            for paged in (True, False)]
    assert toks[0] == toks[1]
