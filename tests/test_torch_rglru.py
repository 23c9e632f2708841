"""The port's hybrid family (recurrentgemma) and its state-cache engine
against the JAX package's, on the CPU.

What is held against the reference, with inputs from numpy seeds:

* the RG-LRU scan's plain version (``rglru_scan_ref``, and the wrapper
  ``rglru_scan``, which takes it for a CPU tensor) against the reference's
  associative ``rglru_scan_ref`` and its Pallas ``rglru_scan_blocked`` in
  interpret mode, float32, on the reference's own sweep plus a ragged
  sequence and width and a single step, with and without h0: within 1e-5
  of the largest reference value (the same recurrence summed in another
  order);
* the recurrentgemma smoke model (3 layers, d_model 128, window 32),
  float32 and bf16, with the reference's weights
  (``interop.params_from_numpy``): the parameter tree, the gates, the
  recurrent block in both modes, ``init_cache``, ``prefill`` (with
  ``pad_cache_to``, prompts below and above the window), ``decode_step``
  across a ring wrap, and ``decode_chunk`` with ragged ``valid_len``.
  float32 2e-4 (the bound of the reference's own pallas-vs-xla decode
  test); bf16 3e-2 of the largest reference value (bf16 rounds every
  activation, at places the two frameworks choose differently);
* the engine with ``prefill_chunk`` 8 and 0, ``max_seq`` at and above the
  window (a ring that wraps), and ``warm_session``: greedy tokens,
  ``EngineMetrics`` counters, warm results, the pool's sessions, token
  counts and leaf shapes identical, and every stored row (conv, h, the K/V
  rings, pos) within 1e-4 (float32 through ~50 steps of two frameworks'
  matrix products); the fused step gives the per-token masked step's
  tokens, as the reference pins.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
from repro.kernels.rglru_scan.ref import \
    rglru_scan_ref as jax_scan_ref  # noqa: E402
from repro.kernels.rglru_scan.rglru_scan import \
    rglru_scan_blocked  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.batching import Request as JRequest  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.sampler import SamplingParams as JSampling  # noqa: E402
import repro_torch as rt  # noqa: E402
import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.transformer import _layer  # noqa: E402
from repro_torch.serving.batching import Request as TRequest  # noqa: E402
from repro_torch.serving.engine import InferenceEngine as TEngine  # noqa: E402
from repro_torch.serving.sampler import \
    SamplingParams as TSampling  # noqa: E402

from _torch_cases import RGLRU_CASES, rglru_case  # noqa: E402
from test_torch_engine import _counters, _serve, _trace  # noqa: E402

ARCH = "recurrentgemma-9b"
SCAN_REL_TOL = 1e-5
MODEL_TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": 3e-2}
POOL_TOL = dict(rtol=1e-4, atol=1e-4)
WINDOW = 32                                    # the smoke config's
ENGINE_KW = dict(max_batch=3, rng_seed=0)
KERNELS = (scan_ops.rglru_scan, flash_ops.flash_attention_bhsd,
           paged_ops.decode_attention_kernel)


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


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _launches():
    return [k.launches for k in KERNELS]


# ------------------------------------------------------------------ kernel
@pytest.mark.parametrize("case", RGLRU_CASES)
def test_plain_scan_matches_the_reference_scans(case):
    seed, B, S, W, init = case
    a, b, h0 = rglru_case(seed, B, S, W, init)
    th0 = None if h0 is None else torch.from_numpy(h0)
    jh0 = None if h0 is None else jnp.asarray(h0)
    n = scan_ops.rglru_scan.launches
    y, last = scan_ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                                  th0)
    assert scan_ops.rglru_scan.launches == n    # the CPU runs no kernel
    assert y.dtype == last.dtype == torch.float32
    assert torch.equal(last, y[:, -1])
    want = jax_scan_ref(jnp.asarray(a), jnp.asarray(b), jh0)
    assert _rel(y, want) <= SCAN_REL_TOL
    pallas = rglru_scan_blocked(jnp.asarray(a), jnp.asarray(b), jh0,
                                interpret=True)
    assert _rel(y, pallas) <= SCAN_REL_TOL


def test_plain_scan_edges():
    """No steps returns h0 (or zeros); a zero state is the same as none;
    h0 enters as the reference folds it, a_0 * h0 added to b_0."""
    a, b, h0 = (torch.from_numpy(x) for x in rglru_case(7, 2, 5, 8, True))
    y, last = rglru_scan_ref(a[:, :0], b[:, :0], h0)
    assert y.shape == (2, 0, 8) and torch.equal(last, h0)
    assert torch.equal(rglru_scan_ref(a, b)[0],
                       rglru_scan_ref(a, b, torch.zeros(2, 8))[0])
    folded = b.clone()
    folded[:, 0] += a[:, 0] * h0
    assert torch.equal(rglru_scan_ref(a, b, h0)[0],
                       rglru_scan_ref(a, folded)[0])


def test_scan_checks_the_layout_on_every_device():
    a, b, h0 = (torch.from_numpy(x) for x in rglru_case(8, 2, 6, 8, True))
    scan = scan_ops.rglru_scan
    with pytest.raises(ValueError, match="must both be"):
        scan(a, b[:, :3])
    with pytest.raises(ValueError, match="h0 must be"):
        scan(a, b, h0[:1])
    with pytest.raises(ValueError, match="contiguous float32"):
        scan(a.bfloat16(), b.bfloat16())
    with pytest.raises(ValueError, match="contiguous float32"):
        scan(a.transpose(1, 2).contiguous().transpose(1, 2), b)
    with pytest.raises(ValueError, match="contiguous float32"):
        scan(a, b, h0.double())


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
            get_j("recurrentgemma_9b"))
    own = tmodel.init(torch.Generator().manual_seed(0), device="cpu")
    want = {k: (shape, "bfloat16" if "bfloat16" in str(dt) else dt)
            for k, (shape, dt) in _tree(jax.device_get(jparams)).items()}
    assert _tree(own) == want == _tree(tparams)
    for tree in (own, tparams):
        lam = tree["rec_layers"]["rglru"]["lam"]
        a = torch.sigmoid(lam)
        assert lam.dtype == torch.float32
        assert bool((a > 0.9 - 1e-6).all() and (a < 0.999 + 1e-6).all())
    np.testing.assert_array_equal(
        tparams["rec_layers"]["rglru"]["lam"].numpy(),
        np.asarray(jparams["rec_layers"]["rglru"]["lam"]))


def test_gates_and_recurrent_block_match(models):
    """Layer 0's gates, full-sequence block (with and without a carried
    state) and three single steps, against the reference's."""
    dtype, _, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    jcfg = jcfgs.get_smoke_config(ARCH).replace(dtype=dtype)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["rec_layers"])
    tp = _layer(tparams["rec_layers"], 0)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    tx, jx = torch.from_numpy(x).to(cfg.torch_dtype), jnp.asarray(x, dtype)
    for got, want in zip(TR._rglru_gates(tx, tp["rglru"]),
                         JR._rglru_gates(jx, jp["rglru"])):
        _close(got, want, "float32" if dtype == "float32" else dtype)
    h0 = (rng.standard_normal((2, cfg.rglru_width)) * 0.5).astype(np.float32)
    for th0, jh0 in ((None, None), (torch.from_numpy(h0), jnp.asarray(h0))):
        got = TR.recurrent_block(tx, tp, cfg, h_state=th0)
        want = JR.recurrent_block(jx, jp, jcfg, h_state=jh0)
        for g, w in zip(got, want):
            _close(g, w, dtype)
    tconv, jconv = got[1], want[1]
    th, jh = got[2], want[2]
    for t in range(3):
        tok = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        tout, tconv, th = TR.recurrent_block(
            torch.from_numpy(tok).to(cfg.torch_dtype), tp, cfg, tconv, th,
            single_step=True)
        jout, jconv, jh = JR.recurrent_block(
            jnp.asarray(tok, dtype), jp, jcfg, jconv, jh, single_step=True)
        for g, w in ((tout, jout), (tconv, jconv), (th, jh)):
            _close(g, w, dtype)


@pytest.mark.parametrize("S,pad", [(20, None), (20, 40), (45, 64)])
def test_prefill_and_decode_steps_wrap_the_ring(models, S, pad):
    """Prompts below and above the window, with and without decode
    headroom, then decode_steps until the ring has wrapped (pos past the
    window): logits and every cache leaf along the way."""
    dtype, jmodel, jparams, tmodel, tparams = models
    toks = np.random.default_rng(S).integers(0, 512, (2, S)).astype(np.int32)
    kw = {} if pad is None else dict(pad_cache_to=pad)
    before = _launches()
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, **kw)
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)}, **kw)
    assert _launches() == before
    assert tc["h"].dtype == torch.float32
    assert tc["k"].dtype == tc["conv"].dtype == getattr(torch, dtype)
    jstep = jax.jit(jmodel.decode_step)
    steps = max(WINDOW + 6 - S, 8)
    for step in range(steps):
        if step:
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            jl, jc = jstep(jparams, jnp.asarray(tok), jc)
            old = {k: v.clone() for k, v in tc.items()}
            tl, tc = tmodel.decode_step(tparams, torch.from_numpy(tok), tc)
            # decode_step returns a new cache and leaves the old one be
            assert all(torch.equal(old[k], v) for k, v in old.items())
        if step % 4 == 0 or step == steps - 1:
            _close(tl, jl, dtype)
            for key in ("conv", "h", "k", "v"):
                _close(tc[key], jc[key], dtype)
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))
    assert int(tc["pos"][0]) > WINDOW + 4


def test_decode_chunk_masks_rows(models):
    """A random state over a wrapped ring, valid lengths 4, 2, 1 and 0: the
    logits of every valid position and the new cache; the idle row keeps
    every leaf and its position bitwise."""
    dtype, jmodel, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    rng = np.random.default_rng(6)
    B, T = 4, 4
    cache = tmodel.init_cache(B, 64, device="cpu")
    arrs = {k: (rng.standard_normal(tuple(v.shape)) * 0.5).astype(np.float32)
            for k, v in cache.items() if k != "pos"}
    arrs["pos"] = np.asarray([3, 40, 77, 31], np.int32)
    valid = np.asarray([4, 2, 1, 0], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    tcache = {k: torch.from_numpy(v).to(cache[k].dtype)
              for k, v in arrs.items()}
    jcache = {k: jnp.asarray(v, "float32" if k == "h" else
                             ("int32" if k == "pos" else dtype))
              for k, v in arrs.items()}
    before = {k: v.clone() for k, v in tcache.items()}
    jl, jc = jmodel.decode_chunk(jparams, jnp.asarray(toks),
                                 jnp.asarray(valid), jcache)
    tl, tc = tmodel.decode_chunk(tparams, torch.from_numpy(toks),
                                 torch.from_numpy(valid), dict(tcache))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for key in ("conv", "h", "k", "v"):
        _close(tc[key], jc[key], dtype)
        assert torch.equal(tc[key][:, 3], before[key][:, 3])
    for b in range(3):
        k = int(valid[b])
        _close(tl[b, :k], np.asarray(jl, np.float32)[b, :k], dtype)


def test_prefill_equals_the_recurrence():
    """Within the port (float32): the prefill's last logits and state equal
    those of ``decode_chunk`` fed the same prompt from a zero state, below
    and past the window."""
    _, tcfg = _cfgs()
    model = build_model(tcfg)
    params = model.init(torch.Generator().manual_seed(2), device="cpu")
    for S in (29, 45):
        toks = torch.from_numpy(np.random.default_rng(S).integers(
            0, 512, (2, S)))
        logits, cache = model.prefill(params, {"tokens": toks},
                                      pad_cache_to=WINDOW)
        step_logits, scache = model.decode_chunk(
            params, toks, torch.full((2,), S, dtype=torch.int32),
            model.init_cache(2, WINDOW, device="cpu"))
        np.testing.assert_allclose(step_logits[:, -1].numpy(),
                                   logits.numpy(), rtol=1e-4, atol=1e-4)
        for key in ("conv", "h", "k", "v", "pos"):
            np.testing.assert_allclose(scache[key].float().numpy(),
                                       cache[key].float().numpy(), rtol=1e-4,
                                       atol=1e-4)


def test_init_cache_and_build_model():
    jcfg, tcfg = _cfgs()
    model = build_model(tcfg)
    assert model.decode_chunk_paged is None
    for max_seq in (16, 96):
        got = model.init_cache(3, max_seq, device="cpu")
        want = JR.init_cache(jcfg, 3, max_seq)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert tuple(got[k].shape) == v.shape
            assert not bool(got[k].any())
    assert TR._group_layout(tcfg) == JR._group_layout(jcfg) == (2, 1, 0)
    full = tcfgs.get_config(ARCH)
    assert TR._layer_kinds(full) == JR._layer_kinds(jcfgs.get_config(ARCH))
    assert TR._group_layout(full) == (2, 12, 2)
    with pytest.raises(NotImplementedError, match="A14"):
        TR.forward(None, tcfg, None)


def test_hybrid_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = rt.build_model(rt.get_smoke_config(ARCH))
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_cache(1, 16)
    params = model.init(torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.InferenceEngine(model, params, max_batch=1, max_seq=16)


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


@pytest.mark.parametrize("prefill_chunk,max_seq", [(8, 96), (0, 96),
                                                   (8, WINDOW)])
def test_engine_matches_the_reference(weights, prefill_chunk, max_seq):
    """The trace of ``test_torch_engine`` (sessions with follow-up turns,
    more requests than slots), then ``warm_session`` replays: the same
    greedy tokens, counters and warm results, the same sessions in the
    pool with the same token counts and leaf shapes, their rows within
    1e-4.  With ``max_seq`` above the window the slot cache is a ring that
    wraps (monolithic buckets of 64 roll it too); at the window it never
    does.  The left-padded buckets of ``prefill_chunk=0`` put pad tokens
    into the recurrence and the window on both packages."""
    jcfg, jparams, tcfg, tparams = weights
    kw = dict(ENGINE_KW, prefill_chunk=prefill_chunk, max_seq=max_seq)
    jeng = JEngine(jax_build_model(jcfg), jparams, **kw)
    teng = TEngine(build_model(tcfg), tparams, device="cpu", **kw)
    waves = _trace(1)
    before = _launches()
    want = _serve(jeng, JRequest, JSampling, waves)
    got = _serve(teng, TRequest, TSampling, waves)
    assert got == want
    assert _warm(teng) == _warm(jeng)
    assert _counters(teng) == _counters(jeng)
    assert _launches() == before
    named = [sid for wave in waves for sid, _, _ in wave if sid] + [
        "w1", "w2"]
    jpool, tpool = _sessions(jeng, named), _sessions(teng, named)
    assert sorted(tpool) == sorted(jpool) and len(tpool) == 8
    assert len(teng.pool._states) == len(jeng.pool._states)
    for sid, (tokens, state) in jpool.items():
        assert tpool[sid][0] == tokens
        assert sorted(tpool[sid][1]) == sorted(state) == ["conv", "h", "k",
                                                          "pos", "v"]
        for key, v in state.items():
            np.testing.assert_allclose(tpool[sid][1][key], v, **POOL_TOL)
    assert teng.cache["k"].shape[2] == min(WINDOW, max_seq)
    tel = teng.telemetry()
    assert tel["paged_decode"] is False and tel["prefix_sharing"] == {}
    assert teng.metrics.prefix_hits == 0      # resumes prefill cold
    assert teng.metrics.completed == len(got)


def test_fused_step_equals_the_masked_step(weights):
    """The reference's ``test_recurrent_fused_chunk_matches_masked`` on
    both packages: the fused ``decode_chunk`` step and the per-token
    masked ``decode_step`` fallback give the same greedy tokens; with
    ``max_seq`` above the window the ring wraps."""
    jcfg, jparams, tcfg, tparams = weights
    kw = dict(ENGINE_KW, prefill_chunk=4, max_seq=64)
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
            reqs = [req.make(list(range(1 + i, 24 + 5 * i)),
                             session_id=f"r{i}",
                             sampling=sp(max_new_tokens=10))
                    for i in range(4)]
            for r in reqs:
                eng.submit(r)
            eng.run_until_idle()
            outs[name, fused] = [list(map(int, r.generated)) for r in reqs]
            assert all(r.decode_path == ("dense-ring" if fused else "masked")
                       for r in reqs)
    assert outs["torch", True] == outs["torch", False] \
        == outs["jax", False] == outs["jax", True]


def test_sessions_move_between_engines(weights):
    """``warm_session`` then ``export_session`` -> ``import_session`` on a
    second engine: the same row (conv, h, the K/V rings, pos) and token
    count, held in tensors of its own: an in-place change to the
    exporter's row leaves the imported one as it was."""
    _, _, tcfg, tparams = weights
    model = build_model(tcfg)
    src, dst = (TEngine(model, tparams, device="cpu", max_seq=64,
                        **ENGINE_KW) for _ in range(2))
    assert src.warm_session("m", list(range(1, 40))) == 64
    payload = src.pool.export_session("m")
    assert dst.pool.import_session("m", payload)
    state, tokens = dst.pool.load("m")
    assert tokens == 64 and int(state["pos"][0]) == 64
    assert sorted(state) == ["conv", "h", "k", "pos", "v"]
    assert state["k"].shape[2] == WINDOW
    before = {k: v.clone() for k, v in payload[0].items()}
    for k, v in state.items():
        assert v.data_ptr() != payload[0][k].data_ptr()
        assert torch.equal(v, before[k])
    assert bool(before["h"].abs().sum() > 0)
    assert bool(before["k"].abs().sum() > 0)
    src.generate([3, 4, 5], session_id="other",
                 sampling=TSampling(max_new_tokens=2))
    for v in payload[0].values():
        v.add_(1)
    for k, v in dst.pool.load("m")[0].items():
        assert torch.equal(v, before[k])
