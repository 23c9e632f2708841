"""The port's dense slot-cache plane against the JAX package's.

The dense plane is ``init_cache`` + ``prefill(pad_cache_to=...)`` +
``decode_step`` (whose attention is the ring-decode kernel) and
``decode_chunk`` (the engine's ``paged_decode=False`` step), with
sliding-window rings.  On the CPU the port runs the ring kernel's plain
version; the JAX side runs its Pallas kernel in interpret mode (or its XLA
path).  Inputs come from numpy seeds; the models are the qwen3-0.6b smoke
config in float32, plain and with ``sliding_window=16`` so that the ring
wraps.

Tolerances: the ring kernel's plain version against the Pallas kernel
2e-5 in float32 and 3e-2 in bf16 (both round the output to bf16 once, the
inputs are the same bf16 values); model logits and caches 2e-4, the bound
of the reference's own pallas-vs-xla decode test; the engines' greedy
tokens, counters and pool bookkeeping bitwise.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
from repro.kernels.paged_attention.ops import \
    decode_attention_kernel as jax_ring  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.batching import Request as JRequest  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.sampler import SamplingParams as JSampling  # noqa: E402
import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import \
    decode_ring_ref  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.batching import Request as TRequest  # noqa: E402
from repro_torch.serving.engine import InferenceEngine as TEngine  # noqa: E402
from repro_torch.serving.sampler import \
    SamplingParams as TSampling  # noqa: E402

from _torch_cases import RING_CASES, ring_case  # noqa: E402
from test_torch_engine import (_counters, _pool_state, _serve,  # noqa: E402
                               _trace)

ARCH = "qwen3-0.6b"
WINDOW = 16
TOL = dict(rtol=2e-4, atol=2e-4)
RING_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
            "bfloat16": dict(rtol=3e-2, atol=3e-2)}
ENGINE_KW = dict(max_batch=3, max_seq=96, page_size=8, rng_seed=0)


def _cfgs(window):
    jcfg = jcfgs.get_smoke_config(ARCH).replace(dtype="float32",
                                                sliding_window=window)
    tcfg = tcfgs.get_smoke_config(ARCH).replace(dtype="float32",
                                                sliding_window=window)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def weights():
    jparams = jax_build_model(_cfgs(None)[0]).init(jax.random.PRNGKey(0))
    return jparams, params_from_numpy(jax.device_get(jparams), device="cpu")


# ------------------------------------------------------------------ kernel
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RING_CASES)
def test_decode_ring_plain_matches_pallas(dtype, case):
    seed, B, C, Hkv, n_rep, D, window = case
    arrs = ring_case(seed, B, C, Hkv, n_rep, D)
    q, ck, cv = (jnp.asarray(a, dtype) for a in arrs[:3])
    want = jax_ring(q, ck, cv, jnp.asarray(arrs[3]), window=window,
                    scale=D ** -0.5, n_rep=n_rep)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in arrs[:3])
    got = decode_ring_ref(tq, tk, tv, torch.from_numpy(arrs[3]),
                          scale=D ** -0.5, n_rep=n_rep, window=window)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **RING_TOL[dtype])


def test_ring_wrapper_takes_the_plain_version_on_cpu_and_checks_layout():
    q, ck, cv, pos = (torch.from_numpy(a) for a in ring_case(9, 2, 32, 2, 2,
                                                             16))
    n = paged_ops.decode_attention_kernel.launches
    got = paged_ops.decode_attention_kernel(q, ck, cv, pos, window=8,
                                            scale=0.25, n_rep=2)
    assert torch.equal(got, decode_ring_ref(q, ck, cv, pos, scale=0.25,
                                            n_rep=2, window=8))
    assert paged_ops.decode_attention_kernel.launches == n
    kw = dict(window=None, scale=0.25, n_rep=2)
    with pytest.raises(ValueError, match="int32"):
        paged_ops.decode_attention_kernel(q, ck, cv, pos.long(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        paged_ops.decode_attention_kernel(q, ck.transpose(1, 2).contiguous()
                                          .transpose(1, 2), cv, pos, **kw)
    with pytest.raises(ValueError, match="does not match"):
        paged_ops.decode_attention_kernel(q, ck, cv, pos, window=None,
                                          scale=0.25, n_rep=4)
    with pytest.raises(ValueError, match=r"\[B,1,H,D\]"):
        paged_ops.decode_attention_kernel(q.expand(2, 2, 4, 16), ck, cv, pos,
                                          **kw)


# ------------------------------------------------------------------- model
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("window", [None, WINDOW])
def test_prefill_and_decode_steps_match_the_reference(weights, impl, window):
    """``prefill(pad_cache_to=24)`` then three ``decode_step``s, logits and
    caches; with the window the 20-token prompt already wraps the ring."""
    jparams, tparams = weights
    jcfg, tcfg = _cfgs(window)
    jmodel = jax_build_model(jcfg, attention_impl=impl)
    tmodel = build_model(tcfg)
    S = 20 if window else 16
    toks = np.random.default_rng(11).integers(0, jcfg.vocab_size,
                                              (2, S)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                            pad_cache_to=24)
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                            pad_cache_to=24)
    assert tc["k"].shape[2] == (WINDOW if window else 24)
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


@pytest.mark.parametrize("window", [None, WINDOW])
@pytest.mark.parametrize("T", [1, 4])
def test_decode_chunk_logits_and_cache_match(weights, window, T):
    """A random dense cache, ragged positions (past the ring length with a
    window) and valid lengths, one idle row."""
    jparams, tparams = weights
    jcfg, tcfg = _cfgs(window)
    rng = np.random.default_rng(T)
    B, C = 4, WINDOW if window else 40
    shape = (jcfg.n_layers, B, C, jcfg.n_kv_heads, jcfg.head_dim_)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    hi = 3 * C if window else C - T - 1
    pos = rng.integers(0, hi, B).astype(np.int32)
    valid = rng.integers(1, T + 1, B).astype(np.int32)
    valid[-1] = 0
    toks = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    jl, jc = jax_build_model(jcfg).decode_chunk(
        jparams, jnp.asarray(toks), jnp.asarray(valid),
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv), "pos": jnp.asarray(pos)})
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    tl, tc = build_model(tcfg).decode_chunk(
        tparams, torch.from_numpy(toks), torch.from_numpy(valid),
        {"k": tk, "v": tv, "pos": torch.from_numpy(pos)})
    assert tc["k"] is tk and tc["v"] is tv        # updated in place
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL)
    for b in range(B):
        n = int(valid[b])
        np.testing.assert_allclose(tl[b, :n].numpy(), np.asarray(jl)[b, :n],
                                   **TOL)


def test_build_model_takes_windows_and_refuses_the_rest():
    cfg = tcfgs.get_smoke_config(ARCH)
    model = build_model(cfg.replace(sliding_window=WINDOW))
    cache = model.init_cache(3, 40, device="cpu")
    assert tuple(cache["k"].shape) == (cfg.n_layers, 3, WINDOW,
                                       cfg.n_kv_heads, cfg.head_dim_)
    assert build_model(cfg).init_cache(3, 40, device="cpu")["k"].shape[2] \
        == 40
    # layer norm, the gelu MLP and the VLM family are ported now: each
    # builds, with the reference's tree, and runs a prefill
    toks = torch.arange(1, 9)[None]
    for kw, leaf in ((dict(norm_type="layer"), ("final_norm", "b")),
                     (dict(mlp_type="gelu"), ("layers", "mlp", "w_up")),
                     (dict(family="vlm"), ("embed", "tok"))):
        variant = build_model(cfg.replace(**kw))
        params = variant.init(torch.Generator().manual_seed(0), device="cpu")
        node = params
        for key in leaf:
            node = node[key]
        logits, _ = variant.prefill(params, {"tokens": toks})
        assert tuple(logits.shape) == (1, cfg.vocab_size)
        assert torch.isfinite(logits.float()).all()
    assert "w_gate" not in build_model(cfg.replace(mlp_type="gelu")).init(
        torch.Generator(), device="cpu")["layers"]["mlp"]
    with pytest.raises(ValueError, match="family"):
        build_model(cfg.replace(family="encoder-only"))


# ------------------------------------------------------------------ engine
def _warm(engine):
    rng = np.random.default_rng(2)
    base = [int(t) for t in rng.integers(0, 512, 21)]
    longer = base + [int(t) for t in rng.integers(0, 512, 11)]
    return [engine.warm_session(sid, toks) for sid, toks in
            (("w1", base), ("w1", base[:15]), ("w2", longer),
             ("w1", longer + [5, 6, 7]))]


@pytest.mark.parametrize("prefill_chunk", [4, 0])
@pytest.mark.parametrize("window,path", [(None, "fused"),
                                         (WINDOW, "dense-ring")])
def test_dense_engine_matches_the_reference(weights, window, path,
                                            prefill_chunk):
    """``paged_decode=False`` (and, with the window, a ring that wraps at
    ``max_seq`` 96): the same trace and warm replays on both engines give
    the same greedy tokens, counters, pool stats and free pages."""
    jparams, tparams = weights
    jcfg, tcfg = _cfgs(window)
    kw = dict(ENGINE_KW, prefill_chunk=prefill_chunk, paged_decode=False)
    jeng = JEngine(jax_build_model(jcfg), jparams, **kw)
    teng = TEngine(build_model(tcfg), tparams, device="cpu", **kw)
    waves = _trace(1)
    want = _serve(jeng, JRequest, JSampling, waves)
    got = _serve(teng, TRequest, TSampling, waves)
    assert got == want
    assert _warm(teng) == _warm(jeng)
    assert _counters(teng) == _counters(jeng)
    assert _pool_state(teng) == _pool_state(jeng)
    # follow-up turns resume through gather_contiguous; past the window
    # the stored ring no longer fits the slot, and the resume is refused
    m = teng.metrics
    assert (m.prefix_hits if window is None else m.resume_overflows) > 0
    assert not teng.telemetry()["paged_decode"]
    teng.pool.check_invariants()


def test_ring_decode_path_is_reported(weights):
    """A windowed config whose ring wraps stays on the dense ring plane
    even with ``paged_decode=True``; one whose ring never wraps is paged."""
    _, tparams = weights
    _, tcfg = _cfgs(WINDOW)
    paths = []
    for max_seq in (96, WINDOW):
        eng = TEngine(build_model(tcfg), tparams, device="cpu",
                      **dict(ENGINE_KW, max_seq=max_seq))
        req = eng.generate(list(range(3, 12)), session_id="s",
                           sampling=TSampling(max_new_tokens=3))
        paths.append((req.decode_path, eng.telemetry()["paged_decode"]))
    assert paths == [("dense-ring", False), ("paged", True)]


def test_dense_plane_gives_the_paged_planes_tokens(weights):
    """Within the port: the dense plane serves the trace with the paged
    plane's greedy tokens and session caches (to float32 summation
    order: the paged plane attends with the paged kernel's plain
    version)."""
    _, tparams = weights
    _, tcfg = _cfgs(None)
    engines = [TEngine(build_model(tcfg), tparams, device="cpu",
                       paged_decode=paged, prefill_chunk=4, **ENGINE_KW)
               for paged in (True, False)]
    toks = [_serve(eng, TRequest, TSampling, _trace(3)) for eng in engines]
    assert toks[0] == toks[1]
    for sid in "abcdef":
        (k0, v0, n0), (k1, v1, n1) = (
            eng.pool.gather_contiguous(sid, eng.max_seq) for eng in engines)
        assert n0 == n1
        torch.testing.assert_close(k1[:, :n1], k0[:, :n0], **TOL)
        torch.testing.assert_close(v1[:, :n1], v0[:, :n0], **TOL)
