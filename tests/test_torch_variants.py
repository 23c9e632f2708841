"""The port's other dense variants against the JAX package's, on the CPU.

qwen3-1.7b (rms norm, swiglu, qk norm), stablelm-1.6b (layer norm,
swiglu, a quarter of the head rotated) and starcoder2-15b (layer norm,
the gelu MLP, a sliding window), each at its smoke config in float32 with
the reference's weights from one seed, carried over by
``interop.params_from_numpy``.  One model per arch per module.

Checks: the configs field for field (smoke and full) and the parameter
trees; ``layer_norm``, ``apply_norm``, the gelu MLP and partial RoPE
against the reference's functions; the four entry points (``prefill``,
``decode_step``, ``decode_chunk``, ``decode_chunk_paged``); and the two
packages' engines in lockstep on the reference's paged-vs-dense scenarios
(``tests/test_paged_decode_equivalence.py``): all archs, monolithic
prefill, resumed sessions, and starcoder2's windowed chunk regression
(``tests/test_serving.py``) on the dense ring plane.

Tolerances: layer functions 1e-5 in float32 (1e-2 in bf16, one rounding
of the output); entry-point logits, caches and pages 1e-4 (float32 through
two layers and the unembedding, summed in another order); greedy tokens,
counters and free pages bitwise.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.sampler import SamplingParams as JSampling  # noqa: E402
import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import InferenceEngine as TEngine  # noqa: E402
from repro_torch.serving.sampler import \
    SamplingParams as TSampling  # noqa: E402

import _torch_cases  # noqa: E402,F401  (absorbs the first MKL call)

A11 = ["qwen3_1_7b", "stablelm_1_6b", "starcoder2_15b"]
NEW = A11 + ["phi_3_vision_4_2b", "whisper_medium"]
TOL = dict(rtol=1e-4, atol=1e-4)
FN_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
          "bfloat16": dict(rtol=1e-2, atol=1e-2)}
COUNTERS = ("completed", "decode_steps", "prefills", "prefill_tokens",
            "prefix_hits", "shared_prefix_hits", "shared_prefix_tokens",
            "tokens_generated", "resume_overflows", "resume_unsupported",
            "paged_append_failures")
# the reference's equivalence harness: 4 slots, 64 positions, pages of 8
ENGINE_KW = dict(max_batch=4, max_seq=64, page_size=8, prefill_chunk=4,
                 rng_seed=0)


@dataclasses.dataclass
class Stack:
    """One arch's smoke config in float32 on both packages, same weights."""
    jmodel: object
    jparams: dict
    tmodel: object
    tparams: dict

    @property
    def cfg(self):
        return self.tmodel.cfg


def make_stack(arch: str, seed: int = 0) -> Stack:
    jcfg = jcfgs.get_smoke_config(arch).replace(dtype="float32")
    tcfg = tcfgs.get_smoke_config(arch).replace(dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    return Stack(jmodel, jparams, build_model(tcfg),
                 params_from_numpy(jax.device_get(jparams), device="cpu"))


_STACKS = {}


def stack(arch: str) -> Stack:
    if arch not in _STACKS:
        _STACKS[arch] = make_stack(arch)
    return _STACKS[arch]


def extras(cfg, seed: int = 1) -> dict:
    """The stubbed frontends' inputs of one request: audio frames
    [T_enc, D] or image patch embeddings [T_img, D], unit normals."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
            (cfg.encoder_seq, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        return {"image_embeds": rng.standard_normal(
            (cfg.n_image_tokens, cfg.d_model)).astype(np.float32)}
    return {}


def batch_inputs(cfg, toks: np.ndarray, seed: int = 5):
    """The prefill batch of ``toks`` [B,S] for both packages, with a batch
    of the family's extras."""
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(
        toks.astype(np.int64))}
    for k, v in extras(cfg, seed).items():
        arr = np.stack([v, v[::-1].copy()])[:toks.shape[0]]
        jb[k], tb[k] = jnp.asarray(arr), torch.from_numpy(arr)
    return jb, tb


def engines(s: Stack, paged: bool, **kw):
    """The reference's engine and the port's, same knobs."""
    kw = dict(ENGINE_KW, paged_decode=paged, **kw)
    return (JEngine(s.jmodel, s.jparams, **kw),
            TEngine(s.tmodel, s.tparams, device="cpu", **kw))


def counters(engine) -> dict:
    return {k: getattr(engine.metrics, k) for k in COUNTERS}


def pool_state(engine):
    return dict(engine.pool.stats), engine.pool.free_pages()


def same_engines(jeng, teng) -> None:
    assert counters(teng) == counters(jeng)
    assert pool_state(teng) == pool_state(jeng)
    teng.pool.check_invariants()


def generate(engine, sampling_cls, prompt, sid, max_new, ex):
    req = engine.generate(prompt, session_id=sid,
                          sampling=sampling_cls(temperature=0.0,
                                                max_new_tokens=max_new),
                          **ex)
    return [int(t) for t in req.generated], req


def session_bytes(engine, sid):
    got = engine.pool.gather_contiguous(sid, engine.max_seq)
    assert got is not None
    k, v, tokens = got
    return k[:, :tokens], v[:, :tokens], tokens


def all_archs_scenario(arch: str) -> None:
    """The reference's ``test_paged_matches_dense_all_archs`` on both
    packages: three sessions of 11-token prompts, 6 greedy tokens each,
    on the dense and the paged plane."""
    s = stack(arch)
    ex = extras(s.cfg)
    toks = {}
    for paged in (False, True):
        jeng, teng = engines(s, paged)
        got = [generate(teng, TSampling, list(range(1 + j, 12 + j)),
                        f"s{j}", 6, ex) for j in range(3)]
        want = [generate(jeng, JSampling, list(range(1 + j, 12 + j)),
                         f"s{j}", 6, ex) for j in range(3)]
        assert [g for g, _ in got] == [w for w, _ in want]
        assert [r.decode_path for _, r in got] == \
            [r.decode_path for _, r in want]
        same_engines(jeng, teng)
        toks[paged] = (teng, [g for g, _ in got])
    assert toks[True][1] == toks[False][1]
    dense, paged_e = toks[False][0], toks[True][0]
    assert paged_e._paged
    for j in range(3):
        kd, vd, nd = session_bytes(dense, f"s{j}")
        kp, vp, np_ = session_bytes(paged_e, f"s{j}")
        assert nd == np_
        torch.testing.assert_close(kp, kd, **TOL)
        torch.testing.assert_close(vp, vd, **TOL)


def monolithic_scenario(arch: str) -> None:
    """``prefill_chunk=0``: the bucket prefill at admission, shredded into
    pages on the paged plane; both planes, both packages."""
    s = stack(arch)
    ex = extras(s.cfg)
    outs = []
    for paged in (False, True):
        jeng, teng = engines(s, paged, prefill_chunk=0)
        got, _ = generate(teng, TSampling, list(range(2, 14)), "mono", 6, ex)
        want, _ = generate(jeng, JSampling, list(range(2, 14)), "mono", 6,
                           ex)
        assert got == want
        same_engines(jeng, teng)
        assert teng.metrics.prefills == 1
        outs.append(got)
    assert outs[0] == outs[1]


def resumed_scenario(arch: str, second_extras: bool = False) -> dict:
    """Two turns of one session: the second resumes from the pool (zero
    copy on the paged plane, a gather on the dense one).  Returns the
    port's paged engine's counters."""
    s = stack(arch)
    ex = extras(s.cfg)
    ex2 = ex if second_extras else {}
    outs = {}
    for paged in (False, True):
        jeng, teng = engines(s, paged)
        runs = []
        for eng, sampling in ((jeng, JSampling), (teng, TSampling)):
            t1, _ = generate(eng, sampling, list(range(1, 10)), "sess", 4,
                             ex)
            t2, r2 = generate(eng, sampling, list(range(20, 26)), "sess", 4,
                              ex2)
            runs.append((t1, t2, r2.prefix_reused_tokens))
        assert runs[1] == runs[0]
        same_engines(jeng, teng)
        outs[paged] = (runs[1], teng)
    assert outs[True][0] == outs[False][0]
    return counters(outs[True][1])


@pytest.fixture(scope="module", params=A11)
def variant(request):
    return request.param, stack(request.param)


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", NEW)
def test_configs_equal_the_reference_field_for_field(arch, smoke):
    get_j = jcfgs.get_smoke_config if smoke else jcfgs.get_config
    get_t = tcfgs.get_smoke_config if smoke else tcfgs.get_config
    assert dataclasses.asdict(get_t(arch)) == dataclasses.asdict(get_j(arch))
    alias = get_j(arch).arch_id.replace("-smoke", "")
    if not smoke and alias in tcfgs._ALIASES:
        assert tcfgs.get_config(alias) == get_t(arch)


def test_the_port_has_every_reference_arch():
    assert tcfgs.ARCH_IDS == jcfgs.ARCH_IDS
    assert tcfgs._ALIASES == jcfgs._ALIASES


@pytest.mark.parametrize("arch", NEW)
def test_init_params_has_the_reference_tree_and_shapes(arch):
    got = build_model(tcfgs.get_smoke_config(arch)).init(
        torch.Generator().manual_seed(0), device="cpu")
    want = jax.eval_shape(jax_build_model(jcfgs.get_smoke_config(arch)).init,
                          jax.random.PRNGKey(0))
    shapes_t = jax.tree_util.tree_map(lambda x: tuple(x.shape), got)
    shapes_j = jax.tree_util.tree_map(lambda x: tuple(x.shape), want)
    assert shapes_t == shapes_j
    dtypes = {x.dtype for x in jax.tree_util.tree_leaves(got)}
    assert dtypes == {torch.bfloat16}


def test_params_from_numpy_carries_layer_norm_and_gelu_trees():
    """starcoder2's tree: layer norms' ``b``, the two-matrix gelu MLP."""
    host = jax.device_get(stack("starcoder2_15b").jparams)
    got = stack("starcoder2_15b").tparams
    assert set(got["layers"]["mlp"]) == {"w_up", "w_down"}
    assert set(got["final_norm"]) == {"w", "b"}
    for path, leaf in jax.tree_util.tree_leaves_with_path(host):
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches(dtype):
    """Population variance, f32 math, the output rounded to x's type; an
    offset mean (the variance's two-pass form matters there)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, 96)) * 2.0 + 3.0).astype(np.float32)
    w, b = (rng.standard_normal(96).astype(np.float32) for _ in range(2))
    want = JL.layer_norm(jnp.asarray(x, dtype), jnp.asarray(w, dtype),
                         jnp.asarray(b, dtype), 1e-5)
    tdt = getattr(torch, dtype)
    got = TL.layer_norm(torch.from_numpy(x).to(tdt),
                        torch.from_numpy(w).to(tdt),
                        torch.from_numpy(b).to(tdt), 1e-5)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **FN_TOL[dtype])


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "stablelm_1_6b"])
def test_apply_norm_takes_either_type(arch):
    jcfg = jcfgs.get_smoke_config(arch).replace(dtype="float32")
    tcfg = tcfgs.get_smoke_config(arch).replace(dtype="float32")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    p = {"w": rng.standard_normal(jcfg.d_model).astype(np.float32)}
    if jcfg.norm_type == "layer":
        p["b"] = rng.standard_normal(jcfg.d_model).astype(np.float32)
    want = JL.apply_norm(jnp.asarray(x), {k: jnp.asarray(v)
                                          for k, v in p.items()}, jcfg)
    got = TL.apply_norm(torch.from_numpy(x), {k: torch.from_numpy(v)
                                              for k, v in p.items()}, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **FN_TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches(dtype):
    """starcoder2's MLP: no gate, gelu's tanh approximation (jax.nn.gelu's
    default)."""
    jcfg = jcfgs.get_smoke_config("starcoder2_15b").replace(dtype=dtype)
    tcfg = tcfgs.get_smoke_config("starcoder2_15b").replace(dtype=dtype)
    p = jax.tree_util.tree_map(
        lambda a: a[0], jax_build_model(jcfg).init(
            jax.random.PRNGKey(3))["layers"]["mlp"])
    assert set(p) == {"w_up", "w_down"}
    x = np.random.default_rng(2).standard_normal(
        (2, 6, jcfg.d_model)).astype(np.float32)
    want = JL.mlp_block(jnp.asarray(x, dtype), p, jcfg)
    tp = params_from_numpy(jax.device_get(p), device="cpu")
    got = TL.mlp_block(torch.from_numpy(x).to(getattr(torch, dtype)), tp,
                       tcfg)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **FN_TOL[dtype])


@pytest.mark.parametrize("rope_pct,head_dim", [(0.25, 64), (0.25, 32),
                                               (0.0, 64), (1.0, 40)])
def test_partial_rope_matches(rope_pct, head_dim):
    """stablelm's quarter of head dim 64 rotates 16 dims and passes 48
    through; whisper's 0 rotates none."""
    jcfg = jcfgs.get_smoke_config("stablelm_1_6b").replace(
        dtype="float32", rope_pct=rope_pct, head_dim=head_dim)
    tcfg = tcfgs.get_smoke_config("stablelm_1_6b").replace(
        dtype="float32", rope_pct=rope_pct, head_dim=head_dim)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 4, head_dim)).astype(np.float32)
    positions = rng.integers(0, 3000, (2, 9))
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(positions), jcfg)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(positions),
                        tcfg)
    rot = int(head_dim * rope_pct) // 2 * 2
    np.testing.assert_array_equal(got[..., rot:].numpy(), x[..., rot:])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------ entry points
def test_prefill_and_decode_steps_match(variant):
    """``prefill(pad_cache_to=24)`` of a 16-token prompt, then three
    ``decode_step``s (the ring kernel's plain version); logits, caches."""
    _, s = variant
    toks = np.random.default_rng(11).integers(
        0, s.cfg.vocab_size, (2, 16)).astype(np.int32)
    jl, jc = s.jmodel.prefill(s.jparams, {"tokens": jnp.asarray(toks)},
                              pad_cache_to=24)
    tl, tc = s.tmodel.prefill(s.tparams, {"tokens": torch.from_numpy(toks)},
                              pad_cache_to=24)
    for step in range(4):
        if step:
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            jl, jc = s.jmodel.decode_step(s.jparams, jnp.asarray(tok), jc)
            tl, tc = s.tmodel.decode_step(s.tparams, torch.from_numpy(tok),
                                          tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       **TOL)
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))


def chunk_inputs(cfg, seed, B, T, C, window):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, B, C, cfg.n_kv_heads, cfg.head_dim_)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    hi = 3 * C if window else C - T - 1
    pos = rng.integers(0, hi, B).astype(np.int32)
    valid = rng.integers(1, T + 1, B).astype(np.int32)
    valid[-1] = 0
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    return toks, valid, pos, ck, cv


@pytest.mark.parametrize("T", [1, 4])
def test_decode_chunk_matches(variant, T):
    """A random dense cache (starcoder2's a ring of its window, 64, with
    positions past it), ragged positions and lengths, one idle row."""
    _, s = variant
    W = s.cfg.sliding_window
    toks, valid, pos, ck, cv = chunk_inputs(s.cfg, T, 4, T, W or 40, W)
    jl, jc = s.jmodel.decode_chunk(
        s.jparams, jnp.asarray(toks), jnp.asarray(valid),
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv), "pos": jnp.asarray(pos)})
    tl, tc = s.tmodel.decode_chunk(
        s.tparams, torch.from_numpy(toks), torch.from_numpy(valid),
        {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy()),
         "pos": torch.from_numpy(pos)})
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL)
    for b in range(len(valid)):
        n = int(valid[b])
        np.testing.assert_allclose(tl[b, :n].numpy(), np.asarray(jl)[b, :n],
                                   **TOL)


def paged_inputs(cfg, seed, B, T, P, n_pages, max_seq):
    """A random pool, per-row tables over disjoint permuted pages that
    cover each row's chunk, ragged pos and valid lengths (one idle row)."""
    rng = np.random.default_rng(seed)
    maxp = -(-max_seq // P)
    shape = (cfg.n_layers, n_pages, P, cfg.n_kv_heads, cfg.head_dim_)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    pos = rng.integers(0, max_seq - T, B).astype(np.int32)
    valid = rng.integers(1, T + 1, B).astype(np.int32)
    valid[-1] = 0
    perm = rng.permutation(n_pages)
    pt = np.full((B, maxp), -1, np.int32)
    used = 0
    for b in range(B):
        need = -(-(int(pos[b]) + T) // P)
        pt[b, :need] = perm[used:used + need]
        used += need
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    return toks, valid, pos, kp, vp, pt


def check_paged_step(s: Stack, T: int, slim: dict = None) -> None:
    """``decode_chunk_paged`` (the reference's Pallas kernel path in
    interpret mode, the port's plain paged attention) over a random pool
    of 40-position tables: logits, pages and positions.  ``slim`` adds
    the slim cache's other leaves (the audio family's memory)."""
    max_seq, P = 40, 8
    toks, valid, pos, kp, vp, pt = paged_inputs(s.cfg, T, 4, T, P, 24,
                                                max_seq)
    slim = slim or {}
    jl, jcache, jk, jv = s.jmodel.decode_chunk_paged(
        s.jparams, jnp.asarray(toks), jnp.asarray(valid),
        dict({k: jnp.asarray(v) for k, v in slim.items()},
             pos=jnp.asarray(pos)),
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt), max_seq=max_seq,
        kernel=True)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tl, tcache, tk2, tv2 = s.tmodel.decode_chunk_paged(
        s.tparams, torch.from_numpy(toks), torch.from_numpy(valid),
        dict({k: torch.from_numpy(v) for k, v in slim.items()},
             pos=torch.from_numpy(pos)),
        tk, tv, torch.from_numpy(pt), max_seq=max_seq)
    assert tk2 is tk and tv2 is tv          # pages updated in place
    assert set(tcache) == set(jcache)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    for b in range(len(valid)):
        n = int(valid[b])
        np.testing.assert_allclose(tl[b, :n].numpy(),
                                   np.asarray(jl)[b, :n], **TOL)


@pytest.mark.parametrize("T", [1, 8])
def test_decode_chunk_paged_matches(variant, T):
    """starcoder2's window (64) lies above the 40-position tables, so no
    window masks, as on the engine's paged plane."""
    check_paged_step(variant[1], T)


# ----------------------------------------------------------------- engines
@pytest.mark.parametrize("arch", A11)
def test_paged_matches_dense_in_lockstep(arch):
    all_archs_scenario(arch)


@pytest.mark.parametrize("arch", ["starcoder2_15b"])
def test_monolithic_prefill_parity(arch):
    monolithic_scenario(arch)


@pytest.mark.parametrize("arch", ["starcoder2_15b"])
def test_resumed_session_parity(arch):
    got = resumed_scenario(arch)
    assert got["prefix_hits"] > 0 and got["resume_unsupported"] == 0


def test_windowed_chunked_prefill_matches_per_token():
    """The reference's sliding-window regression on the port: starcoder2's
    smoke window (64) below ``max_seq`` 128, so the engine serves the dense
    ring plane; a 100-token prompt through fused chunks equals the per-token
    masked steps, and both equal the reference's fused engine."""
    s = stack("starcoder2_15b")
    assert s.cfg.sliding_window == 64
    prompt = [int(t) for t in
              np.random.default_rng(3).integers(1, s.cfg.vocab_size, 100)]
    kw = dict(max_batch=2, max_seq=128, prefill_chunk=8)
    fused = TEngine(s.tmodel, s.tparams, device="cpu", **kw)
    assert not fused._paged
    r_fused = fused.generate(prompt, sampling=TSampling(max_new_tokens=6))
    assert r_fused.decode_path == "dense-ring"
    per_tok = TEngine(dataclasses.replace(s.tmodel, decode_chunk=None),
                      s.tparams, device="cpu", **kw)
    r_tok = per_tok.generate(prompt, sampling=TSampling(max_new_tokens=6))
    assert r_tok.decode_path == "masked"
    ref = JEngine(s.jmodel, s.jparams, **kw).generate(
        prompt, sampling=JSampling(max_new_tokens=6))
    assert r_fused.generated == r_tok.generated == \
        [int(t) for t in ref.generated]
