"""The port's VLM and encoder-decoder against the JAX package's, on the CPU.

phi-3-vision (the dense backbone behind a fused image prefix) and
whisper-medium (a bidirectional encoder, a causal decoder with
cross-attention, layer norm + gelu, no decoder position signal), each at
its smoke config in float32 with the reference's weights from one seed,
carried over by ``interop.params_from_numpy``; the stubbed frontends'
inputs (``image_embeds``, ``frames``) are unit normals from numpy seeds.

Checks: ``fuse``, the entry points (``prefill`` with the extras,
``decode_step``, ``decode_chunk``, ``decode_chunk_paged``,
``encode_cross``) and the parameter tree (``enc_pos``, ``enc_layers``,
``dec_layers``, ``xattn``); then the two packages' engines in lockstep
(the reference's ``tests/test_paged_decode_equivalence.py`` scenarios):
paged == dense, monolithic prefill, resumed sessions, and the audio
family's refused resume (``resume_unsupported``), no prefix sharing and
its memory rows on both planes.

Tolerances as in ``test_torch_variants.py``: logits, caches and pages
1e-4; greedy tokens, counters and free pages bitwise.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import encdec as JE  # noqa: E402
from repro.models import vlm as JV  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models import vlm as TV  # noqa: E402
from repro_torch.serving.sampler import \
    SamplingParams as TSampling  # noqa: E402

from test_torch_variants import (TOL, all_archs_scenario,  # noqa: E402
                                 batch_inputs, check_paged_step, engines,
                                 extras, generate, monolithic_scenario,
                                 resumed_scenario, stack)

PHI, WHISPER = "phi_3_vision_4_2b", "whisper_medium"


def close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module", params=[PHI, WHISPER])
def a12(request):
    return request.param, stack(request.param)


# ------------------------------------------------------------ entry points
def test_fuse_puts_the_image_before_the_text():
    s = stack(PHI)
    toks = np.random.default_rng(0).integers(0, 512, (2, 7)).astype(np.int32)
    jb, tb = batch_inputs(s.cfg, toks)
    want = JV.fuse(s.jparams, s.jmodel.cfg, jb["tokens"], jb["image_embeds"])
    got = TV.fuse(s.tparams, s.cfg, tb["tokens"], tb["image_embeds"])
    assert tuple(got.shape) == (2, s.cfg.n_image_tokens + 7, s.cfg.d_model)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(TV.fuse(s.tparams, s.cfg, tb["tokens"], None),
                       got[:, s.cfg.n_image_tokens:])


def test_encdec_tree_carries_across():
    s = stack(WHISPER)
    host = jax.device_get(s.jparams)
    assert set(s.tparams) == {"embed", "enc_pos", "enc_layers", "enc_norm",
                              "dec_layers", "final_norm"}
    assert set(s.tparams["dec_layers"]["xattn"]) == {"wq", "wk", "wv", "wo"}
    assert set(s.tparams["enc_layers"]["mlp"]) == {"w_up", "w_down"}
    for path, leaf in jax.tree_util.tree_leaves_with_path(host):
        node = s.tparams
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_prefill_and_decode_steps_match(a12):
    """``prefill(pad_cache_to=...)`` of a 12-token prompt with its extras
    (the image prefix makes phi-3's cache 16 + 12 long), then three
    ``decode_step``s; logits and every cache leaf."""
    _, s = a12
    toks = np.random.default_rng(11).integers(
        0, s.cfg.vocab_size, (2, 12)).astype(np.int32)
    jb, tb = batch_inputs(s.cfg, toks)
    jl, jc = s.jmodel.prefill(s.jparams, jb, pad_cache_to=40)
    tl, tc = s.tmodel.prefill(s.tparams, tb, pad_cache_to=40)
    assert set(tc) == set(jc)
    for step in range(4):
        if step:
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            jl, jc = s.jmodel.decode_step(s.jparams, jnp.asarray(tok), jc)
            tl, tc = s.tmodel.decode_step(s.tparams, torch.from_numpy(tok),
                                          tc)
        close(tl, jl)
        for key in jc:
            close(tc[key], jc[key])


def test_encode_cross_equals_prefills_memory():
    s = stack(WHISPER)
    toks = np.arange(1, 9, dtype=np.int32)[None].repeat(2, 0)
    jb, tb = batch_inputs(s.cfg, toks)
    xk, xv = s.tmodel.encode_cross(s.tparams, tb["frames"])
    jxk, jxv = s.jmodel.encode_cross(s.jparams, jb["frames"])
    close(xk, jxk)
    close(xv, jxv)
    _, tc = s.tmodel.prefill(s.tparams, tb)
    assert torch.equal(tc["xk"], xk) and torch.equal(tc["xv"], xv)
    close(TE.encode(s.tparams, s.cfg, tb["frames"]),
          JE.encode(s.jparams, s.jmodel.cfg, jb["frames"]))


def memory(cfg, B, seed=7):
    """A random cross memory xk/xv [L,B,T_enc,Hkv,Dh] (audio only)."""
    if cfg.family != "audio":
        return {}
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, B, cfg.encoder_seq, cfg.n_kv_heads,
             cfg.head_dim_)
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("xk", "xv")}


@pytest.mark.parametrize("T", [1, 4])
def test_decode_chunk_matches(a12, T):
    """A random dense cache (and memory), ragged positions and lengths,
    one idle row."""
    _, s = a12
    rng = np.random.default_rng(T)
    B, C = 4, 40
    shape = (s.cfg.n_layers, B, C, s.cfg.n_kv_heads, s.cfg.head_dim_)
    cache = {"k": rng.standard_normal(shape).astype(np.float32),
             "v": rng.standard_normal(shape).astype(np.float32),
             "pos": rng.integers(0, C - T - 1, B).astype(np.int32),
             **memory(s.cfg, B)}
    valid = rng.integers(1, T + 1, B).astype(np.int32)
    valid[-1] = 0
    toks = rng.integers(0, s.cfg.vocab_size, (B, T)).astype(np.int32)
    jl, jc = s.jmodel.decode_chunk(
        s.jparams, jnp.asarray(toks), jnp.asarray(valid),
        {k: jnp.asarray(v) for k, v in cache.items()})
    tl, tc = s.tmodel.decode_chunk(
        s.tparams, torch.from_numpy(toks), torch.from_numpy(valid),
        {k: torch.from_numpy(v.copy()) for k, v in cache.items()})
    assert set(tc) == set(jc)
    for key in jc:
        close(tc[key], jc[key])
    for b in range(B):
        n = int(valid[b])
        close(tl[b, :n], np.asarray(jl)[b, :n])


@pytest.mark.parametrize("T", [1, 8])
def test_decode_chunk_paged_matches(a12, T):
    _, s = a12
    check_paged_step(s, T, memory(s.cfg, 4))


# ----------------------------------------------------------------- engines
@pytest.mark.parametrize("arch", [PHI, WHISPER])
def test_paged_matches_dense_in_lockstep(arch):
    all_archs_scenario(arch)


@pytest.mark.parametrize("arch", [PHI, WHISPER])
def test_monolithic_prefill_parity(arch):
    monolithic_scenario(arch)


def test_resumed_session_parity_with_an_image():
    """phi-3: the first turn's image prefix (monolithic) is resumed by a
    text-only second turn."""
    got = resumed_scenario(PHI)
    assert got["prefix_hits"] > 0 and got["resume_unsupported"] == 0


def test_audio_resume_is_refused_and_counted():
    """whisper: the memory is not pooled, so a second turn (with its
    frames) is rebuilt cold, as on the reference: once per plane."""
    got = resumed_scenario(WHISPER, second_extras=True)
    assert got["prefix_hits"] == 0 and got["resume_unsupported"] == 1


@pytest.mark.parametrize("paged", [True, False])
def test_audio_slots_hold_memory_and_share_no_prefix(paged):
    """An audio engine keeps each slot's xk/xv beside the K/V (on the
    paged plane, the slim cache) and never consults the prefix index;
    a chunked admission's memory equals ``encode_cross``'s."""
    s = stack(WHISPER)
    _, teng = engines(s, paged)
    assert teng._paged == paged and not teng._prefix_share_ok
    L, E = s.cfg.n_layers, s.cfg.encoder_seq
    assert tuple(teng.cache["xk"].shape)[:3] == (L, 4, E)
    assert ("k" in teng.cache) != paged
    ex = extras(s.cfg, seed=3)
    req = teng.generate(list(range(3, 11)), session_id="a",
                        sampling=TSampling(max_new_tokens=3), **ex)
    assert req.decode_path == ("paged" if paged else "fused")
    xk, _ = s.tmodel.encode_cross(s.tparams,
                                  torch.from_numpy(ex["frames"])[None])
    assert torch.equal(teng.cache["xk"][:, 0], xk[:, 0])
    assert teng.pool.stats.get("dedup_pages", 0) == 0


def test_text_request_on_the_vlm_chunks_and_an_image_one_does_not():
    s = stack(PHI)
    _, teng = engines(s, True)
    ex = extras(s.cfg)
    _, with_image = generate(teng, TSampling, list(range(1, 12)), "i", 4, ex)
    _, text = generate(teng, TSampling, list(range(1, 12)), "t", 4, {})
    assert teng.metrics.prefills == 2
    # the image request's pages hold its 16-token prefix + its bucket
    assert teng.pool.session("i").tokens == s.cfg.n_image_tokens + 16 + 3
    assert teng.pool.session("t").tokens == 11 + 3
