"""The port's one-token paged decode (B3) against the JAX package's.

On the CPU the port's ``paged_decode`` runs its plain version
(``paged_decode_ref``: the pages gathered densely, then ring attention at
``pos = lengths - 1``); the JAX side runs the Pallas kernel
``paged_decode`` in interpret mode and its own ``paged_decode_ref``.  Both
get the same inputs from numpy seeds: the reference's sweep (f32 and bf16,
-1 padded tables) and its fuzz shapes (permuted tables, partial last pages,
valid pages wholly past a row's length), the fuzz also against a float64
numpy oracle that shares no code with either side.  Then the engine-pool
case of the reference's ``test_paged_kernel_reads_engine_pool``: the
kernel over the page tables of a live engine's pool.

Tolerances: float32 2e-5 absolute and relative (summation order); bf16
1e-2 (both sides compute in float32 from the same bf16 inputs and round
the output once, so they differ by at most about one bf16 ulp); the
float64 oracle 1e-4, and the engine pools 2e-4, the reference's own
bounds.  The CUDA kernel is held against the plain version on the card by
``test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
from repro.kernels.paged_attention.paged_attention import \
    paged_decode as jax_paged_decode  # noqa: E402
from repro.kernels.paged_attention.ref import \
    paged_decode_ref as jax_paged_decode_ref  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.sampler import SamplingParams as JSampling  # noqa: E402
import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels.paged_attention import ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    decode_ring_ref, paged_decode_ref)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import InferenceEngine as TEngine  # noqa: E402
from repro_torch.serving.sampler import \
    SamplingParams as TSampling  # noqa: E402

from _torch_cases import (PAGED_DECODE_CASES, paged_decode_case,  # noqa: E402
                          paged_decode_sweep)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}


def _both(q, kp, vp, pt, lengths, n_rep, dtype):
    """(port plain version, Pallas interpret, JAX oracle) on one input,
    each as float32 numpy."""
    scale = q.shape[-1] ** -0.5
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]

    def t(x, cast=True):
        x = torch.from_numpy(x)
        return x.to(tdt) if cast else x

    got = ops.paged_decode(t(q), t(kp), t(vp), t(pt, False),
                           t(lengths, False), scale=scale, n_rep=n_rep)
    jargs = [jnp.asarray(x).astype(dtype) for x in (q, kp, vp)]
    pallas = jax_paged_decode(*jargs, jnp.asarray(pt), jnp.asarray(lengths),
                              scale=scale, n_rep=n_rep, interpret=True)
    oracle = jax_paged_decode_ref(*jargs, jnp.asarray(pt),
                                  jnp.asarray(lengths), scale=scale,
                                  n_rep=n_rep)
    return (got.float().numpy(), np.asarray(pallas, np.float32),
            np.asarray(oracle, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_on_the_reference_sweep(dtype):
    q, kp, vp, pt, lengths = paged_decode_sweep(3)
    got, pallas, oracle = _both(q, kp, vp, pt, lengths, 4, dtype)
    assert got.shape == (3, 8, 64)
    np.testing.assert_allclose(got, pallas, **TOL[dtype])
    np.testing.assert_allclose(got, oracle, **TOL[dtype])


def _dense_oracle(q, kp, vp, pt, lengths, scale):
    """Independent float64 numpy attention: each row's first lengths[b]
    tokens gathered through its table, softmax, weighted sum."""
    q, kp, vp = (np.asarray(x, np.float64) for x in (q, kp, vp))
    B, H, D = q.shape
    _, P, Hkv, _ = kp.shape
    rep = H // Hkv
    out = np.zeros_like(q)
    for b in range(B):
        n = int(lengths[b])
        pages = [int(p) for p in pt[b, :-(-n // P)]]
        k = np.concatenate([kp[p] for p in pages])[:n]
        v = np.concatenate([vp[p] for p in pages])[:n]
        for h in range(H):
            s = (k[:, h // rep] @ q[b, h]) * scale
            w = np.exp(s - s.max())
            out[b, h] = (w / w.sum()) @ v[:, h // rep]
    return out


@pytest.mark.parametrize("case", PAGED_DECODE_CASES)
def test_plain_matches_pallas_on_fuzzed_tables(case):
    seed, B, Hkv, n_rep, D, P, n_pages, maxp, spare = case
    q, kp, vp, pt, lengths = paged_decode_case(seed, B, Hkv, n_rep, D, P,
                                               n_pages, maxp, spare)
    got, pallas, oracle = _both(q, kp, vp, pt, lengths, n_rep, "float32")
    np.testing.assert_allclose(got, pallas, **TOL["float32"])
    np.testing.assert_allclose(got, oracle, **TOL["float32"])
    dense = _dense_oracle(q, kp, vp, pt, lengths, D ** -0.5)
    np.testing.assert_allclose(got.astype(np.float64), dense,
                               rtol=1e-4, atol=1e-4)


def test_plain_ignores_pages_and_slots_past_the_length():
    """Garbage in every pool slot a row cannot see (the tail of its last
    page, its valid pages wholly past the length, unused pages) changes
    nothing: the pool recycles pages without zeroing them."""
    q, kp, vp, pt, lengths = paged_decode_case(9, 3, 2, 2, 16, 8, 30, 6, 2)
    t = torch.from_numpy
    args = dict(scale=0.25, n_rep=2)
    base = ops.paged_decode(t(q), t(kp), t(vp), t(pt), t(lengths), **args)
    seen = np.zeros(kp.shape[:2], bool)
    for b in range(3):
        for tok in range(int(lengths[b])):
            seen[pt[b, tok // 8], tok % 8] = True
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[~seen] = 1e3
    vp2[~seen] = -1e3
    got = ops.paged_decode(t(q), t(kp2), t(vp2), t(pt), t(lengths), **args)
    np.testing.assert_array_equal(got.numpy(), base.numpy())
    assert (pt >= 0).sum() > sum(-(-int(n) // 8) for n in lengths)


def test_cpu_tensors_take_the_plain_version_without_launching():
    q, kp, vp, pt, lengths = (torch.from_numpy(x) for x in
                              paged_decode_case(4, 2, 2, 2, 16, 8, 12, 4, 1))
    before = ops.paged_decode.launches
    got = ops.paged_decode_attention(q, kp, vp, pt, lengths, scale=0.3,
                                     n_rep=2)
    want = paged_decode_ref(q, kp, vp, pt, lengths, scale=0.3, n_rep=2)
    assert torch.equal(got, want)
    assert ops.paged_decode.launches == before
    with pytest.raises(ValueError, match="int32"):
        ops.paged_decode(q, kp, vp, pt.long(), lengths, scale=0.3, n_rep=2)
    with pytest.raises(ValueError, match="does not match"):
        ops.paged_decode(q, kp, vp, pt, lengths, scale=0.3, n_rep=3)


def test_kernel_reads_engine_pool():
    """The reference's ``test_paged_kernel_reads_engine_pool`` on both
    packages over the same float32 smoke weights: B3 over a live engine's
    page tables matches dense attention over the pool's gathered cache, and
    the two packages agree."""
    arch = "qwen3-0.6b"
    jcfg = jcfgs.get_smoke_config(arch).replace(dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(tcfgs.get_smoke_config(arch).replace(
        dtype="float32"))
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    jeng = JEngine(jmodel, jparams, max_batch=4, max_seq=128)
    teng = TEngine(tmodel, tparams, max_batch=4, max_seq=128, device="cpu")
    jeng.generate(list(range(20)), session_id="pk",
                  sampling=JSampling(max_new_tokens=4))
    teng.generate(list(range(20)), session_id="pk",
                  sampling=TSampling(max_new_tokens=4))
    cfg = teng.cfg
    n_rep, scale = cfg.n_heads // cfg.n_kv_heads, cfg.head_dim_ ** -0.5
    q = np.random.default_rng(0).standard_normal(
        (1, cfg.n_heads, cfg.head_dim_)).astype(np.float32)
    outs = []
    for eng, is_jax in ((jeng, True), (teng, False)):
        sp = eng.pool.session("pk")
        assert sp is not None and sp.tokens > 0
        pt = eng.pool.page_table("pk", len(sp.pages))[None]
        lens = np.array([sp.tokens], np.int32)
        for layer in (0, cfg.n_layers - 1):
            if is_jax:
                from repro.kernels.paged_attention.ops import \
                    paged_decode_attention
                out = np.asarray(paged_decode_attention(
                    jnp.asarray(q), eng.pool.k[layer], eng.pool.v[layer],
                    jnp.asarray(pt), jnp.asarray(lens), scale=scale,
                    n_rep=n_rep))
                outs.append(out)
                continue
            out = ops.paged_decode(torch.from_numpy(q), eng.pool.k[layer],
                                   eng.pool.v[layer], torch.from_numpy(pt),
                                   torch.from_numpy(lens), scale=scale,
                                   n_rep=n_rep)
            k, v, tokens = eng.pool.gather_contiguous("pk", eng.max_seq)
            ref = decode_ring_ref(
                torch.from_numpy(q)[:, None], k[layer][None],
                v[layer][None], torch.tensor([tokens - 1], dtype=torch.int32),
                scale=scale, n_rep=n_rep)[:, 0]
            np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-4,
                                       atol=2e-4)
            outs.append(out.numpy())
    for want, got in zip(outs[:2], outs[2:]):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
