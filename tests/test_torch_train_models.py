"""The port's training forward and loss against the JAX package's, on the
CPU in float32 (smoke configs).

- Losses: ``cross_entropy`` (both impls, with and without a mask) and
  ``chunked_cross_entropy`` (S no multiple of the chunk, masked) within
  rtol 1e-6; ``_tied_unembed`` passes ``gradcheck`` in float64 and its
  dx / dw match ``jax.grad`` of the reference's, dtypes included, in bf16.
- Forward: logits and aux within rtol = atol = 1e-4 for qwen3 ("xla" and
  "xla_chunked"), granite-moe ("einsum" and "gather"; ``moe_block`` over
  one group and over several, T no multiple of the group) and
  phi-3-vision (with ``image_embeds``); ``unembed=False`` gives the
  hidden states; ``remat=True`` gives the same loss bit for bit.
- Capacity dispatch: ``_dispatch_masks`` on the same idx and gates gives
  dispatch and counts bit for bit, combine within 1e-7.
- Gradients: every leaf of qwen3, granite-moe (einsum) and phi-3-vision
  (masked loss) within relative L2 1e-4 of ``jax.grad``, also under
  ``remat=True``, in the reference's tree.
- The ssm, hybrid and audio families' ``forward`` and ``loss_fn`` raise,
  naming ROADMAP A14; every kernel wrapper refuses autograd.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.configs as jcfgs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.moe_ffn import ops as moe_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.training.train import loss_and_grads, to_device  # noqa: E402
from repro_torch.training.tree import tree_leaves, tree_unflatten  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")

_MODELS = {}


def _models(arch, **kw):
    """(jax model, jax params, port model, port params), float32 smoke,
    one draw per arch shared by the file's tests."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _MODELS:
        jcfg = jcfgs.get_smoke_config(arch).replace(dtype="float32")
        tcfg = tcfgs.get_smoke_config(arch).replace(dtype="float32")
        jm, tm = JM.build_model(jcfg, **kw), TM.build_model(tcfg, **kw)
        base = (arch, ())
        if base not in _MODELS:
            jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
            _MODELS[base] = (jm, jp, tm, params_from_numpy(
                jax.device_get(jp), device="cpu"))
        _, jp, _, tp = _MODELS[base]
        _MODELS[key] = (jm, jp, tm, tp)
    return _MODELS[key]


def _batch(cfg, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        b["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return b, to_device(b, CPU)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# ------------------------------------------------------------------- losses
@pytest.mark.parametrize("impl", ["onehot", "gather"])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches(impl, masked):
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = rng.random((3, 7)) < 0.6 if masked else None
    got = TM.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(labels),
                           None if mask is None else torch.from_numpy(mask),
                           impl=impl)
    want = JM.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask),
                            impl=impl)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_chunked_cross_entropy_matches():
    jm, jp, tm, tp = _models("qwen3-0.6b")
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((2, 21, tm.cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, tm.cfg.vocab_size, (2, 21)).astype(np.int32)
    mask = rng.random((2, 21)) < 0.7
    ref = jax.jit(lambda h, y, m: JM.chunked_cross_entropy(
        h, y, jp, jm.cfg, mask=m, chunk=8))
    for m in (None, mask):
        got = TM.chunked_cross_entropy(
            torch.from_numpy(hidden), torch.from_numpy(labels), tp, tm.cfg,
            mask=None if m is None else torch.from_numpy(m), chunk=8)
        want = ref(jnp.asarray(hidden), jnp.asarray(labels),
                   None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_tied_unembed_gradcheck_and_reference_vjp():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 3, 8))).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((11, 8))).requires_grad_()
    assert torch.autograd.gradcheck(TL._tied_unembed, (x, w))
    # bf16: dx, dw and their dtypes against jax.grad of the reference's
    xb = rng.standard_normal((2, 5, 16)).astype(np.float32)
    wb = rng.standard_normal((24, 16)).astype(np.float32)
    ct = rng.standard_normal((2, 5, 24)).astype(np.float32)

    def jloss(x, w):
        return jnp.sum(JL._tied_unembed(x, w).astype(jnp.float32) * ct)

    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(xb, jnp.bfloat16), jnp.asarray(wb, jnp.bfloat16))
    tx = torch.from_numpy(xb).bfloat16().requires_grad_()
    tw = torch.from_numpy(wb).bfloat16().requires_grad_()
    out = TL._tied_unembed(tx, tw)
    assert out.dtype == torch.bfloat16
    tdx, tdw = torch.autograd.grad(
        torch.sum(out.float() * torch.from_numpy(ct)), (tx, tw))
    for got, want in ((tdx, jdx), (tdw, jdw)):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=2e-2, atol=2e-2)


# ------------------------------------------------------------------ forward
FORWARD_CASES = [("qwen3-0.6b", {"attention_impl": "xla"}),
                 ("qwen3-0.6b", {"attention_impl": "xla_chunked"}),
                 ("granite-moe-1b-a400m", {"moe_impl": "einsum"}),
                 ("granite-moe-1b-a400m", {"moe_impl": "gather"}),
                 ("phi-3-vision-4.2b", {})]


@pytest.mark.parametrize("arch,kw", FORWARD_CASES)
def test_forward_logits_and_aux_match(arch, kw):
    jm, jp, tm, tp = _models(arch, **kw)
    jb, tb = _batch(tm.cfg)
    jl, ja = jax.jit(jm.forward)(jp, jb)
    tl, ta = tm.forward(tp, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)
    if tm.cfg.n_experts:
        assert float(ta) > 0


def test_pallas_forward_is_forward_only():
    """``attention_impl="pallas"`` (B2 on the card, its plain version here)
    gives the "xla" forward's logits under no_grad and refuses autograd."""
    _, _, tm, tp = _models("qwen3-0.6b")
    _, tb = _batch(tm.cfg)
    flash = TM.build_model(tm.cfg, attention_impl="pallas")
    with torch.no_grad():
        np.testing.assert_allclose(flash.forward(tp, tb)[0].numpy(),
                                   tm.forward(tp, tb)[0].numpy(), **TOL)
    with pytest.raises(RuntimeError, match="flash_attention_bhsd"):
        loss_and_grads(flash, tp, tb)


def test_chunked_sdpa_matches_over_ragged_chunks():
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 10, 3, 8)).astype(np.float32)
               for _ in range(3))
    for causal, window in ((True, None), (True, 4), (False, 3)):
        got = TL.chunked_sdpa(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal, window=window, scale=0.3,
                              q_chunk=4)
        want = JL.chunked_sdpa(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, window=window,
                               scale=0.3, q_chunk=4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_moe_block_capacity_groups_match(impl):
    """Several groups: T = 50 tokens in groups of 16, three whole and one
    padded (the forward tests run one group)."""
    jm, jp, tm, tp = _models("granite-moe-1b-a400m")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 25, tm.cfg.d_model)).astype(np.float32)
    lp_j = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["mlp"])
    lp_t = {k: v[0] for k, v in tp["layers"]["mlp"].items()}
    jy, ja, jc = jax.jit(lambda x: JMOE.moe_block(
        x, lp_j, jm.cfg, group_size=16, impl=impl))(jnp.asarray(x))
    ty, ta, tc = TMOE.moe_block(torch.from_numpy(x), lp_t, tm.cfg,
                                group_size=16, impl=impl)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)
    assert tc.dtype == torch.int32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_dispatch_masks_match_bit_for_bit():
    _, _, tm, _ = _models("granite-moe-1b-a400m")
    cfg = tm.cfg
    rng = np.random.default_rng(6)
    G, C = 40, 12     # capacity below demand: choices are dropped
    idx = np.stack([rng.permutation(cfg.n_experts)[:cfg.top_k]
                    for _ in range(G)]).astype(np.int32)
    gates = rng.random((G, cfg.top_k)).astype(np.float32)
    gates /= gates.sum(-1, keepdims=True)
    jd, jcomb, jcnt = JMOE._dispatch_masks(jnp.asarray(idx),
                                           jnp.asarray(gates), G, C,
                                           jcfgs.get_smoke_config(
                                               "granite-moe-1b-a400m"))
    td, tcomb, tcnt = TMOE._dispatch_masks(torch.from_numpy(idx),
                                           torch.from_numpy(gates), G, C,
                                           tcfgs.get_smoke_config(
                                               "granite-moe-1b-a400m"))
    assert td.dtype == torch.bfloat16 and tcnt.dtype == torch.int32
    np.testing.assert_array_equal(td.float().numpy(),
                                  np.asarray(jd, np.float32))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    assert int(tcnt.sum()) < G * cfg.top_k
    np.testing.assert_allclose(tcomb.numpy(), np.asarray(jcomb), rtol=0,
                               atol=1e-7)
    assert TMOE._capacity(2048, cfg) == JMOE._capacity(2048, cfg)


def test_hidden_states_and_remat():
    """``unembed=False`` gives the reference's hidden states; remat
    changes neither the logits nor the loss, bit for bit."""
    jm, jp, tm, tp = _models("granite-moe-1b-a400m")
    from repro.models import transformer as JT
    from repro_torch.models import transformer as TT
    jb, tb = _batch(tm.cfg)
    jh, _ = jax.jit(lambda p, t: JT.forward(
        p, jm.cfg, t, return_aux=True, unembed=False))(
            jp, jnp.asarray(jb["tokens"]))
    th, _ = TT.forward(tp, tm.cfg, tb["tokens"], return_aux=True,
                       unembed=False)
    assert th.shape == (2, 24, tm.cfg.d_model)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    rm = TM.build_model(tm.cfg, remat=True)
    assert torch.equal(rm.forward(tp, tb)[0], tm.forward(tp, tb)[0])
    hidden, aux = TT.forward(tp, tm.cfg, tb["tokens"], return_aux=True,
                             unembed=False)
    want = TM.chunked_cross_entropy(hidden, tb["labels"], tp, tm.cfg) \
        + TM.AUX_COEF * aux
    assert torch.equal(rm.loss_fn(tp, tb), want)


# ---------------------------------------------------------------- gradients
GRAD_CASES = [("qwen3-0.6b", {}), ("qwen3-0.6b", {"remat": True}),
              ("granite-moe-1b-a400m", {"moe_impl": "einsum"}),
              ("phi-3-vision-4.2b", {}), ("phi-3-vision-4.2b",
                                          {"remat": True})]


@pytest.mark.parametrize("arch,kw", GRAD_CASES)
def test_gradients_match_leaf_for_leaf(arch, kw):
    jm, jp, tm, tp = _models(arch, **kw)
    jb, tb = _batch(tm.cfg, seed=7)
    jloss, jg = jax.jit(jax.value_and_grad(jm.loss_fn))(jp, jb)
    tloss, tg = loss_and_grads(tm, tp, tb)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    # the gradients come out in the reference's tree, leaf for leaf
    tree = tree_unflatten(tp, tg)
    for path, want in jax.tree_util.tree_leaves_with_path(jg):
        node = tree
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == want.shape
        assert _rel_l2(node.numpy(), want) <= 1e-4, jax.tree_util.keystr(path)
    assert not any(x.requires_grad for x in tree_leaves(tp))


# ------------------------------------------------- what this slice leaves
@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b",
                                  "whisper-medium"])
def test_other_families_refuse_training_naming_a14(arch):
    model = TM.build_model(tcfgs.get_smoke_config(arch))
    for fn in (model.forward, model.loss_fn):
        with pytest.raises(NotImplementedError, match="A14"):
            fn({}, {"tokens": torch.zeros((1, 4), dtype=torch.long)})


def _kernel_calls():
    """Each kernel wrapper with small CPU inputs (float32), by name."""
    rng = np.random.default_rng(8)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    pt = torch.tensor([[0, 1], [2, -1]], dtype=torch.int32)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)
    return {
        "flash_attention_bhsd": lambda g: flash_ops.flash_attention_bhsd(
            g(t(2, 5, 8)), t(2, 5, 8), t(2, 5, 8)),
        "paged_decode_chunk": lambda g: paged_ops.paged_decode_chunk(
            g(t(2, 2, 4, 8)), t(4, 4, 2, 8), t(4, 4, 2, 8), pt, i32(3, 1),
            scale=0.3, n_rep=2),
        "paged_decode": lambda g: paged_ops.paged_decode(
            g(t(2, 4, 8)), t(4, 4, 2, 8), t(4, 4, 2, 8), pt, i32(5, 3),
            scale=0.3, n_rep=2),
        "decode_attention_kernel": lambda g: paged_ops.decode_attention_kernel(
            g(t(2, 1, 4, 8)), t(2, 6, 2, 8), t(2, 6, 2, 8), i32(3, 7),
            window=None, scale=0.3, n_rep=2),
        "moe_ffn": lambda g: moe_ops.moe_ffn(
            t(3, 4, 8), g(t(3, 8, 6)), t(3, 8, 6), t(3, 6, 8)),
        "ssd_chunk_scan": lambda g: ssd_ops.ssd_chunk_scan(
            g(t(1, 6, 2, 4)), torch.rand(1, 6, 2), torch.rand(2),
            t(1, 6, 3), t(1, 6, 3), chunk=4),
        "rglru_scan": lambda g: scan_ops.rglru_scan(
            torch.rand(2, 5, 4), g(t(2, 5, 4))),
    }


@pytest.mark.parametrize("name", sorted(_kernel_calls()))
def test_kernel_wrappers_refuse_autograd(name):
    """Under autograd a tensor that requires grad is refused, on the CPU
    as on the card (a launch would cut the gradient); under no_grad, or
    with no such tensor, the same call runs."""
    call = _kernel_calls()[name]
    with pytest.raises(RuntimeError, match=name):
        call(lambda x: x.requires_grad_())
    with torch.no_grad():
        call(lambda x: x.requires_grad_())
    out = call(lambda x: x)
    out = out[0] if isinstance(out, tuple) else out
    assert torch.isfinite(out).all() and not out.requires_grad
