"""The port's two attention kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain versions (``ref.py``); the
JAX side runs the Pallas kernels in interpret mode.  Both get the same
float32 inputs from numpy seeds: permuted page tables, -1 padding, ragged
positions, chunk lengths and sequence lengths that are no multiple of any
tile.  Tolerance: 2e-5 absolute and relative, float32 summation order.

The CUDA kernels themselves are held against the plain versions on the
card by ``test_torch_kernels_cuda.py``.  The package rules (no JAX /
``repro`` import, no silent CPU fallback) are checked here too.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_bhsd as jax_flash  # noqa: E402
from repro.kernels.paged_attention.paged_attention import \
    paged_decode_chunk as jax_paged_chunk  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_bhsd_ref  # noqa: E402
from repro_torch.kernels.moe_ffn import ops as moe_ops  # noqa: E402
from repro_torch.kernels.moe_ffn.ref import moe_ffn_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import \
    paged_decode_chunk_ref  # noqa: E402

from _torch_cases import (FLASH_CASES, PAGED_CASES, moe_case,  # noqa: E402
                          paged_case)

TOL = dict(rtol=2e-5, atol=2e-5)
REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_chunk_plain_matches_pallas(case):
    seed, B, T, Hkv, n_rep, D, P, n_pages, maxp = case
    q, kp, vp, pt, pos = paged_case(seed, B, T, Hkv, n_rep, D, P, n_pages,
                                     maxp)
    scale = D ** -0.5
    want = jax_paged_chunk(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                           jnp.asarray(pt), jnp.asarray(pos), scale=scale,
                           n_rep=n_rep, interpret=True)
    got = paged_decode_chunk_ref(torch.from_numpy(q), torch.from_numpy(kp),
                                 torch.from_numpy(vp), torch.from_numpy(pt),
                                 torch.from_numpy(pos), scale=scale,
                                 n_rep=n_rep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_chunk_plain_ignores_pages_past_pos():
    """Garbage in page slots past every row's position changes nothing."""
    q, kp, vp, pt, pos = paged_case(7, 3, 4, 2, 2, 32, 8, 30, 8)
    args = dict(scale=32 ** -0.5, n_rep=2)
    t = torch.from_numpy
    base = paged_decode_chunk_ref(t(q), t(kp), t(vp), t(pt), t(pos), **args)
    kp2, vp2 = kp.copy(), vp.copy()
    for b in range(3):
        last = int(pos[b]) + 3
        for tok in range(last + 1, pt.shape[1] * 8):
            page = pt[b, tok // 8]
            if page >= 0:
                kp2[page, tok % 8] = 1e3
                vp2[page, tok % 8] = -1e3
    got = paged_decode_chunk_ref(t(q), t(kp2), t(vp2), t(pt), t(pos), **args)
    np.testing.assert_array_equal(got.numpy(), base.numpy())


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_pallas(case):
    seed, BH, Sq, Skv, D, causal, window = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((BH, Sq, D)).astype(np.float32)
    k = rng.standard_normal((BH, Skv, D)).astype(np.float32)
    v = rng.standard_normal((BH, Skv, D)).astype(np.float32)
    # 32-row tiles so the interpreted kernel also runs ragged tiles
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, window=window, block_q=32, block_k=32,
                     interpret=True)
    got = flash_attention_bhsd_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal,
                                   window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_tensors_take_the_plain_versions_without_launching():
    q, kp, vp, pt, pos = paged_case(5, 2, 2, 2, 2, 32, 8, 16, 6)
    t = torch.from_numpy
    before = (paged_ops.paged_decode_chunk.launches,
              flash_ops.flash_attention_bhsd.launches,
              moe_ops.moe_ffn.launches)
    got = paged_ops.paged_decode_chunk(t(q), t(kp), t(vp), t(pt), t(pos),
                                       scale=0.2, n_rep=2)
    want = paged_decode_chunk_ref(t(q), t(kp), t(vp), t(pt), t(pos),
                                  scale=0.2, n_rep=2)
    assert torch.equal(got, want)
    x = torch.randn(2, 9, 32)
    assert torch.equal(flash_ops.flash_attention_bhsd(x, x, x),
                       flash_attention_bhsd_ref(x, x, x))
    xe, wg, wu, wd = (t(a) for a in moe_case(4, 3, 5, 16, 24))
    xe = xe[:1].expand(3, 5, 16)
    assert torch.equal(moe_ops.moe_ffn(xe, wg, wu, wd),
                       moe_ffn_ref(xe, wg, wu, wd))
    assert (paged_ops.paged_decode_chunk.launches,
            flash_ops.flash_attention_bhsd.launches,
            moe_ops.moe_ffn.launches) == before


# ------------------------------------------------------------ package rules
def _port_modules():
    return sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_modules(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"{path.name}:{node.lineno} imports {name}"


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    """Without a card and without device="cpu", nothing runs on the CPU."""
    import repro_torch as rt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = rt.get_smoke_config("qwen3-0.6b")
    model = rt.build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.PagedKVPool(cfg, n_pages=4, page_size=8)
    params = model.init(torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.InferenceEngine(model, params, max_batch=1, max_seq=16,
                           page_size=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.params_from_numpy({"w": np.zeros(2, np.float32)})
    # the MoE family, whose every layer runs moe_ffn, refuses the same way
    moe = rt.build_model(rt.get_smoke_config("granite-moe-1b-a400m"))
    with pytest.raises(RuntimeError, match="CUDA"):
        moe.init(torch.Generator())
    moe_params = moe.init(torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.InferenceEngine(moe, moe_params, max_batch=1, max_seq=16,
                           page_size=8)
