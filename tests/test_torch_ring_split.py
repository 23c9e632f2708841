"""The split-KV ring kernel's algorithm against the JAX package's ring
kernel, on the CPU.

The port's ring kernel (``csrc/decode_ring.cu``) cuts the cache into
fixed splits of ``SPLIT[dtype]`` slots (``ops.ring_splits``: 128 in
bf16, 64 in float32), leaves each
split's softmax state (m, l, acc) over its visible slots, and merges the
splits with B3's weights exp(m_s - max m).  The CUDA source cannot run
here, so :func:`split_emulation` repeats that algorithm in plain torch
(``_torch_split``, shared with the paged chunk kernel's emulation), split
by split, with the kernel's arithmetic: f32 scores of the inputs masked
to -inf outside ``ring_visible``, invisible slots' K and V zero-filled,
and in bf16 the probabilities fed to P.V as bf16 hi + lo.  It is held
against the reference's ``decode_attention_kernel`` (the Pallas kernel in
interpret mode), the reference's oracle ``decode_ring_ref`` and the port's
plain version.

The reference's Pallas kernel pads a cache longer than its 128-slot block
to a multiple of it with zero K and V, and its mask lets those padded
slots through once a row's position passes C (``slot <= pos`` without a
window; the ring's age wraps onto them with one): at C = 200 a row at pos
450 sees 56 zero keys more than the oracle does.  So it is the witness
only where it pads nothing (C <= 128 or a multiple of 128), and the
oracle, which the port's plain version follows, where it pads.

Tolerances: float32 2e-5 (the summation order of the splits only, as the
plain ring version's own test); bf16 2.5e-3.  Both sides compute in f32
from the same bf16 inputs and round the output to bf16 once, and P as
hi + lo is within ~2^-16 of f32, so the emulation stays within one bf16
ulp of its witnesses, and the same emulation with P rounded to bf16 once
(no lo term) falls outside the tolerance on several cases
(``test_bf16_tolerance_sees_p_rounded_once``).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.paged_attention.ops import \
    decode_attention_kernel as jax_ring  # noqa: E402
from repro.kernels.paged_attention.ref import \
    decode_ring_ref as jax_oracle  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    decode_ring_ref, ring_visible)

import _torch_split  # noqa: E402
from _torch_cases import (RING_CASES, RING_SPLIT_EDGES,  # noqa: E402
                          ring_inputs)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2.5e-3, atol=2.5e-3)}


def split_bounds(C, dtype):
    """[(first slot, end slot)] of each split of a C-slot ring."""
    return _torch_split.split_bounds(C, paged_ops.SPLIT[dtype])


def split_emulation(q, cache_k, cache_v, pos, *, scale, n_rep, window,
                    p_lo=True):
    """The split kernel and its merge in plain torch -> [B,1,H,D]."""
    B, _, H, D = q.shape
    C, Hkv = cache_k.shape[1:3]
    visible = ring_visible(pos, C, window)[:, None, None]    # [B,1,1,C]
    m, l, acc = _torch_split.split_states(
        q.reshape(B, Hkv, n_rep, D), cache_k, cache_v, visible,
        paged_ops.SPLIT[q.dtype], scale=scale, p_lo=p_lo)
    return _torch_split.merge_states(m, l, acc, q.dtype).reshape(B, 1, H, D)


def _torch_inputs(case, dtype):
    q, ck, cv, pos, n_rep, window = ring_inputs(case)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, ck, cv))
    return (q, ck, cv, pos), (tq, tk, tv, torch.from_numpy(pos)), n_rep, \
        window


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RING_CASES + RING_SPLIT_EDGES)
def test_split_algorithm_matches_pallas(dtype, case):
    arrs, (tq, tk, tv, tpos), n_rep, window = _torch_inputs(case, dtype)
    C, D = tk.shape[1], tk.shape[-1]
    kw = dict(window=window, scale=D ** -0.5, n_rep=n_rep)
    jargs = [jnp.asarray(a, dtype) for a in arrs[:3]] + [jnp.asarray(arrs[3])]
    got = split_emulation(tq, tk, tv, tpos, **kw)
    assert got.dtype == tq.dtype
    pads = C > 128 and C % 128  # the Pallas grid pads the cache
    witnesses = [(jax_oracle if pads else jax_ring)(*jargs, **kw),
                 decode_ring_ref(tq, tk, tv, tpos, **kw).float().numpy()]
    for want in witnesses:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   **TOL[dtype])


def test_bf16_tolerance_sees_p_rounded_once():
    """The bf16 tolerance is tight enough to tell the kernel's P.V (P as
    hi + lo) from P rounded to bf16 once: against the port's plain version
    the emulation without the lo term falls outside it on some case, the
    emulation with it on none."""
    outside = {True: 0, False: 0}
    for case in RING_CASES + RING_SPLIT_EDGES:
        _, (tq, tk, tv, tpos), n_rep, window = _torch_inputs(case,
                                                             "bfloat16")
        kw = dict(window=window, scale=tk.shape[-1] ** -0.5, n_rep=n_rep)
        want = decode_ring_ref(tq, tk, tv, tpos, **kw).float()
        for p_lo in outside:
            got = split_emulation(tq, tk, tv, tpos, p_lo=p_lo, **kw).float()
            outside[p_lo] += not torch.allclose(got, want, **TOL["bfloat16"])
    assert outside[True] == 0 and outside[False] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1, 40, 63, 64, 65, 96, 130, 200, 1024, 2048])
def test_split_layout_depends_on_the_cache_length_alone(C, dtype):
    """``ring_splits`` covers the C slots with fixed splits of
    ``SPLIT[dtype]`` (the last one short), and the scratch gives every
    query row the same n_splits * (D + 2) floats at any batch; no position
    enters either."""
    S = paged_ops.SPLIT[dtype]
    bounds = split_bounds(C, dtype)
    assert bounds[0][0] == 0 and bounds[-1][1] == C
    assert all(b0 == a1 for (_, a1), (b0, _) in zip(bounds, bounds[1:]))
    assert all(t1 - t0 == S for t0, t1 in bounds[:-1])
    assert 0 < bounds[-1][1] - bounds[-1][0] <= S
    assert paged_ops.ring_splits(C, dtype) == len(bounds) == -(-C // S)
    for B, H in ((1, 16), (8, 16), (3, 2)):
        scratch, _, _ = paged_ops.ring_scratch(B * H, C, 8, dtype, "cpu")
        assert scratch.dtype == torch.float32
        assert scratch.shape == (B * H * len(bounds) * (8 + 2),)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_rows_do_not_depend_on_the_batch(dtype):
    """Each row of a B=5 emulation equals, bitwise, a B=1 emulation of that
    row: a row's splits, and the order they merge in, depend on C alone."""
    _, (tq, tk, tv, tpos), n_rep, window = _torch_inputs(
        RING_SPLIT_EDGES[3], dtype)
    kw = dict(scale=0.125, n_rep=n_rep, window=window)
    full = split_emulation(tq, tk, tv, tpos, **kw)
    for b in range(tq.shape[0]):
        one = split_emulation(tq[b:b + 1], tk[b:b + 1], tv[b:b + 1],
                              tpos[b:b + 1], **kw)
        assert torch.equal(one, full[b:b + 1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_invisible_slots_never_reach_the_output(dtype):
    """NaN in every slot a row cannot see (never-written ring slots) leaves
    the output finite and equal to the clean cache's: the kernel zero-fills
    those slots without reading them, and the emulation does the same."""
    _, (tq, tk, tv, tpos), n_rep, window = _torch_inputs(
        RING_SPLIT_EDGES[2], dtype)
    C = tk.shape[1]
    hidden = ~ring_visible(tpos, C, window)[:, :, None, None]
    kw = dict(scale=0.125, n_rep=n_rep, window=window)
    clean = split_emulation(tq, tk, tv, tpos, **kw)
    nan = torch.tensor(float("nan"), dtype=tk.dtype)
    dirty = split_emulation(tq, torch.where(hidden, nan, tk),
                            torch.where(hidden, nan, tv), tpos, **kw)
    assert bool(torch.isfinite(dirty).all())
    assert torch.equal(dirty, clean)
