"""The split-KV paged chunk kernel's algorithm against the JAX package's
paged chunk kernel, on the CPU.

The port's paged chunk kernel (``csrc/paged_chunk.cu``) cuts the page
table's positions into fixed splits of ``SPLIT[dtype]`` tokens
(``ops.paged_splits``: 128 in bf16, 64 in float32), leaves each split's
softmax state (m, l, acc) per query row over the tokens the row sees
(position <= pos + t on a page that is not -1), and merges the splits with
the shared merge's weights exp(m_s - max m).  The CUDA source cannot run
here, so :func:`split_emulation` (``_torch_split.paged_chunk_emulation``)
repeats that algorithm in plain torch, split by split, with the kernel's
arithmetic (``_torch_split``, shared with the ring kernel's and the
one-token paged decode's emulations): the scores masked per row to -inf, the K and V of
tokens no row of the block sees (past pos + T - 1 or on a -1 entry)
zero-filled, a row that sees none of a split left at l = 0, and in bf16 P
fed to P.V as bf16 hi + lo.  It is held against the reference's Pallas
``paged_decode_chunk`` in interpret mode, the port's plain version and,
where no -1 entry lies below a row's position, the reference's oracle
``paged_decode_chunk_ref``: the oracle reads page 0 for a -1 entry where
the Pallas kernel and the port's plain version skip it.

Tolerances: float32 2e-5 (the summation order of the splits only, as the
ring emulation's).  bf16 4e-3, from the largest gap measured between the
emulation and its three witnesses on ``PAGED_CASES`` +
``PAGED_SPLIT_EDGES``: |got - want| / (1 + |want|) reaches 3.52e-3 (one
bf16 ulp, 2^-7, at an output of about 1.2: both sides compute in f32 from
the same bf16 inputs and round the output once, and a last-bit difference
in f32 flips the rounding there), so 4e-3 keeps a 14 % margin.  The same
emulation with P rounded to bf16 once (no lo term) reaches 5.21e-3 and
falls outside it (``test_bf16_tolerance_sees_p_rounded_once``).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.paged_attention.paged_attention import \
    paged_decode_chunk as jax_pallas  # noqa: E402
from repro.kernels.paged_attention.ref import \
    paged_decode_chunk_ref as jax_oracle  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import \
    paged_decode_chunk_ref  # noqa: E402

import _torch_split  # noqa: E402
from _torch_cases import (PAGED_CASES, PAGED_SPLIT_EDGES,  # noqa: E402
                          paged_chunk_inputs)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=4e-3, atol=4e-3)}


split_emulation = _torch_split.paged_chunk_emulation


def _inputs(case, dtype):
    q, kp, vp, pt, pos, n_rep = paged_chunk_inputs(case)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, kp, vp))
    return (q, kp, vp, pt, pos), (tq, tk, tv, torch.from_numpy(pt),
                                  torch.from_numpy(pos)), n_rep


def _hole_below_a_row(pt, pos, T, P):
    """Whether a -1 entry lies below some row's last position."""
    return any(pt[b, e] < 0 for b in range(len(pos))
               for e in range(-(-(int(pos[b]) + T) // P)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PAGED_CASES + PAGED_SPLIT_EDGES)
def test_split_algorithm_matches_pallas(dtype, case):
    arrs, targs, n_rep = _inputs(case, dtype)
    tq, tk = targs[:2]
    T, D, P = tq.shape[1], tq.shape[-1], tk.shape[1]
    kw = dict(scale=D ** -0.5, n_rep=n_rep)
    jargs = [jnp.asarray(a, dtype) for a in arrs[:3]] + \
        [jnp.asarray(a) for a in arrs[3:]]
    got = split_emulation(*targs, **kw)
    assert got.dtype == tq.dtype
    witnesses = [jax_pallas(*jargs, **kw, interpret=True),
                 paged_decode_chunk_ref(*targs, **kw).float().numpy()]
    if not _hole_below_a_row(arrs[3], arrs[4], T, P):
        witnesses.append(jax_oracle(*jargs, **kw))
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
    for case in PAGED_CASES + PAGED_SPLIT_EDGES:
        _, targs, n_rep = _inputs(case, "bfloat16")
        kw = dict(scale=targs[0].shape[-1] ** -0.5, n_rep=n_rep)
        want = paged_decode_chunk_ref(*targs, **kw).float()
        for p_lo in outside:
            got = split_emulation(*targs, p_lo=p_lo, **kw).float()
            outside[p_lo] += not torch.allclose(got, want, **TOL["bfloat16"])
    assert outside[True] == 0 and outside[False] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("maxp, P", [(1, 4), (6, 8), (9, 4), (5, 16),
                                     (12, 16), (16, 64), (5, 64), (3, 48),
                                     (2, 256)])
def test_split_layout_depends_on_the_page_size_and_type_alone(maxp, P,
                                                              dtype):
    """``paged_splits`` covers the table's maxp * P positions with fixed
    splits of ``SPLIT[dtype]`` tokens (the last one short; S / P whole
    entries when P divides S), and the scratch gives every query row the
    same n_splits * (D + 2) floats at any batch and chunk length, part_ml
    after part_acc; no position or entry enters either.  The split block's shared memory
    depends on D and the type alone and fits at every head dim up to 256,
    whatever the rows."""
    S = paged_ops.SPLIT[dtype]
    bounds = _torch_split.split_bounds(maxp * P, S)
    assert bounds[0][0] == 0 and bounds[-1][1] == maxp * P
    assert all(t1 - t0 == S for t0, t1 in bounds[:-1])
    if S % P == 0:
        assert all(t0 % P == 0 for t0, _ in bounds)
    assert paged_ops.paged_splits(maxp, P, dtype) == len(bounds)
    for B, T, H in ((1, 1, 16), (8, 8, 16), (3, 16, 64)):
        scratch, part_acc, part_ml = paged_ops.paged_scratch(
            B * T * H, maxp, P, 8, dtype, "cpu")
        assert scratch.dtype == torch.float32
        assert scratch.shape == (B * T * H * len(bounds) * (8 + 2),)
        assert part_acc == scratch.data_ptr()
        assert part_ml == part_acc + 4 * B * T * H * len(bounds) * 8
    for D in (8, 40, 64, 128, 256):
        paged_ops._check_split_block(D, dtype)
    with pytest.raises(ValueError, match="shared memory"):
        paged_ops._check_split_block(1024, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_rows_do_not_depend_on_the_batch_or_the_chunk(dtype):
    """Each sequence of a B=4 emulation equals, bitwise, a B=1 emulation of
    it, and row t of a T=8 emulation equals a T=1 emulation of its q row at
    pos + t over the same pages: a row's splits, its mask and the order
    they merge in depend on its own position, P and the type alone."""
    _, (tq, tk, tv, tpt, tpos), n_rep = _inputs(PAGED_SPLIT_EDGES[4], dtype)
    kw = dict(scale=0.125, n_rep=n_rep)
    full = split_emulation(tq, tk, tv, tpt, tpos, **kw)
    for b in range(tq.shape[0]):
        one = split_emulation(tq[b:b + 1], tk, tv, tpt[b:b + 1],
                              tpos[b:b + 1], **kw)
        assert torch.equal(one, full[b:b + 1])
    for t in range(tq.shape[1]):
        one = split_emulation(tq[:, t:t + 1].contiguous(), tk, tv, tpt,
                              tpos + t, **kw)
        assert torch.equal(one, full[:, t:t + 1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [PAGED_SPLIT_EDGES[2],
                                  PAGED_SPLIT_EDGES[5], PAGED_SPLIT_EDGES[7]])
def test_invisible_tokens_never_reach_the_output(dtype, case):
    """NaN in the pool pages no table holds (spare pages and the pages of
    -1 entries) and in every token past pos + T - 1 of a row's last pages
    leaves the output finite and equal to the clean pool's: the kernel
    zero-fills those tokens without reading them, and the emulation does
    the same."""
    _, (tq, tk, tv, tpt, tpos), n_rep = _inputs(case, dtype)
    T, P = tq.shape[1], tk.shape[1]
    hidden = torch.ones(tk.shape[:2], dtype=torch.bool)       # [n_pages,P]
    for b in range(tq.shape[0]):
        for tok in range(int(tpos[b]) + T):
            page = int(tpt[b, tok // P])
            if page >= 0:
                hidden[page, tok % P] = False
    nan = torch.tensor(float("nan"), dtype=tk.dtype)
    mask = hidden[:, :, None, None]
    kw = dict(scale=0.125, n_rep=n_rep)
    clean = split_emulation(tq, tk, tv, tpt, tpos, **kw)
    dirty = split_emulation(tq, torch.where(mask, nan, tk),
                            torch.where(mask, nan, tv), tpt, tpos, **kw)
    assert bool(torch.isfinite(dirty).all())
    assert torch.equal(dirty, clean)
