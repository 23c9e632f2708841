"""The one-token paged decode kernel's split algorithm against the JAX
package's paged decode kernel, on the CPU.

The port's one-token paged decode (B3) is the paged chunk kernel
(``csrc/paged_chunk.cu``, over the split block of
``csrc/split_attention.cuh``) at one token, with the n_rep query heads of a
kv head as a block's rows: the table's positions in fixed splits of ``SPLIT[dtype]``
tokens (``ops.paged_splits``: 128 in bf16, 64 in float32), each split's
softmax state (m, l, acc) over the tokens below ``lengths[b]`` whose entry
is not -1, then the shared merge (``csrc/split_merge.cuh``).  The CUDA
source cannot run here, so :func:`decode_emulation` repeats that algorithm
in plain torch, split by split (``_torch_split``, shared with the ring and
paged chunk kernels' emulations), and is held against the reference's
Pallas ``paged_decode`` in interpret mode, the port's plain version and,
where no -1 entry lies below a row's length, the reference's oracle
``paged_decode_ref`` (the oracle and the plain version read page 0 for a
-1 entry, where the Pallas kernel and the CUDA kernel skip it).

Tolerances, as the paged chunk kernel's emulation: float32 2e-5 (the
summation order of the splits only); bf16 4e-3, one bf16 ulp (2^-7) at
outputs near 1 with a margin: both sides compute in f32 from the same bf16
inputs and round the output to bf16 once, so a last-bit difference in f32
can flip that rounding.  On these cases |got - want| / (1 + |want|)
reaches 8.3e-4 in bf16 and 2.3e-7 in float32.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.paged_attention.paged_attention import \
    paged_decode as jax_pallas  # noqa: E402
from repro.kernels.paged_attention.ref import \
    paged_decode_ref as jax_oracle  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import \
    paged_decode_ref  # noqa: E402

import _torch_split  # noqa: E402
from _torch_cases import (PAGED_DECODE_CASES,  # noqa: E402
                          PAGED_DECODE_SPLIT_EDGES, paged_decode_inputs)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=4e-3, atol=4e-3)}

def decode_emulation(q, k_pages, v_pages, page_table, lengths, *, scale,
                     n_rep, p_lo=True):
    """B3's split kernel and the merge in plain torch: q [B,H,D], the n_rep
    query heads of kv head g one block's rows, every row of the block
    seeing the table positions c < lengths[b] whose entry is not -1.
    -> [B,H,D]."""
    B, H, D = q.shape
    _n, P, Hkv, _ = k_pages.shape
    C = page_table.shape[1] * P
    idx = page_table.long().clamp(min=0)
    k = k_pages[idx].reshape(B, C, Hkv, D)
    v = v_pages[idx].reshape(B, C, Hkv, D)
    present = (page_table >= 0).repeat_interleave(P, 1)          # [B,C]
    visible = (torch.arange(C)[None] < lengths.long()[:, None]) & present
    m, l, acc = _torch_split.split_states(
        q.reshape(B, Hkv, n_rep, D), k, v, visible[:, None, None],
        paged_ops.SPLIT[q.dtype], scale=scale, p_lo=p_lo)
    return _torch_split.merge_states(m, l, acc, q.dtype).reshape(B, H, D)


def _inputs(case, dtype):
    *arrs, n_rep = paged_decode_inputs(case)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in arrs[:3])
    return arrs, (tq, tk, tv, torch.from_numpy(arrs[3]),
                  torch.from_numpy(arrs[4])), n_rep


def _hole_below_a_row(pt, lengths, P):
    """Whether a -1 entry lies below some row's length."""
    return any(pt[b, e] < 0 for b in range(len(lengths))
               for e in range(-(-int(lengths[b]) // P)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["sweep"] + PAGED_DECODE_CASES
                         + PAGED_DECODE_SPLIT_EDGES)
def test_decode_split_algorithm_matches_pallas(dtype, case):
    arrs, targs, n_rep = _inputs(case, dtype)
    tq, tk = targs[:2]
    kw = dict(scale=tq.shape[-1] ** -0.5, n_rep=n_rep)
    got = decode_emulation(*targs, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    jargs = [jnp.asarray(a, dtype) for a in arrs[:3]] + \
        [jnp.asarray(a) for a in arrs[3:]]
    witnesses = [jax_pallas(*jargs, **kw, interpret=True)]
    if not _hole_below_a_row(arrs[3], arrs[4], tk.shape[1]):
        witnesses += [paged_decode_ref(*targs, **kw).float().numpy(),
                      jax_oracle(*jargs, **kw)]
    for want in witnesses:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["sweep"] + PAGED_DECODE_CASES
                         + PAGED_DECODE_SPLIT_EDGES)
def test_decode_split_equals_the_chunk_kernel_at_one_token(dtype, case):
    """B3's emulation equals, bitwise, the paged chunk kernel's at T=1 with
    pos = lengths - 1 over the same pages: the same splits, the same mask
    (a position c is seen when c <= pos, i.e. c < lengths), the same rows
    of the block and the same merge."""
    _, (tq, tk, tv, tpt, tlen), n_rep = _inputs(case, dtype)
    kw = dict(scale=tq.shape[-1] ** -0.5, n_rep=n_rep)
    got = decode_emulation(tq, tk, tv, tpt, tlen, **kw)
    chunk = _torch_split.paged_chunk_emulation(
        tq[:, None].contiguous(), tk, tv, tpt, tlen - 1, **kw)[:, 0]
    assert torch.equal(got, chunk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("maxp, P", [(3, 4), (16, 64), (128, 64), (512, 64),
                                     (8, 48), (3, 256), (2, 512)])
def test_decode_split_layout_depends_on_the_table_and_type_alone(maxp, P,
                                                                 dtype):
    """B3's splits are B1's: ``paged_splits(max_pages, P, dtype)`` fixed
    splits of ``SPLIT[dtype]`` positions, whatever the batch, the lengths
    or the entries; its scratch gives each of the B*H rows n_splits * (D +
    2) floats.  Shared memory depends on D and the type alone, so pages of
    any size are taken (the first B3 kernel staged a whole page and refused
    a float32 page of 512 at D=256)."""
    S = paged_ops.SPLIT[dtype]
    n = paged_ops.paged_splits(maxp, P, dtype)
    assert n == len(_torch_split.split_bounds(maxp * P, S))
    for B, H in ((1, 16), (8, 16), (3, 64)):
        scratch, part_acc, part_ml = paged_ops.paged_scratch(
            B * H, maxp, P, 8, dtype, "cpu")
        assert scratch.shape == (B * H * n * (8 + 2),)
        assert part_ml == part_acc + 4 * B * H * n * 8
    for D in (8, 64, 128, 256):
        paged_ops._check_split_block(D, dtype)
    with pytest.raises(ValueError, match="splits exceed"):
        paged_ops.paged_scratch(16, paged_ops.MERGE_MAX_SPLITS * S // P + 1,
                                P, 8, dtype, "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [PAGED_DECODE_SPLIT_EDGES[0],
                                  PAGED_DECODE_SPLIT_EDGES[2],
                                  PAGED_DECODE_CASES[3]])
def test_decode_split_never_reads_invisible_tokens(dtype, case):
    """NaN in the pool pages no table holds below a row's length (spare
    pages, valid pages past the length, the pages of -1 entries) and in
    every token at or past lengths[b] leaves the output finite and equal
    to the clean pool's: the kernel zero-fills those tokens without reading
    them, and the emulation does the same."""
    _, (tq, tk, tv, tpt, tlen), n_rep = _inputs(case, dtype)
    P = tk.shape[1]
    hidden = torch.ones(tk.shape[:2], dtype=torch.bool)       # [n_pages,P]
    for b in range(tq.shape[0]):
        for tok in range(int(tlen[b])):
            page = int(tpt[b, tok // P])
            if page >= 0:
                hidden[page, tok % P] = False
    nan = torch.tensor(float("nan"), dtype=tk.dtype)
    mask = hidden[:, :, None, None]
    kw = dict(scale=0.125, n_rep=n_rep)
    clean = decode_emulation(tq, tk, tv, tpt, tlen, **kw)
    dirty = decode_emulation(tq, torch.where(mask, nan, tk),
                             torch.where(mask, nan, tv), tpt, tlen, **kw)
    assert bool(torch.isfinite(dirty).all())
    assert torch.equal(dirty, clean)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 33, 64, 256])
def test_merge_order_holds_to_a_float64_merge(n):
    """The merge's fixed order (32 lanes for the denominator, 16 groups
    for the numerator) over n splits, some empty (l = 0, acc never read:
    NaN here), agrees with the same merge in float64 within 1e-6, and a row
    with no live split gets zeros."""
    rng = np.random.default_rng(n)
    m = rng.standard_normal((3, n)) * 4
    l = rng.uniform(0.5, 40, (3, n))
    acc = rng.standard_normal((3, n, 24)) * l[..., None]
    l[0, 1::3] = 0
    l[2] = 0
    acc[l == 0] = np.nan
    m[l == 0] = -np.inf
    got = _torch_split.merge_states(*(torch.from_numpy(x).float()
                                      for x in (m, l, acc)), torch.float32)
    live = l[:2] > 0
    w = np.exp(np.where(live, m[:2], 0) - m[:2].max(-1, keepdims=True))
    w = np.where(live, w, 0)
    want = (w[..., None] * np.where(live[..., None], acc[:2], 0)).sum(1) \
        / (w * l[:2]).sum(1)[:, None]
    np.testing.assert_allclose(got[:2].numpy(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got[2], torch.zeros(24))
