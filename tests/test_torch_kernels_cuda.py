"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one; none needs JAX.  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: f32 1e-5 (summation order only); bf16 1e-2 absolute and
relative (both sides round the output to bf16 once; the flash kernel also
rounds its probabilities to bf16 before P.V, as its plain version does).
The expert-FFN kernel's rows must also be bitwise independent of how many
rows are launched with them.  The SSD chunk scan is held relative to the
largest reference value: y within 1e-2 in bf16 (the plain version also
rounds the scores, the decayed score matrix and dt to bf16, the kernel
only y) and 1e-3 in float32, against the plain version and against the
token-by-token recurrence; its float32 final state within 1e-3.  The
RG-LRU scan multiplies and adds in its plain version's order, separately
rounded, so it must equal it bit for bit (and so within 1e-5).
"""

import numpy as np
import pytest
import torch

from _torch_cases import (FLASH_CASES, MOE_CASES, PAGED_CASES,
                          PAGED_DECODE_CASES, RGLRU_CASES, RING_CASES,
                          SSD_CASES, moe_case, paged_case, paged_decode_case,
                          paged_decode_sweep, rglru_case, ring_case,
                          ssd_case)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_bhsd_ref
from repro_torch.kernels.moe_ffn import ops as moe_ops
from repro_torch.kernels.moe_ffn.ref import moe_ffn_ref
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ref import (decode_ring_ref,
                                                     paged_decode_chunk_ref,
                                                     paged_decode_ref)
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_chunked_ref, ssd_sequential

CARD_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
            torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
# the serving path's shapes at full width: B=8, T=8, 16/8 heads, D=128,
# P=64, the engine's default pool of 272 pages, 16 table entries
MAIN_PAGED = (9, 8, 8, 8, 2, 128, 64, 272, 16)
MAIN_FLASH = (9, 16, 500, 500, 128, True, None)
# recurrentgemma-9b's prefill attention (16 heads of 256, window 2048): the
# 512-token bucket of an admission, a 128 window over it, and a ragged one
MAIN_FLASH_256 = [(12, 16, 512, 512, 256, True, 2048),
                  (13, 16, 512, 512, 256, True, 128),
                  (14, 3, 77, 77, 256, True, 9)]
# decode_step's ring at full width: B=8, a 1024-slot cache, 8 kv heads of
# 2 queries, D=128; no window, and a 256-slot ring with a 256 window
MAIN_RING = [(9, 8, 1024, 8, 2, 128, None), (10, 8, 256, 8, 2, 128, 256)]
# recurrentgemma-9b's decode_step: one kv head of 16 queries, D=256, window
# 2048, over a 1024-slot cache and the 2048-slot ring; ring_case puts pos in
# [1, 2C), so most rows have wrapped their cache
MAIN_RING_256 = [(15, 8, 1024, 1, 16, 256, 2048),
                 (16, 8, 2048, 1, 16, 256, 2048)]
# the dropless MoE of full-width granite-moe-1b-a400m (E=32, D=1024, F=512)
# over an engine step's 64 rows and over 37 (a row-tile tail); and a width
# whose D (40) and F (24) are no multiple of the kernel's sub-tiles
MAIN_MOE = [(9, 32, 64, 1024, 512), (10, 32, 37, 1024, 512),
            (11, 3, 5, 40, 24)]
# mamba2-130m's prefill at full width (24 heads, P=64, N=128, chunk 256):
# the bucket of a 257..512-token admission, a ragged 300 with initial
# states at B=2; and chunks of 16 (the smoke config's) over a ragged 100
MAIN_SSD = [(9, 1, 512, 24, 64, 128, 256, False),
            (10, 2, 300, 24, 64, 128, 256, True),
            (11, 2, 100, 4, 32, 32, 16, True)]
SSD_REL_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-2}
# recurrentgemma-9b's RG-LRU scans (W=4096): an admission's 512-token
# bucket with and without a carried state, and the model API's batch of 8
MAIN_RGLRU = [(17, 1, 512, 4096, False), (18, 1, 512, 4096, True),
              (19, 8, 64, 4096, True)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PAGED_CASES + [MAIN_PAGED])
def test_paged_chunk_kernel_matches_plain(cuda_device, dtype, case):
    seed, B, T, Hkv, n_rep, D, P, n_pages, maxp = case
    arrs = paged_case(seed, B, T, Hkv, n_rep, D, P, n_pages, maxp)
    q, kp, vp = (torch.from_numpy(a).to(cuda_device, dtype) for a in arrs[:3])
    pt, pos = (torch.from_numpy(a).to(cuda_device) for a in arrs[3:])
    n = paged_ops.paged_decode_chunk.launches
    got = paged_ops.paged_decode_chunk(q, kp, vp, pt, pos, scale=D ** -0.5,
                                       n_rep=n_rep)
    torch.cuda.synchronize()
    assert paged_ops.paged_decode_chunk.launches == n + 1
    want = paged_decode_chunk_ref(q, kp, vp, pt, pos, scale=D ** -0.5,
                                  n_rep=n_rep)
    torch.testing.assert_close(got.float(), want.float(), **CARD_TOL[dtype])


def _paged_decode_inputs(case):
    """B3's inputs for a card case: the reference's sweep, PAGED_CASES at
    T=1 (lengths = pos + 1), PAGED_DECODE_CASES (valid pages past the
    length) and qwen3-0.6b's serving shapes (MAIN_PAGED_DECODE)."""
    if case == "sweep":
        return paged_decode_sweep(3) + (4,)
    if len(case) == 9 and case in PAGED_CASES + [MAIN_PAGED]:
        seed, B, _T, Hkv, n_rep, D, P, n_pages, maxp = case
        q, kp, vp, pt, pos = paged_case(seed, B, 1, Hkv, n_rep, D, P,
                                        n_pages, maxp)
        return q[:, 0], kp, vp, pt, pos + 1, n_rep
    seed, B, Hkv, n_rep, D, P, n_pages, maxp, spare = case
    return paged_decode_case(seed, B, Hkv, n_rep, D, P, n_pages, maxp,
                             spare) + (n_rep,)


# qwen3-0.6b's one-token decode over a served pool: B=8, 8 kv heads of 2,
# D=128, pages of 64 and a 16-entry table, two spare pages per row; and one
# 8192-token sequence (128 pages) whose splits span many blocks
MAIN_PAGED_DECODE = [(20, 8, 8, 2, 128, 64, 272, 16, 2),
                     (21, 1, 8, 2, 128, 64, 130, 128, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["sweep"] + PAGED_CASES + [MAIN_PAGED]
                         + PAGED_DECODE_CASES + MAIN_PAGED_DECODE)
def test_paged_decode_kernel_matches_plain(cuda_device, dtype, case):
    *arrs, n_rep = _paged_decode_inputs(case)
    q, kp, vp = (torch.from_numpy(a).to(cuda_device, dtype) for a in arrs[:3])
    pt, lengths = (torch.from_numpy(a).to(cuda_device) for a in arrs[3:])
    scale = q.shape[-1] ** -0.5
    n = paged_ops.paged_decode.launches
    got = paged_ops.paged_decode(q, kp, vp, pt, lengths, scale=scale,
                                 n_rep=n_rep)
    torch.cuda.synchronize()
    assert paged_ops.paged_decode.launches == n + 1
    want = paged_decode_ref(q, kp, vp, pt, lengths, scale=scale, n_rep=n_rep)
    torch.testing.assert_close(got.float(), want.float(), **CARD_TOL[dtype])
    # the same function as the paged chunk kernel at T=1, pos = lengths - 1
    chunk = paged_ops.paged_decode_chunk(q[:, None].contiguous(), kp, vp, pt,
                                         lengths - 1, scale=scale,
                                         n_rep=n_rep)[:, 0]
    torch.testing.assert_close(got.float(), chunk.float(), **CARD_TOL[dtype])


@pytest.mark.cuda
def test_kernels_launch_from_concurrent_threads(cuda_device):
    """Two threads (two engines' pump threads) launch the paged kernels at
    once with different shared-memory needs (B1 at T=1 and T=8, B3): every
    launch succeeds and gives the single-threaded result."""
    import threading

    cases = []
    for T in (1, 8):
        arrs = paged_case(30 + T, 4, T, 2, 2, 64, 16, 40, 8)
        q, kp, vp = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                     for a in arrs[:3])
        pt, pos = (torch.from_numpy(a).to(cuda_device) for a in arrs[3:])
        cases.append((q, kp, vp, pt, pos))
    args = dict(scale=0.125, n_rep=2)
    calls = [lambda c=c: paged_ops.paged_decode_chunk(*c, **args)
             for c in cases]
    calls.append(lambda c=cases[0]: paged_ops.paged_decode(
        c[0][:, 0].contiguous(), c[1], c[2], c[3], c[4] + 1, **args))
    want = [f() for f in calls]
    torch.cuda.synchronize()
    errors = []

    def hammer(order):
        try:
            for _ in range(200):
                for i in order:
                    got = calls[i]()
                    torch.cuda.current_stream().synchronize()
                    assert torch.equal(got, want[i])
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(o,))
               for o in ((0, 1, 2), (1, 2, 0))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors


@pytest.mark.cuda
def test_paged_decode_kernel_skips_pages_it_cannot_see(cuda_device):
    """Pool slots no row can see hold inf and NaN: the split kernel never
    reads them, and a split whose pages all lie past the length weighs 0."""
    q, kp, vp, pt, lengths = paged_decode_case(22, 4, 2, 2, 64, 16, 40, 8, 3)
    seen = np.zeros(kp.shape[:2], bool)
    for b in range(4):
        for tok in range(int(lengths[b])):
            seen[pt[b, tok // 16], tok % 16] = True
    dev = cuda_device
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    args = dict(scale=0.125, n_rep=2)
    base = paged_ops.paged_decode(t(q), t(kp), t(vp), t(pt), t(lengths),
                                  **args)
    kp[~seen], vp[~seen] = np.inf, np.nan
    got = paged_ops.paged_decode(t(q), t(kp), t(vp), t(pt), t(lengths),
                                 **args)
    torch.cuda.synchronize()
    assert torch.equal(got, base) and bool(torch.isfinite(got).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES + [MAIN_FLASH]
                         + MAIN_FLASH_256)
def test_flash_kernel_matches_plain(cuda_device, dtype, case):
    seed, BH, Sq, Skv, D, causal, window = case
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((BH, S, D)).astype(
        np.float32)).to(cuda_device, dtype) for S in (Sq, Skv, Skv))
    n = flash_ops.flash_attention_bhsd.launches
    got = flash_ops.flash_attention_bhsd(q, k, v, causal=causal,
                                         window=window)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention_bhsd.launches == n + 1
    want = flash_attention_bhsd_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **CARD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", RING_CASES + MAIN_RING + MAIN_RING_256)
def test_ring_kernel_matches_plain(cuda_device, dtype, case):
    seed, B, C, Hkv, n_rep, D, window = case
    arrs = ring_case(seed, B, C, Hkv, n_rep, D)
    q, ck, cv = (torch.from_numpy(a).to(cuda_device, dtype)
                 for a in arrs[:3])
    pos = torch.from_numpy(arrs[3]).to(cuda_device)
    n = paged_ops.decode_attention_kernel.launches
    got = paged_ops.decode_attention_kernel(q, ck, cv, pos, window=window,
                                            scale=D ** -0.5, n_rep=n_rep)
    torch.cuda.synchronize()
    assert paged_ops.decode_attention_kernel.launches == n + 1
    want = decode_ring_ref(q, ck, cv, pos, scale=D ** -0.5, n_rep=n_rep,
                           window=window)
    torch.testing.assert_close(got.float(), want.float(), **CARD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("case", RGLRU_CASES + MAIN_RGLRU)
def test_rglru_scan_kernel_matches_plain(cuda_device, case):
    seed, B, S, W, init = case
    a, b, h0 = (None if x is None else torch.from_numpy(x).to(cuda_device)
                for x in rglru_case(seed, B, S, W, init))
    n = scan_ops.rglru_scan.launches
    y, last = scan_ops.rglru_scan(a, b, h0)
    torch.cuda.synchronize()
    assert scan_ops.rglru_scan.launches == n + 1
    want_y, want_last = rglru_scan_ref(a, b, h0)
    assert torch.equal(y, want_y) and torch.equal(last, want_last)
    torch.testing.assert_close(y, want_y, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_rglru_scan_kernel_edges(cuda_device):
    """No steps gives h0 (or zeros) back; a layout the kernel does not
    take is refused on the card too."""
    a, b, h0 = (torch.from_numpy(x).to(cuda_device)
                for x in rglru_case(20, 2, 3, 40, True))
    y, last = scan_ops.rglru_scan(a[:, :0].contiguous(),
                                  b[:, :0].contiguous(), h0)
    torch.cuda.synchronize()
    assert y.shape == (2, 0, 40) and torch.equal(last, h0)
    _, last = scan_ops.rglru_scan(a[:, :0].contiguous(),
                                  b[:, :0].contiguous())
    assert not bool(last.any())
    with pytest.raises(ValueError, match="contiguous float32"):
        scan_ops.rglru_scan(a.bfloat16(), b.bfloat16())


def _moe_inputs(case, device, dtype, expanded):
    seed, E, C, D, F = case
    xe, wg, wu, wd = (torch.from_numpy(a).to(device, dtype)
                      for a in moe_case(seed, E, C, D, F))
    if expanded:          # one [C,D] block seen by every expert, no copy
        xe = xe[:1].expand(E, C, D)
    return xe, wg, wu, wd


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("expanded", [False, True])
@pytest.mark.parametrize("case", MOE_CASES + MAIN_MOE)
def test_moe_ffn_kernel_matches_plain(cuda_device, dtype, expanded, case):
    args = _moe_inputs(case, cuda_device, dtype, expanded)
    n = moe_ops.moe_ffn.launches
    got = moe_ops.moe_ffn(*args)
    torch.cuda.synchronize()
    assert moe_ops.moe_ffn.launches == n + 1
    torch.testing.assert_close(got.float(), moe_ffn_ref(*args).float(),
                               **CARD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_rows_do_not_depend_on_the_batch(cuda_device, dtype):
    """Every row of a 64-row launch at granite's full width equals,
    bitwise, the same row launched alone and in blocks of 8."""
    xe, wg, wu, wd = _moe_inputs(MAIN_MOE[0], cuda_device, dtype, False)
    E, C, D = xe.shape
    x = xe[0]
    full = moe_ops.moe_ffn(x.expand(E, C, D), wg, wu, wd)
    for width in (1, 8):
        for c0 in range(0, C, width):
            part = moe_ops.moe_ffn(x[c0:c0 + width].expand(E, width, D),
                                   wg, wu, wd)
            assert torch.equal(part, full[:, c0:c0 + width]), (width, c0)


def _ssd_inputs(case, device, dtype):
    seed, B, S, H, P, N, chunk, init = case
    x, dt, A, Bm, Cm, h0 = ssd_case(seed, B, S, H, P, N, init)
    return ([torch.from_numpy(x).to(device, dtype),
             torch.from_numpy(dt).to(device), torch.from_numpy(A).to(device),
             torch.from_numpy(Bm).to(device, dtype),
             torch.from_numpy(Cm).to(device, dtype)],
            None if h0 is None else torch.from_numpy(h0).to(device), chunk)


def _rel(got, want):
    """The largest difference over the largest reference value."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_CASES + MAIN_SSD)
def test_ssd_kernel_matches_plain(cuda_device, dtype, case):
    args, h0, chunk = _ssd_inputs(case, cuda_device, dtype)
    n = ssd_ops.ssd_chunk_scan.launches
    y, final = ssd_ops.ssd_chunk_scan(*args, chunk=chunk, init_state=h0)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_chunk_scan.launches == n + 1
    want_y, want_final = ssd_chunked_ref(*args, chunk, h0)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(final).all())
    assert _rel(y, want_y) <= SSD_REL_TOL[dtype]
    assert _rel(final, want_final) <= 1e-3
    if dtype == torch.float32:
        seq_y, seq_final = ssd_sequential(*args, init_state=h0)
        assert _rel(y, seq_y) <= 1e-3 and _rel(final, seq_final) <= 1e-3


@pytest.mark.cuda
def test_ssd_kernel_reads_strided_rows_in_place(cuda_device):
    """x, Bm and Cm as slices of one [B,S,H*P+2N] buffer, as the model
    hands them over, give the contiguous copies' results bitwise."""
    args, _, chunk = _ssd_inputs(MAIN_SSD[2], cuda_device, torch.bfloat16)
    x, dt, A, Bm, Cm = args
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    buf = torch.cat([x.reshape(B, S, H * P), Bm, Cm], dim=-1)
    xs, bs, cs = torch.split(buf, [H * P, N, N], dim=-1)
    got = ssd_ops.ssd_chunk_scan(xs.reshape(B, S, H, P), dt, A, bs, cs,
                                 chunk=chunk)
    want = ssd_ops.ssd_chunk_scan(x, dt, A, Bm, Cm, chunk=chunk)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(2, 1, 4, 32, device=cuda_device, dtype=torch.float16)
    kp = torch.zeros(4, 8, 2, 32, device=cuda_device, dtype=torch.float16)
    pt = torch.zeros(2, 2, device=cuda_device, dtype=torch.int32)
    pos = torch.zeros(2, device=cuda_device, dtype=torch.int32)
    with pytest.raises(ValueError, match="bf16 or f32"):
        paged_ops.paged_decode_chunk(q, kp, kp, pt, pos, scale=1.0, n_rep=2)
    with pytest.raises(ValueError, match="int32"):
        paged_ops.paged_decode_chunk(q.float(), kp.float(), kp.float(),
                                     pt.long(), pos, scale=1.0, n_rep=2)
    with pytest.raises(ValueError, match="bf16 or f32"):
        paged_ops.paged_decode(q[:, 0].contiguous(), kp, kp, pt, pos,
                               scale=1.0, n_rep=2)
    with pytest.raises(ValueError, match="head dim"):
        paged_ops.paged_decode(
            torch.zeros(1, 2, 36, device=cuda_device, dtype=torch.bfloat16),
            torch.zeros(2, 8, 1, 36, device=cuda_device, dtype=torch.bfloat16),
            torch.zeros(2, 8, 1, 36, device=cuda_device, dtype=torch.bfloat16),
            pt[:1], pos[:1], scale=1.0, n_rep=2)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros(2, 512, 1, 256, device=cuda_device)
        paged_ops.paged_decode(torch.zeros(1, 2, 256, device=cuda_device),
                               big, big, pt[:1], pos[:1], scale=1.0, n_rep=2)
    x = torch.zeros(2, 8, 264, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_ops.flash_attention_bhsd(x, x, x)
    ring = dict(window=None, scale=1.0, n_rep=2)
    ck = torch.zeros(2, 8, 2, 32, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="bf16 or f32"):
        paged_ops.decode_attention_kernel(q, ck, ck, pos, **ring)
    q, ck = q.float(), ck.float()
    with pytest.raises(ValueError, match="int32"):
        paged_ops.decode_attention_kernel(q, ck, ck, pos.long(), **ring)
    with pytest.raises(ValueError, match="contiguous"):
        paged_ops.decode_attention_kernel(q, ck.transpose(1, 2).contiguous()
                                          .transpose(1, 2), ck, pos, **ring)
    with pytest.raises(ValueError, match="head dim"):
        paged_ops.decode_attention_kernel(q[..., :30].contiguous(),
                                          ck[..., :30].contiguous(),
                                          ck[..., :30].contiguous(), pos,
                                          **ring)
    with pytest.raises(ValueError, match="shared memory"):
        paged_ops.decode_attention_kernel(
            torch.zeros(1, 1, 256, 128, device=cuda_device),
            torch.zeros(1, 8, 1, 128, device=cuda_device),
            torch.zeros(1, 8, 1, 128, device=cuda_device), pos[:1],
            window=None, scale=1.0, n_rep=256)
    xe = torch.zeros(2, 3, 16, device=cuda_device, dtype=torch.float16)
    w = torch.zeros(2, 16, 8, device=cuda_device, dtype=torch.float16)
    wd = torch.zeros(2, 8, 16, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="bf16 or f32"):
        moe_ops.moe_ffn(xe, w, w, wd)
    xe, w, wd = xe.bfloat16(), w.bfloat16(), wd.bfloat16()
    with pytest.raises(ValueError, match="expert stride"):
        moe_ops.moe_ffn(xe.transpose(0, 1).contiguous().transpose(0, 1),
                        w, w, wd)
    with pytest.raises(ValueError, match="contiguous"):
        moe_ops.moe_ffn(xe, w, w, wd.transpose(1, 2).contiguous()
                        .transpose(1, 2))
    with pytest.raises(ValueError, match="multiples of 8"):
        moe_ops.moe_ffn(xe[..., :12].contiguous(), w[:, :12].contiguous(),
                        w[:, :12].contiguous(), wd[..., :12].contiguous())
    big = torch.zeros(1, 8, 4096, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        moe_ops.moe_ffn(torch.zeros(1, 2, 8, device=cuda_device), big, big,
                        torch.zeros(1, 4096, 8, device=cuda_device))
    args, _, _ = _ssd_inputs((0, 1, 8, 2, 16, 8, 8, False), cuda_device,
                             torch.float32)
    x, dt, A, Bm, Cm = args
    with pytest.raises(ValueError, match="multiple of 16"):
        ssd_ops.ssd_chunk_scan(x[..., :8].contiguous(), dt, A, Bm, Cm,
                               chunk=8)
    wide = torch.zeros(1, 8, 160, device=cuda_device)
    with pytest.raises(ValueError, match="ssm_state <= 128"):
        ssd_ops.ssd_chunk_scan(x, dt, A, wide, wide, chunk=8)
    args, _, _ = _ssd_inputs((0, 1, 300, 2, 16, 8, 300, False), cuda_device,
                             torch.float32)
    with pytest.raises(ValueError, match="chunks <= 256"):
        ssd_ops.ssd_chunk_scan(*args, chunk=300)
