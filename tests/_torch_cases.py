"""Kernel test cases shared by the port's CPU and card kernel tests.

The cases cover the hazards of the kernels: permuted page tables, -1
padding, ragged positions, partial tail pages, valid pages wholly past a
sequence's length, chunk lengths and sequence
lengths that are no multiple of any tile, a windowed and a non-causal
attention, ring caches whose positions wrap past the cache length
(twice), with windows below, at and above it, expert-FFN row counts and
widths that are no multiple of the kernel's tiles, SSD sequences with a
ragged last chunk, a chunk longer than the sequence and an initial state,
and RG-LRU scans over sequences and widths that are no multiple of any
block, with and without an initial state.  Inputs come from numpy seeds.
"""

import numpy as np
import torch

# In a CPU process where JAX has already run a computation, the first MKL
# vector-math call (torch.exp, torch.sin, ...) on each intra-op thread
# sometimes comes out inaccurate, up to ~1.5e-4 relative; every later call,
# of any such function, is exact, and nothing of the kind happens with one
# thread, without JAX, or when such a call came first.  One float32
# torch.exp spread over every thread (1M elements: the vector-math kernels
# hand out chunks of 2048) takes that first call here, when the test
# modules are imported, so the tests' float32 tolerances hold in any order.
torch.exp(torch.zeros(1 << 20))


def paged_case(seed, B, T, Hkv, n_rep, D, P, n_pages, maxp):
    """Random q and pools with permuted tables, -1 tail padding and ragged
    pos; every row's visible positions lie on real pages."""
    rng = np.random.default_rng(seed)
    H = Hkv * n_rep
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    kp = rng.standard_normal((n_pages, P, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, P, Hkv, D)).astype(np.float32)
    pos = rng.integers(0, maxp * P - T + 1, B).astype(np.int32)
    perm = rng.permutation(n_pages)
    pt = np.full((B, maxp), -1, np.int32)
    used = 0
    for b in range(B):
        need = -(-(int(pos[b]) + T) // P)
        pt[b, :need] = perm[used:used + need]
        used += need
    assert used <= n_pages
    return q, kp, vp, pt, pos


PAGED_CASES = [
    # seed, B, T, Hkv, n_rep, D, P, n_pages, maxp
    (0, 3, 1, 2, 2, 32, 8, 24, 6),
    (1, 2, 3, 2, 4, 32, 8, 24, 8),
    (2, 4, 8, 1, 2, 16, 4, 40, 9),
    (3, 2, 5, 2, 1, 32, 16, 12, 5),
]


def paged_decode_case(seed, B, Hkv, n_rep, D, P, n_pages, maxp, spare=0):
    """One-token paged decode inputs: q [B,H,D], pools, ragged lengths in
    [1, (maxp - spare) * P] (partial last pages), tables drawn as a random
    permutation of the pool's pages and -1 padded, each row holding up to
    ``spare`` further valid pages wholly past its length."""
    rng = np.random.default_rng(seed)
    H = Hkv * n_rep
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((n_pages, P, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, P, Hkv, D)).astype(np.float32)
    lengths = rng.integers(1, (maxp - spare) * P + 1, B).astype(np.int32)
    perm = rng.permutation(n_pages)
    pt = np.full((B, maxp), -1, np.int32)
    used = 0
    for b in range(B):
        need = -(-int(lengths[b]) // P) + int(rng.integers(0, spare + 1))
        pt[b, :need] = perm[used:used + need]
        used += need
    assert used <= n_pages
    return q, kp, vp, pt, lengths


def paged_decode_sweep(seed):
    """The reference's one-token paged decode sweep (tests/test_kernels.py):
    B=3, 2 kv heads of 4 queries, D=64, 24 pages of 64, fixed -1 padded
    tables and lengths 150, 300, 17; unit-normal inputs from ``seed``."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((3, 8, 64)).astype(np.float32)
    kp = rng.standard_normal((24, 64, 2, 64)).astype(np.float32)
    vp = rng.standard_normal((24, 64, 2, 64)).astype(np.float32)
    pt = np.array([[3, 7, 11, -1, -1], [0, 1, 2, 4, 6],
                   [5, -1, -1, -1, -1]], np.int32)
    lengths = np.array([150, 300, 17], np.int32)
    return q, kp, vp, pt, lengths


PAGED_DECODE_CASES = [
    # seed, B, Hkv, n_rep, D, P, n_pages, maxp, spare: the shapes of the
    # reference's fuzz (pages of 4..16, D of 8..32, GQA groups of 1..4),
    # with valid pages wholly past a row's length
    (0, 1, 1, 1, 8, 4, 8, 3, 0),
    (1, 4, 3, 4, 32, 16, 30, 5, 1),
    (2, 3, 2, 2, 16, 8, 24, 6, 2),
    (3, 2, 1, 4, 32, 4, 20, 8, 3),
    (4, 4, 2, 1, 16, 16, 26, 4, 1),
    (5, 2, 3, 3, 8, 8, 16, 7, 2),
]


FLASH_CASES = [
    # seed, BH, Sq, Skv, D, causal, window
    (0, 3, 17, 17, 32, True, None),
    (1, 2, 100, 100, 16, True, None),
    (2, 2, 70, 70, 32, True, 9),
    (3, 1, 33, 45, 32, False, None),
]


def ring_case(seed, B, C, Hkv, n_rep, D):
    """Random q [B,1,H,D] and caches [B,C,Hkv,D]; pos in [1, 2C), so rows
    sit below, at and past the cache length (the ring has wrapped)."""
    rng = np.random.default_rng(seed)
    H = Hkv * n_rep
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    ck = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
    cv = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
    pos = rng.integers(1, 2 * C, B).astype(np.int32)
    return q, ck, cv, pos


RING_CASES = [
    # seed, B, C, Hkv, n_rep, D, window: the reference's own decode-ring
    # sweep (tests/test_kernels.py), windows None and 48
    (0, 2, 128, 1, 4, 64, None),
    (1, 2, 128, 1, 4, 64, 48),
    (2, 3, 256, 2, 2, 32, None),
    (3, 3, 256, 2, 2, 32, 48),
    (4, 1, 96, 4, 1, 128, None),
    (5, 1, 96, 4, 1, 128, 48),
    # a window above the cache length and positions past 2C
    (6, 4, 40, 2, 2, 32, 64),
]


def moe_case(seed, E, C, D, F):
    """Random capacity buffers xe [E,C,D] (scale 0.5) and expert weights
    w_gate/w_up [E,D,F], w_down [E,F,D] (scale 0.1), the scales of the
    reference's own sweep."""
    rng = np.random.default_rng(seed)
    xe = (rng.standard_normal((E, C, D)) * 0.5).astype(np.float32)
    wg, wu = ((rng.standard_normal((E, D, F)) * 0.1).astype(np.float32)
              for _ in range(2))
    wd = (rng.standard_normal((E, F, D)) * 0.1).astype(np.float32)
    return xe, wg, wu, wd


MOE_CASES = [
    # seed, E, C, D, F: the reference's moe_ffn sweep (tests/test_kernels.py)
    (0, 2, 128, 64, 128),
    (1, 3, 200, 32, 96),
    (2, 1, 64, 128, 64),
]


def ssd_case(seed, B, S, H, P, N, init=False):
    """The scales of the reference's SSD sweep: x [B,S,H,P] * 0.5, dt =
    softplus(normal) [B,S,H], A = |normal| + 0.1 [H], Bm/Cm [B,S,N] * 0.3,
    all float32; and, with ``init``, an initial state [B,H,P,N] * 0.5."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    dt = np.logaddexp(0.0, rng.standard_normal((B, S, H))).astype(np.float32)
    A = (np.abs(rng.standard_normal(H)) + 0.1).astype(np.float32)
    Bm, Cm = ((rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
              for _ in range(2))
    h0 = ((rng.standard_normal((B, H, P, N)) * 0.5).astype(np.float32)
          if init else None)
    return x, dt, A, Bm, Cm, h0


SSD_CASES = [
    # seed, B, S, H, P, N, chunk, init: the reference's ssd sweep
    # (tests/test_kernels.py), a ragged last chunk (193 = 3 x 64 + 1), a
    # chunk longer than the sequence, and initial states
    (0, 1, 128, 2, 32, 64, 64, False),
    (1, 2, 256, 3, 64, 128, 128, False),
    (2, 1, 192, 1, 16, 32, 64, False),
    (3, 1, 193, 2, 32, 32, 64, False),
    (4, 2, 40, 2, 16, 16, 64, True),
    (5, 2, 100, 3, 32, 64, 32, True),
]


def rglru_case(seed, B, S, W, init=False):
    """The scales of the reference's RG-LRU sweep: decays a uniform on
    (0.7, 0.999), inputs b * 0.1, and, with ``init``, a unit-normal
    initial state [B,W]; all float32."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.7, 0.999, (B, S, W)).astype(np.float32)
    b = (rng.standard_normal((B, S, W)) * 0.1).astype(np.float32)
    h0 = (rng.standard_normal((B, W)).astype(np.float32) if init else None)
    return a, b, h0


RGLRU_CASES = [
    # seed, B, S, W, init: the reference's sweep (tests/test_kernels.py),
    # with and without h0, a ragged sequence and width, and a single step
    (0, 1, 64, 32, False),
    (1, 2, 300, 96, True),
    (2, 3, 128, 256, False),
    (3, 3, 128, 256, True),
    (4, 2, 37, 40, True),
    (5, 2, 1, 8, True),
]
