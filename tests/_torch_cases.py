"""Kernel test cases shared by the port's CPU and card kernel tests.

The cases cover the hazards of the kernels: permuted page tables, -1
padding, ragged positions, partial tail pages, valid pages wholly past a
sequence's length, chunk lengths and sequence
lengths that are no multiple of any tile, the paged split kernels' edges,
a windowed and a non-causal
attention, ring caches whose positions wrap past the cache length
(twice), with windows below, at and above it, the ring kernel's split
edges, expert-FFN row counts and widths that are no multiple of the
kernel's tiles, SSD sequences with a
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


# The paged split kernel's edges (splits of 128 table positions in bf16,
# 64 in float32): R = T * n_rep = 144, 256 (qwen3-moe-235b's 4 kv heads of
# 16 queries) and 150 (no multiple of the 16-row m-tile) rows, past the
# old 128-row cap; chunks that straddle a split boundary (120..128,
# 250..265, 62..64, 125..132); pos = 0; -1 entries inside a split below a
# row's position; splits wholly past every row (positions below 104 of
# 384); a split whose every entry is -1 below the rows' positions; n_rep 3
# (15 rows, one padded m-tile); a head dim (40) no multiple of 16; pages
# of 4, 8, 16 and 64; pages of 48, which no split boundary lines up with
# (a split straddles two pages), with a -1 entry; and pages of 256, each
# spanning several splits.
PAGED_SPLIT_EDGES = [
    # seed, T, Hkv, n_rep, D, P, maxp, pos, holes ((b, entry) set to -1)
    (40, 9, 1, 16, 64, 16, 12, (0, 120, 183), ()),
    (41, 16, 4, 16, 32, 64, 5, (0, 57, 250, 303), ()),
    (42, 3, 2, 2, 40, 4, 40, (0, 62, 130, 155), ((1, 3), (2, 20), (3, 0))),
    (43, 5, 2, 3, 32, 16, 24, (0, 20, 60, 99), ()),
    (44, 8, 2, 2, 32, 64, 6, (0, 125, 250, 370), ()),
    (45, 2, 1, 4, 32, 8, 32, (200, 140),
     tuple((0, e) for e in range(16))),
    (46, 10, 1, 15, 32, 16, 10, (0, 117, 140), ()),
    (47, 4, 2, 2, 32, 48, 8, (0, 125, 250, 380), ((2, 1),)),
    (48, 6, 1, 4, 32, 256, 3, (0, 130, 600), ()),
]


def paged_split_case(seed, T, Hkv, n_rep, D, P, maxp, pos, holes=(),
                     spare=2):
    """q [B,T,H,D] (B = len(pos)) and pools of unit normals whose table
    row b holds the pages of positions 0 .. pos[b]+T-1, drawn from a
    permutation of the pool, and -1 past them; the (b, entry) of
    ``holes`` set to -1; ``spare`` pool pages no table holds."""
    rng = np.random.default_rng(seed)
    B, H = len(pos), Hkv * n_rep
    need = [-(-(p + T) // P) for p in pos]
    assert max(need) <= maxp
    n_pages = sum(need) + spare
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    kp = rng.standard_normal((n_pages, P, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, P, Hkv, D)).astype(np.float32)
    perm = rng.permutation(n_pages)
    pt = np.full((B, maxp), -1, np.int32)
    used = 0
    for b, n in enumerate(need):
        pt[b, :n] = perm[used:used + n]
        used += n
    for b, e in holes:
        pt[b, e] = -1
    return q, kp, vp, pt, np.asarray(pos, np.int32)


def paged_chunk_inputs(case):
    """(q, k_pages, v_pages, page_table, pos, n_rep) of a ``PAGED_CASES``
    or ``PAGED_SPLIT_EDGES`` entry (an edge's eighth field is its pos)."""
    if isinstance(case[7], tuple):
        return paged_split_case(*case) + (case[3],)
    seed, B, T, Hkv, n_rep, D, P, n_pages, maxp = case
    return paged_case(seed, B, T, Hkv, n_rep, D, P, n_pages, maxp) + (n_rep,)


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


# The one-token paged decode's split edges: seed, Hkv, n_rep, D, P, maxp,
# lengths, holes ((b, entry) set to -1 below the row's length).  Lengths
# 127, 128 and 129 on either side of a bf16 split boundary (and of the
# second f32 one); pages of 48, which no split boundary lines up with (a
# split straddles two pages); pages of 256, each spanning two bf16 splits
# (four f32); a row of one token; a row filling its whole table; -1
# entries past each row's length (the tables are -1 padded) and below it;
# qwen3's 16-entry table of 64-token pages at a head dim of 32.
PAGED_DECODE_SPLIT_EDGES = [
    (60, 2, 2, 32, 48, 8, (127, 128, 129, 1, 300, 384), ()),
    (61, 1, 4, 64, 256, 3, (127, 128, 129, 700), ()),
    (62, 2, 2, 32, 16, 24, (128, 129, 127, 380), ((0, 2), (3, 10))),
    (63, 2, 2, 32, 64, 16, (1, 64, 65, 1000, 1024), ()),
]


def paged_decode_inputs(case):
    """(q, k_pages, v_pages, page_table, lengths, n_rep) as numpy of
    ``"sweep"`` (the reference's sweep), a ``PAGED_DECODE_CASES`` entry or
    a ``PAGED_DECODE_SPLIT_EDGES`` entry (a table holding the pages of
    positions below each length, -1 past them and at its holes, and two
    spare pool pages)."""
    if case == "sweep":
        return paged_decode_sweep(3) + (4,)
    if isinstance(case[6], tuple):
        seed, Hkv, n_rep, D, P, maxp, lengths, holes = case
        q, kp, vp, pt, pos = paged_split_case(
            seed, 1, Hkv, n_rep, D, P, maxp,
            tuple(n - 1 for n in lengths), holes)
        return q[:, 0], kp, vp, pt, pos + 1, n_rep
    seed, B, Hkv, n_rep, D, P, n_pages, maxp, spare = case
    return paged_decode_case(seed, B, Hkv, n_rep, D, P, n_pages, maxp,
                             spare) + (n_rep,)


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

# The split kernel's edges (splits of 128 slots in bf16, 64 in float32):
# caches of 40 and 96 slots (below one bf16 split), 130 and 200 (no
# multiple of either split), positions 0, C-1, C (the ring's wrap onto
# slot 0) and >= 2C, window edges inside a split, window 1, windows above
# C, recurrentgemma's group (n_rep 16, D 256) at a small B and C, a head
# dim (40) no multiple of 16 with n_rep 3, and n_rep 20 (two m-tiles of 16
# rows).
RING_SPLIT_EDGES = [
    # seed, B, C, Hkv, n_rep, D, window, pos
    (20, 4, 40, 2, 2, 32, None, (0, 39, 40, 85)),
    (21, 4, 40, 2, 2, 32, 16, (0, 39, 40, 85)),
    (22, 4, 96, 1, 4, 64, 48, (0, 95, 96, 200)),
    (23, 5, 200, 2, 2, 32, 70, (0, 199, 200, 450, 130)),
    (24, 4, 96, 2, 2, 32, 1, (0, 63, 64, 300)),
    (25, 5, 200, 1, 4, 64, 500, (0, 199, 200, 401, 1000)),
    (26, 4, 200, 2, 2, 64, None, (0, 199, 200, 450)),
    (27, 2, 96, 1, 16, 256, 80, (50, 250)),
    (28, 2, 130, 1, 16, 256, None, (129, 300)),
    (29, 4, 130, 2, 3, 40, 64, (0, 129, 130, 300)),
    (30, 3, 70, 1, 20, 64, 30, (5, 69, 150)),
]


def ring_inputs(case):
    """(q, cache_k, cache_v, pos, n_rep, window) of a ``RING_CASES`` or
    ``RING_SPLIT_EDGES`` entry; an edge's positions replace the drawn ones
    (its B is their count)."""
    seed, B, C, Hkv, n_rep, D, window = case[:7]
    q, ck, cv, pos = ring_case(seed, B, C, Hkv, n_rep, D)
    if len(case) > 7:
        pos = np.asarray(case[7], np.int32)
    return q, ck, cv, pos, n_rep, window


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
