"""Wrappers of the decode attention kernels: split-KV paged chunk
attention and the one-token paged decode, which is the same kernel at one
token (``csrc/paged_chunk.cu``), and split-KV ring decode attention
(``csrc/decode_ring.cu``).  Both kernels run the split block of
``csrc/split_attention.cuh`` over fixed splits of ``SPLIT[dtype]`` keys,
then the merge of ``csrc/split_merge.cuh``.

A CUDA tensor launches the hand-written kernel and the call raises if it
cannot; a CPU tensor takes the plain version in :mod:`.ref`.  Nothing else
chooses between them.  ``paged_decode_chunk.launches``,
``paged_decode.launches`` and ``decode_attention_kernel.launches`` count
the wrappers' calls that launched their kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build, refuse_autograd
from .ref import decode_ring_ref, paged_decode_chunk_ref, paged_decode_ref

_SMEM_LIMIT = 232_448     # bytes of shared memory a block may use (H100)

# keys of one split of the split-KV kernels (B1, B3 and B4), by type: 128 on
# the tensor cores (bf16), 64 on the CUDA cores (f32, whose 128 keys of K
# and V would not fit in shared memory at D = 256) (must match
# ``Split<T>::kSplit`` in csrc/split_attention.cuh)
SPLIT = {torch.bfloat16: 128, torch.float32: 64}


def _split_smem_bytes(D: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one split block (must match
    ``Split<T>::smem_bytes``): the split's key offsets (int64), then in
    bf16 one 16-row q tile and the split's K and V rows, padded to a
    multiple of 16 columns plus 8, one m-tile's f32 scores and P hi / lo;
    in f32 K, V, one 16-row q tile and its scores.  It depends on D and the
    type alone, not on the query rows."""
    S = SPLIT[dtype]
    if dtype == torch.bfloat16:
        st = -(-D // 16) * 16 + 8
        return 8 * S + 2 * (16 + 2 * S) * st + 4 * 16 * (S + 8) \
            + 2 * 2 * 16 * (S + 8)
    return 8 * S + 4 * (2 * S * D + 16 * D + 16 * S)


@functools.lru_cache(maxsize=None)
def _check_split_block(D: int, dtype: torch.dtype) -> None:
    smem = _split_smem_bytes(D, dtype)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"a split of {SPLIT[dtype]} keys of head dim {D} "
                         f"needs {smem} bytes of shared memory (limit "
                         f"{_SMEM_LIMIT})")


# splits the merge takes: it keeps a row's weights in 32 KB of shared
# memory (must match ``split_merge::kMaxSplits`` in csrc/split_merge.cuh)
MERGE_MAX_SPLITS = 8192


def _split_scratch(rows: int, n_splits: int, D: int, device):
    """One f32 buffer: ``part_acc`` [rows, n_splits, D], then ``part_ml``
    [rows, n_splits, 2].  Returns it and the addresses of the two."""
    if n_splits > MERGE_MAX_SPLITS:
        raise ValueError(f"{n_splits} splits exceed the merge's "
                         f"{MERGE_MAX_SPLITS}")
    scratch = torch.empty(rows * n_splits * (D + 2), dtype=torch.float32,
                          device=device)
    part_acc = scratch.data_ptr()
    return scratch, part_acc, part_acc + 4 * rows * n_splits * D


def paged_splits(max_pages: int, P: int, dtype: torch.dtype) -> int:
    """Splits of a table of ``max_pages`` entries of P-token pages: split
    s holds the table's positions [s * S, min(max_pages * P, (s + 1) * S))
    with S = ``SPLIT[dtype]`` (S / P whole entries when P divides S).  It
    depends on the table's width, P and the type alone, never on the
    batch, the chunk length, the positions or the entries (must match the
    kernel)."""
    return -(-(max_pages * P) // SPLIT[dtype])


def paged_scratch(rows: int, max_pages: int, P: int, D: int,
                  dtype: torch.dtype, device):
    """The paged split kernels' f32 scratch for ``rows`` = B*T*H query
    rows (B*H for the one-token decode), one buffer: ``part_acc`` [rows,
    n_splits, D], then ``part_ml`` [rows, n_splits, 2], with n_splits =
    ``paged_splits(max_pages, P, dtype)``; row (b*T + t)*H + head is row
    (b, t, head) of q and out.  Returns the buffer and the addresses of
    the two."""
    return _split_scratch(rows, paged_splits(max_pages, P, dtype), D,
                          device)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("paged_chunk")
    fn = lib.paged_chunk_attention
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.paged_chunk_error_string.argtypes = [ctypes.c_int]
    lib.paged_chunk_error_string.restype = ctypes.c_char_p
    return fn, lib.paged_chunk_error_string


def paged_decode_chunk(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       pos: torch.Tensor, *, scale: float,
                       n_rep: int) -> torch.Tensor:
    """Chunk attention straight over the KV pool.

    q [B,T,H,D]; pages [n_pages,P,Hkv,D]; page_table [B,max_pages] int32
    (-1 = no page); pos [B] int32, each sequence's first chunk position.
    The chunk's own K/V must already be in the pages.  Rows past a
    sequence's valid length return garbage; callers discard them.
    -> [B,T,H,D].  The layout checks hold on every device, so the CPU path
    takes exactly what the kernel takes.

    On the card one call is two kernel launches, the split kernel over
    ``paged_splits(max_pages, P, q.dtype)`` splits of the table and the
    merge, and counts once in ``paged_decode_chunk.launches``.  Any number
    of rows T*n_rep is taken: the kernel walks them in tiles of 16."""
    B, T, H, D = q.shape
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError("k_pages/v_pages must both be [n_pages,P,Hkv,D]")
    _n, P, Hkv, Dk = k_pages.shape
    if Dk != D or H != Hkv * n_rep:
        raise ValueError(f"q {tuple(q.shape)} does not match pages "
                         f"{tuple(k_pages.shape)} with n_rep={n_rep}")
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or tuple(pos.shape) != (B,):
        raise ValueError("page_table must be [B,max_pages] and pos [B]")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("q and pages must share one type, bf16 or f32")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("page_table and pos must be int32")
    refuse_autograd("paged_decode_chunk", q, k_pages, v_pages)
    if q.device.type == "cpu":
        return paged_decode_chunk_ref(q, k_pages, v_pages, page_table, pos,
                                      scale=scale, n_rep=n_rep)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_chunk: unsupported device {q.device}")
    vec = 16 // q.element_size()
    q_ptr, k_ptr, v_ptr = q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()
    if D % vec or (q_ptr | k_ptr | v_ptr) % 16:
        raise ValueError(f"head dim must be a multiple of {vec} and the "
                         f"tensors 16-byte aligned")
    _check_split_block(D, q.dtype)
    out = torch.empty_like(q)
    maxp = page_table.shape[1]
    if B == 0 or T == 0:
        return out
    if maxp == 0:
        return out.zero_()
    dev = q.device
    # held until the launches are queued
    scratch, part_acc, part_ml = paged_scratch(B * T * H, maxp, P, D,
                                               q.dtype, dev)
    fn, err_str = _kernel()
    with torch.cuda.device(dev):
        stream = _build.current_stream(dev)
        err = fn(q_ptr, k_ptr, v_ptr, page_table.data_ptr(), pos.data_ptr(),
                 part_acc, part_ml, out.data_ptr(), B, T, Hkv, n_rep, D, P,
                 maxp, float(scale), int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"paged_chunk_attention launch failed: "
                           f"{err_str(err).decode()} (cuda error {err})")
    paged_decode_chunk.launches += 1
    return out


paged_decode_chunk.launches = 0


# ------------------------------------------------------- paged decode (B3)
@functools.lru_cache(maxsize=None)
def _decode_kernel():
    fn = _build.load("paged_chunk").paged_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, _kernel()[1]


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, page_table: torch.Tensor,
                 lengths: torch.Tensor, *, scale: float,
                 n_rep: int) -> torch.Tensor:
    """One-token attention straight over the KV pool.

    q [B,H,D] with H = Hkv*n_rep; pages [n_pages,P,Hkv,D]; page_table
    [B,max_pages] int32 (-1 = no page: the kernel skips it, the plain
    version reads page 0, as the reference's kernel and oracle do; no
    caller puts one below a sequence's length); lengths [B] int32, the
    visible tokens of each sequence.  -> [B,H,D] in q's type.

    A row with ``lengths[b] == 0`` sees no token; no caller sends one.
    The CUDA kernel returns zeros for it, the plain version (gather, then
    attention at ``pos = -1``) the mean of V over the gathered window.

    On the card one call is two kernel launches, the split kernel over
    ``paged_splits(max_pages, P, q.dtype)`` fixed splits of the table (the
    paged chunk kernel itself at T=1, with the n_rep query heads of a kv
    head as a block's rows) and the merge, and counts once in
    ``paged_decode.launches``.  Each row is bitwise what
    ``paged_decode_chunk`` gives at T=1 with ``pos = lengths - 1``, and the
    same at any batch.  Shared memory depends on D and the type alone, so
    any page size is taken.  The layout checks hold on every device, so
    the CPU path takes exactly what the kernel takes."""
    if q.dim() != 3:
        raise ValueError(f"q must be [B,H,D], got {tuple(q.shape)}")
    B, H, D = q.shape
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError("k_pages/v_pages must both be [n_pages,P,Hkv,D]")
    _n, P, Hkv, Dk = k_pages.shape
    if Dk != D or H != Hkv * n_rep:
        raise ValueError(f"q {tuple(q.shape)} does not match pages "
                         f"{tuple(k_pages.shape)} with n_rep={n_rep}")
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError("page_table must be [B,max_pages] and lengths [B]")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("q and pages must share one type, bf16 or f32")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("page_table and lengths must be int32")
    refuse_autograd("paged_decode", q, k_pages, v_pages)
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pages, v_pages, page_table, lengths,
                                scale=scale, n_rep=n_rep)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode: unsupported device {q.device}")
    vec = 16 // q.element_size()
    q_ptr, k_ptr, v_ptr = q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()
    if D % vec or (q_ptr | k_ptr | v_ptr) % 16:
        raise ValueError(f"head dim must be a multiple of {vec} and the "
                         f"tensors 16-byte aligned")
    _check_split_block(D, q.dtype)
    maxp = page_table.shape[1]
    out = torch.empty_like(q)
    if B == 0 or maxp == 0:
        return out.zero_()
    dev = q.device
    # held until the launches are queued
    scratch, part_acc, part_ml = paged_scratch(B * H, maxp, P, D, q.dtype,
                                               dev)
    fn, err_str = _decode_kernel()
    with torch.cuda.device(dev):
        stream = _build.current_stream(dev)
        err = fn(q_ptr, k_ptr, v_ptr, page_table.data_ptr(),
                 lengths.data_ptr(), part_acc, part_ml, out.data_ptr(), B,
                 Hkv, n_rep, D, P, maxp, float(scale),
                 int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: "
                           f"{err_str(err).decode()} (cuda error {err})")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0
# the reference's entry name (``kernels/paged_attention/ops.py``)
paged_decode_attention = paged_decode


# ------------------------------------------------------------- ring decode
def ring_splits(C: int, dtype: torch.dtype) -> int:
    """Splits of a C-slot ring: split s holds slots [s * S, min(C, (s + 1)
    * S)) with S = ``SPLIT[dtype]``.  It depends on C and the type alone,
    never on the batch or the positions (must match the kernel)."""
    return -(-C // SPLIT[dtype])


def ring_scratch(rows: int, C: int, D: int, dtype: torch.dtype, device):
    """The split kernel's f32 scratch for ``rows`` = B*H query rows, one
    buffer: ``part_acc`` [rows, n_splits, D], then ``part_ml`` [rows,
    n_splits, 2], with n_splits = ``ring_splits(C, dtype)``; each row's
    partials are laid out by C and the type alone.  Returns the buffer and
    the addresses of the two."""
    return _split_scratch(rows, ring_splits(C, dtype), D, device)


@functools.lru_cache(maxsize=None)
def _ring_kernel():
    lib = _build.load("decode_ring")
    fn = lib.decode_ring_attention
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.decode_ring_error_string.argtypes = [ctypes.c_int]
    lib.decode_ring_error_string.restype = ctypes.c_char_p
    return fn, lib.decode_ring_error_string


def decode_attention_kernel(q: torch.Tensor, cache_k: torch.Tensor,
                            cache_v: torch.Tensor, pos: torch.Tensor, *,
                            window: Optional[int], scale: float,
                            n_rep: int) -> torch.Tensor:
    """One-token attention over the dense per-slot (ring) cache.

    q [B,1,H,D] with H = Hkv*n_rep; cache_k/cache_v [B,C,Hkv,D]; pos [B]
    int32, each sequence's position (>= 0; ``pos >= C`` is legal and then
    every slot is visible without a window).  With ``window`` the cache is
    a ring and only the last ``min(window, pos+1)`` positions are visible.
    -> [B,1,H,D].  The layout checks hold on every device, so the CPU path
    takes exactly what the kernel takes.

    On the card one call is two kernel launches, the split kernel over
    ``ring_splits(C, q.dtype)`` splits of the ring and the merge, and
    counts once in ``decode_attention_kernel.launches``."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B,1,H,D], got {tuple(q.shape)}")
    B, _, H, D = q.shape
    if cache_k.dim() != 4 or cache_v.shape != cache_k.shape:
        raise ValueError("cache_k/cache_v must both be [B,C,Hkv,D]")
    Bc, C, Hkv, Dk = cache_k.shape
    if Bc != B or Dk != D or H != Hkv * n_rep:
        raise ValueError(f"q {tuple(q.shape)} does not match the cache "
                         f"{tuple(cache_k.shape)} with n_rep={n_rep}")
    if tuple(pos.shape) != (B,):
        raise ValueError(f"pos must be [B], got {tuple(pos.shape)}")
    for name, t in (("q", q), ("cache_k", cache_k), ("cache_v", cache_v),
                    ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or cache_k.dtype != q.dtype or cache_v.dtype != q.dtype:
        raise ValueError("q and the cache must share one type, bf16 or f32")
    if pos.dtype != torch.int32:
        raise ValueError("pos must be int32")
    if window is not None and window <= 0:
        raise ValueError("window must be positive")
    refuse_autograd("decode_attention_kernel", q, cache_k, cache_v)
    if q.device.type == "cpu":
        return decode_ring_ref(q, cache_k, cache_v, pos, scale=scale,
                               n_rep=n_rep, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_kernel: unsupported device "
                         f"{q.device}")
    vec = 16 // q.element_size()
    if D % vec or any(t.data_ptr() % 16 for t in (q, cache_k, cache_v)):
        raise ValueError(f"head dim must be a multiple of {vec} and the "
                         f"tensors 16-byte aligned")
    _check_split_block(D, q.dtype)
    out = torch.empty_like(q)
    if B == 0 or C == 0:
        return out
    # held until the launches are queued
    scratch, part_acc, part_ml = ring_scratch(B * H, C, D, q.dtype,
                                              q.device)
    fn, err_str = _ring_kernel()
    with torch.cuda.device(q.device):
        stream = _build.current_stream(q.device)
        err = fn(q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
                 pos.data_ptr(), part_acc, part_ml, out.data_ptr(), B, C,
                 Hkv, n_rep, D, -1 if window is None else int(window),
                 float(scale), int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"decode_ring_attention launch failed: "
                           f"{err_str(err).decode()} (cuda error {err})")
    decode_attention_kernel.launches += 1
    return out


decode_attention_kernel.launches = 0
