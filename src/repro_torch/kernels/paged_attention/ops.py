"""Wrappers of the decode attention kernels: paged chunk attention
(``csrc/paged_chunk.cu``), one-token split-KV paged decode
(``csrc/paged_decode.cu``) and ring decode attention
(``csrc/decode_ring.cu``).

A CUDA tensor launches the hand-written kernel and the call raises if it
cannot; a CPU tensor takes the plain version in :mod:`.ref`.  Nothing else
chooses between them.  ``paged_decode_chunk.launches``,
``paged_decode.launches`` and ``decode_attention_kernel.launches`` count
the kernels' launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build
from .ref import decode_ring_ref, paged_decode_chunk_ref, paged_decode_ref

_SMEM_LIMIT = 232_448     # bytes of shared memory a block may use (H100)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("paged_chunk")
    fn = lib.paged_chunk_attention
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.paged_chunk_error_string.argtypes = [ctypes.c_int]
    lib.paged_chunk_error_string.restype = ctypes.c_char_p
    return fn, lib.paged_chunk_error_string


def _smem_bytes(R: int, P: int, D: int) -> int:
    """Dynamic shared memory of one block (must match the kernel)."""
    return 4 * (R * (D + 1) + P * (D + 1) + P * D + R * P + R * D + 3 * R)


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
    takes exactly what the kernel takes."""
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
    if q.device.type == "cpu":
        return paged_decode_chunk_ref(q, k_pages, v_pages, page_table, pos,
                                      scale=scale, n_rep=n_rep)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_chunk: unsupported device {q.device}")
    vec = 16 // q.element_size()
    if D % vec or any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError(f"head dim must be a multiple of {vec} and the "
                         f"tensors 16-byte aligned")
    smem = _smem_bytes(T * n_rep, P, D)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"T*n_rep={T * n_rep} rows need {smem} bytes of "
                         f"shared memory (limit {_SMEM_LIMIT})")
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    fn, err_str = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                 B, T, Hkv, n_rep, D, P, page_table.shape[1], float(scale),
                 int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"paged_chunk_attention launch failed: "
                           f"{err_str(err).decode()} (cuda error {err})")
    paged_decode_chunk.launches += 1
    return out


paged_decode_chunk.launches = 0


# ------------------------------------------------------- paged decode (B3)
@functools.lru_cache(maxsize=None)
def _decode_kernel():
    lib = _build.load("paged_decode")
    fn = lib.paged_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.paged_decode_error_string.argtypes = [ctypes.c_int]
    lib.paged_decode_error_string.restype = ctypes.c_char_p
    return fn, lib.paged_decode_error_string


def _decode_smem_bytes(n_rep: int, D: int, P: int, elem: int) -> int:
    """Dynamic shared memory of one page block (must match the kernel):
    the page's K and V rows in their own type, q's rows, the scores and
    the row states in f32."""
    return 2 * elem * P * D + 4 * (n_rep * D + n_rep * P + 2 * n_rep)


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

    The layout checks hold on every device, so the CPU path takes exactly
    what the kernel takes."""
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
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pages, v_pages, page_table, lengths,
                                scale=scale, n_rep=n_rep)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode: unsupported device {q.device}")
    vec = 16 // q.element_size()
    if D % vec or any(t.data_ptr() % 16 for t in (k_pages, v_pages)):
        raise ValueError(f"head dim must be a multiple of {vec} and the "
                         f"pages 16-byte aligned")
    smem = _decode_smem_bytes(n_rep, D, P, q.element_size())
    if smem > _SMEM_LIMIT:
        raise ValueError(f"a {P}-token page of head dim {D} with n_rep="
                         f"{n_rep} needs {smem} bytes of shared memory "
                         f"(limit {_SMEM_LIMIT})")
    maxp = page_table.shape[1]
    out = torch.empty_like(q)
    if B == 0 or maxp == 0:
        return out.zero_()
    part_acc = torch.empty((B * H, maxp, D), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B * H, maxp, 2), dtype=torch.float32,
                          device=q.device)
    fn, err_str = _decode_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 page_table.data_ptr(), lengths.data_ptr(),
                 part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
                 B, Hkv, n_rep, D, P, maxp, float(scale),
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
RING_BLOCK_K = 64         # cache slots per staged tile (must match the kernel)


@functools.lru_cache(maxsize=None)
def _ring_kernel():
    lib = _build.load("decode_ring")
    fn = lib.decode_ring_attention
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.decode_ring_error_string.argtypes = [ctypes.c_int]
    lib.decode_ring_error_string.restype = ctypes.c_char_p
    return fn, lib.decode_ring_error_string


def _ring_smem_bytes(n_rep: int, D: int) -> int:
    """Dynamic shared memory of one ring block (must match the kernel)."""
    bk = RING_BLOCK_K
    return 4 * (n_rep * (D + 1) + bk * (D + 1) + bk * D + n_rep * bk
                + n_rep * D + 3 * n_rep)


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
    takes exactly what the kernel takes."""
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
    smem = _ring_smem_bytes(n_rep, D)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"n_rep={n_rep} rows of head dim {D} need {smem} "
                         f"bytes of shared memory (limit {_SMEM_LIMIT})")
    out = torch.empty_like(q)
    if B == 0 or C == 0:
        return out
    fn, err_str = _ring_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
                 pos.data_ptr(), out.data_ptr(), B, C, Hkv, n_rep, D,
                 -1 if window is None else int(window), float(scale),
                 int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"decode_ring_attention launch failed: "
                           f"{err_str(err).decode()} (cuda error {err})")
    decode_attention_kernel.launches += 1
    return out


decode_attention_kernel.launches = 0
