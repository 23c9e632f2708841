"""Wrapper of the SSD chunk-scan kernel (``csrc/ssd.cu``).

A CUDA tensor launches the hand-written kernel and the call raises if it
cannot; a CPU tensor takes the plain version in :mod:`.ref`.  Nothing else
chooses between them.  ``ssd_chunk_scan.launches`` counts the calls that
launched the kernel (one call is four dependent launches on the stream).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import _build, refuse_autograd
from .ref import ssd_chunked_ref

SSD_HEAD_DIM_MULTIPLE = 16   # the state product's 16-row tiles of P
SSD_MAX_CHUNK = 256          # cum's scan runs one step per thread
SSD_MAX_STATE = 128          # the blocks stage at most 128 state columns


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("ssd")
    fn = lib.ssd_chunk_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.ssd_workspace_floats.argtypes = [ctypes.c_int] * 7
    lib.ssd_workspace_floats.restype = ctypes.c_longlong
    lib.ssd_error_string.argtypes = [ctypes.c_int]
    lib.ssd_error_string.restype = ctypes.c_char_p
    return fn, lib.ssd_workspace_floats, lib.ssd_error_string


@functools.lru_cache(maxsize=1024)
def _workspace_floats(B: int, S: int, H: int, P: int, N: int, Q: int,
                      is_bf16: int) -> int:
    """Floats of the launches' scratch (C.B^T per chunk, cum, the chunk
    states and, for bf16, the split entering states), asked of the library
    once per shape."""
    return _kernel()[1](B, S, H, P, N, Q, is_bf16)


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD dual form of one Mamba2 layer in chunks of
    ``Q = min(chunk, S)`` steps.

    x [B,S,H,P] (bf16 or f32; its rows may be strided, as the model's
    slice of the conv output is: head stride P and unit inner stride);
    dt [B,S,H] float32 contiguous (softplus'd); A [H] float32 contiguous
    (positive rates); Bm, Cm [B,S,N] in x's type with a unit inner stride;
    init_state [B,H,P,N] float32 contiguous or None.  Returns y [B,S,H,P]
    (x's type, contiguous) and the final state [B,H,P,N] float32.  The
    layout checks hold on every device, so the CPU path takes exactly what
    the kernel takes."""
    if x.dim() != 4:
        raise ValueError(f"x must be [B,S,H,P], got {tuple(x.shape)}")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,) \
            or Bm.dim() != 3 or tuple(Bm.shape) != (Bsz, S, N) \
            or Cm.shape != Bm.shape:
        raise ValueError(f"x {tuple(x.shape)} does not match dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)} and Cm {tuple(Cm.shape)}")
    if init_state is not None and (
            tuple(init_state.shape) != (Bsz, H, P, N)
            or init_state.dtype != torch.float32
            or not init_state.is_contiguous()):
        raise ValueError(f"init_state must be a contiguous float32 "
                         f"[{Bsz},{H},{P},{N}]")
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm),
                    ("init_state", init_state)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) \
            or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError("x, Bm and Cm must share one type, bf16 or f32")
    if dt.dtype != torch.float32 or A.dtype != torch.float32 \
            or not dt.is_contiguous() or not A.is_contiguous():
        raise ValueError("dt and A must be contiguous float32")
    # a stride of a dimension of size 1 is never used
    if (P > 1 and x.stride(3) != 1) or (H > 1 and x.stride(2) != P):
        raise ValueError(f"x must have head stride P and unit inner stride, "
                         f"got strides {x.stride()}")
    if N > 1 and (Bm.stride(2) != 1 or Cm.stride(2) != 1):
        raise ValueError("Bm and Cm must have a unit inner stride")
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    refuse_autograd("ssd_chunk_scan", x, dt, A, Bm, Cm, init_state)
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, A, Bm, Cm, chunk, init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_scan: unsupported device {x.device}")
    Q = min(chunk, S)
    if P % SSD_HEAD_DIM_MULTIPLE or N > SSD_MAX_STATE or Q > SSD_MAX_CHUNK:
        raise ValueError(f"the kernel takes head_dim a multiple of "
                         f"{SSD_HEAD_DIM_MULTIPLE}, ssm_state <= "
                         f"{SSD_MAX_STATE} and chunks <= {SSD_MAX_CHUNK}; "
                         f"got P={P}, N={N}, Q={Q}")
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    final = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    if Bsz == 0 or H == 0 or P == 0:
        return y, final
    fn, _, err_str = _kernel()
    is_bf16 = int(x.dtype == torch.bfloat16)
    ws = torch.empty(_workspace_floats(Bsz, S, H, P, N, Q, is_bf16),
                     dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = _build.current_stream(x.device)
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(),
                 None if init_state is None else init_state.data_ptr(),
                 y.data_ptr(), final.data_ptr(), ws.data_ptr(), Bsz, S, H, P,
                 N, Q,
                 x.stride(0), x.stride(1), Bm.stride(0), Bm.stride(1),
                 Cm.stride(0), Cm.stride(1), is_bf16, stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk_scan launch failed: "
                           f"{err_str(err).decode()} (cuda error {err})")
    ssd_chunk_scan.launches += 1
    return y, final


ssd_chunk_scan.launches = 0
