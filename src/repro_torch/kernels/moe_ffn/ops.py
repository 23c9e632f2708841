"""Wrapper of the grouped expert-FFN kernel (``csrc/moe_ffn.cu``).

A CUDA tensor launches the hand-written kernel and the call raises if it
cannot; a CPU tensor takes the plain version in :mod:`.ref`.  Nothing else
chooses between them.  ``moe_ffn.launches`` counts the calls that launched
the kernel (in bf16 one call is two launches: gate/up, then down).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, refuse_autograd
from .ref import moe_ffn_ref

_SMEM_LIMIT = 232_448     # bytes of shared memory a block may use (H100)
MOE_BLOCK_ROWS = 16       # token rows per block of the f32 kernel
# the bf16 kernels' largest block (the down product): 3 stages of an f32 h
# tile [64, 64 + 8] and a bf16 w_down tile [64, 128 + 8]; no term grows
# with C, D or F
_BF16_SMEM = 3 * (4 * 64 * 72 + 2 * 64 * 136)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("moe_ffn")
    fn = lib.moe_ffn_forward
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.moe_ffn_error_string.argtypes = [ctypes.c_int]
    lib.moe_ffn_error_string.restype = ctypes.c_char_p
    return fn, lib.moe_ffn_error_string


def _smem_bytes(F: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block (must match the kernel).  bf16:
    the tensor-core kernels' fixed tiles.  f32: h [F, 16] plus the staged
    x [16, 16] and w_gate / w_up [16, 256] sub-tiles, all f32."""
    if dtype == torch.bfloat16:
        return _BF16_SMEM
    return 4 * (F * MOE_BLOCK_ROWS + 16 * MOE_BLOCK_ROWS + 2 * 16 * 256)


def moe_ffn(xe: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    """Grouped SwiGLU over per-expert row blocks:
    ``out[e] = (silu(xe[e] @ w_gate[e]) * (xe[e] @ w_up[e])) @ w_down[e]``.

    xe [E,C,D]; w_gate/w_up [E,D,F]; w_down [E,F,D] -> [E,C,D] in xe's type
    (bf16 or f32; the three products and h in f32, one rounding at the
    end).  The weights are contiguous; xe's rows are, and its expert
    stride is C*D or 0: one [C,D] block expanded over E, with no copy, as
    the dropless MoE passes it.  The layout checks hold on every device,
    so the CPU path takes exactly what the kernel takes."""
    if xe.dim() != 3 or w_gate.dim() != 3:
        raise ValueError("xe must be [E,C,D] and w_gate [E,D,F]")
    E, C, D = xe.shape
    F = w_gate.shape[2]
    if tuple(w_gate.shape) != (E, D, F) or w_up.shape != w_gate.shape \
            or tuple(w_down.shape) != (E, F, D):
        raise ValueError(f"xe {tuple(xe.shape)} does not match w_gate "
                         f"{tuple(w_gate.shape)}, w_up {tuple(w_up.shape)} "
                         f"and w_down {tuple(w_down.shape)}")
    for name, t in (("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        if t.device != xe.device:
            raise ValueError(f"{name} is on {t.device}, xe on {xe.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    rows_ok = xe.stride(2) == 1 and (C <= 1 or xe.stride(1) == D)
    if not rows_ok or (E > 1 and xe.stride(0) not in (0, C * D)):
        raise ValueError(f"xe must have contiguous rows and an expert "
                         f"stride of C*D or 0, got strides {xe.stride()}")
    if xe.dtype not in (torch.bfloat16, torch.float32) or any(
            t.dtype != xe.dtype for t in (w_gate, w_up, w_down)):
        raise ValueError("xe and the weights must share one type, bf16 or "
                         "f32")
    refuse_autograd("moe_ffn", xe, w_gate, w_up, w_down)
    if xe.device.type == "cpu":
        return moe_ffn_ref(xe, w_gate, w_up, w_down)
    if xe.device.type != "cuda":
        raise ValueError(f"moe_ffn: unsupported device {xe.device}")
    vec = 16 // xe.element_size()
    if D % vec or F % vec or any(t.data_ptr() % 16 for t in
                                 (xe, w_gate, w_up, w_down)):
        raise ValueError(f"d_model and d_expert must be multiples of {vec} "
                         f"and the tensors 16-byte aligned")
    smem = _smem_bytes(F, xe.dtype)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"d_expert={F} needs {smem} bytes of shared memory "
                         f"(limit {_SMEM_LIMIT})")
    out = torch.empty((E, C, D), dtype=xe.dtype, device=xe.device)
    if E == 0 or C == 0:
        return out
    fn, err_str = _kernel()
    x_stride = 0 if E > 1 and xe.stride(0) == 0 else C * D
    bf16 = xe.dtype == torch.bfloat16
    # h = silu(x @ w_gate) * (x @ w_up), f32, between the bf16 path's two
    # launches; the f32 kernel keeps its h in shared memory
    h = torch.empty((E, C, F), dtype=torch.float32,
                    device=xe.device) if bf16 else None
    with torch.cuda.device(xe.device):
        stream = _build.current_stream(xe.device)
        err = fn(xe.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                 w_down.data_ptr(), out.data_ptr(),
                 None if h is None else h.data_ptr(), E, C, D, F, x_stride,
                 int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"moe_ffn launch failed: {err_str(err).decode()} "
                           f"(cuda error {err})")
    moe_ffn.launches += 1
    return out


moe_ffn.launches = 0
