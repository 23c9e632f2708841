"""Wrapper of the flash attention kernel (``csrc/flash_attention.cu``).

A CUDA tensor launches the hand-written kernel and the call raises if it
cannot; a CPU tensor takes the plain version in :mod:`.ref`.  Nothing else
chooses between them.  ``flash_attention_bhsd.launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build, refuse_autograd
from .ref import flash_attention_bhsd_ref

MAX_HEAD_DIM = 256        # the kernel's shared-memory tiles are sized for it


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return fn, lib.flash_attention_error_string


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Forward causal / sliding-window attention.  q [BH,Sq,D]; k/v
    [BH,Skv,D] with GQA already expanded.  -> [BH,Sq,D].  The layout
    checks hold on every device, so the CPU path takes exactly what the
    kernel takes."""
    BH, Sq, D = q.shape
    if k.dim() != 3 or v.shape != k.shape or k.shape[0] != BH \
            or k.shape[2] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one type, bf16 or f32")
    if window is not None and window <= 0:
        raise ValueError("window must be positive")
    refuse_autograd("flash_attention_bhsd", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_bhsd_ref(q, k, v, causal=causal,
                                        window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bhsd: unsupported device "
                         f"{q.device}")
    vec = 16 // q.element_size()
    if D % vec or D > MAX_HEAD_DIM \
            or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"head dim must be a multiple of {vec} and at most "
                         f"{MAX_HEAD_DIM}, the tensors 16-byte aligned")
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    if BH == 0 or Sq == 0:
        return out
    fn, err_str = _kernel()
    with torch.cuda.device(q.device):
        stream = _build.current_stream(q.device)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 BH, Sq, k.shape[1], D, float(scale), int(bool(causal)),
                 int(window or 0), int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: "
                           f"{err_str(err).decode()} (cuda error {err})")
    flash_attention_bhsd.launches += 1
    return out


flash_attention_bhsd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v [B,S,H,D] (k/v already GQA-expanded): folds (B, H) into the
    kernel's BH dimension and restores the layout."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]

    def fold(x, S):
        return x.transpose(1, 2).reshape(B * H, S, D).contiguous()

    out = flash_attention_bhsd(fold(q, Sq), fold(k, Skv), fold(v, Skv),
                               causal=causal, window=window, scale=scale)
    return out.reshape(B, H, Sq, D).transpose(1, 2)
