"""Wrapper of the RG-LRU scan kernel (``csrc/rglru_scan.cu``).

A CUDA tensor launches the hand-written kernel and the call raises if it
cannot; a CPU tensor takes the plain version in :mod:`.ref`.  Nothing else
chooses between them.  ``rglru_scan.launches`` counts the kernel's
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import _build, refuse_autograd
from .ref import rglru_scan_ref

_MAX_BATCH = 65_535       # the grid's second dimension


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("rglru_scan")
    fn = lib.rglru_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.rglru_scan_error_string.argtypes = [ctypes.c_int]
    lib.rglru_scan_error_string.restype = ctypes.c_char_p
    return fn, lib.rglru_scan_error_string


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h_t = a_t * h_{t-1} + b_t`` over a, b [B,S,W] (float32,
    contiguous) from ``h0`` [B,W] (float32, contiguous; None is a zero
    state).  Returns (h [B,S,W] float32, the final state [B,W] float32).
    The layout checks hold on every device, so the CPU path takes exactly
    what the kernel takes."""
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         f"both be [B,S,W]")
    B, S, W = a.shape
    if h0 is not None and tuple(h0.shape) != (B, W):
        raise ValueError(f"h0 must be [{B},{W}], got {tuple(h0.shape)}")
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if t is None:
            continue
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    refuse_autograd("rglru_scan", a, b, h0)
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: unsupported device {a.device}")
    if B > _MAX_BATCH:
        raise ValueError(f"batch {B} exceeds the kernel's grid ({_MAX_BATCH})")
    y = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    final = torch.empty((B, W), dtype=torch.float32, device=a.device)
    if B == 0 or W == 0:
        return y, final
    fn, err_str = _kernel()
    with torch.cuda.device(a.device):
        stream = _build.current_stream(a.device)
        err = fn(a.data_ptr(), b.data_ptr(),
                 None if h0 is None else h0.data_ptr(), y.data_ptr(),
                 final.data_ptr(), B, S, W, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan launch failed: "
                           f"{err_str(err).decode()} (cuda error {err})")
    rglru_scan.launches += 1
    return y, final


rglru_scan.launches = 0
