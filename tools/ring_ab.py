#!/usr/bin/env python3
"""Times of the ring-decode kernel (``decode_attention_kernel``, B4) and
the parts of its wrapper's host cost, for the port found under one source
directory.  Runs on one NVIDIA card.

    python3 tools/ring_ab.py SRC_DIR [--label NAME]

``SRC_DIR`` holds the ``repro_torch`` package to measure (``src`` of this
checkout, or of another one unpacked beside it), so that two versions of
the port are compared on one card by running this script once per
version, in the order A, B, B, A.  The timers are ``chip_smoke.py``'s own,
taken from the checkout this script lies in: ``Timer.ms`` (median of 20
launches, the L2 flushed before each, the host's launch work hidden behind
a guarded spin) and ``Timer.host_us`` (median host microseconds of 100
calls queued behind a spin, so that none waits on the card).

Prints, tagged with the label:

* ``[ring]`` for four bf16 shapes (recurrentgemma-9b's attention: B=8,
  Hkv=1, n_rep 16, D=256, window 2048, over wrapped 1024- and 2048-slot
  caches; qwen3-0.6b's ``decode_step``: B=8, C=1024, Hkv=8, n_rep 2,
  D=128 at positions 264..319 and 975..1020): the kernel's time, its
  bound, its largest difference from the plain version and the wrapper's
  host microseconds per call;
* ``[host]`` at qwen3's ``decode_step`` shape, the host microseconds of
  the wrapper, of its C entry point alone (the arguments of the wrapper's
  own last call), of the wrapper with a C entry point that does nothing,
  and of the pieces a wrapper may hold: ``torch.empty_like(q)``, one f32
  scratch allocation of the split kernel's size, the device guard, the
  stream as ``torch.cuda.current_stream().cuda_stream`` and as the raw
  handle.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

# (name, B, C, Hkv, n_rep, D, window, lowest pos, end pos)
SHAPES = [("rg C=1024", 8, 1024, 1, 16, 256, 2048, 2048, 4096),
          ("rg C=2048", 8, 2048, 1, 16, 256, 2048, 2048, 4096),
          ("qwen3 decode", 8, 1024, 8, 2, 128, None, 264, 320),
          ("qwen3 full", 8, 1024, 8, 2, 128, None, 975, 1021)]


def host_parts(torch, timer, ops, q, call, scratch):
    """Host microseconds of the wrapper ``call`` and of its parts;
    ``scratch`` is the split kernel's scratch size in floats."""
    dev = q.device
    real = ops._ring_kernel
    fn, err_str = real()
    seen = []

    def recording(*args):
        seen[:] = args
        return fn(*args)

    ops._ring_kernel = lambda: (recording, err_str)
    call()
    ops._ring_kernel = lambda: (lambda *args: 0, err_str)
    no_c_call = timer.host_us(call)
    ops._ring_kernel = real

    def guard_stream():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream().cuda_stream

    def guard_raw():
        with torch.cuda.device(dev):
            return torch._C._cuda_getCurrentRawStream(dev.index)

    def guard():
        with torch.cuda.device(dev):
            return 0

    return {"wrapper": timer.host_us(call),
            "C entry point alone": timer.host_us(lambda: fn(*seen)),
            "wrapper, C entry point doing nothing": no_c_call,
            "torch.empty_like(q)": timer.host_us(
                lambda: torch.empty_like(q)),
            f"torch.empty({scratch}) f32 scratch": timer.host_us(
                lambda: torch.empty(scratch, dtype=torch.float32,
                                    device=dev)),
            "device guard": timer.host_us(guard),
            "device guard + current_stream().cuda_stream": timer.host_us(
                guard_stream),
            "device guard + raw stream handle": timer.host_us(guard_raw)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", type=Path, help="directory holding repro_torch")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ring_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    src = args.src.resolve()
    label = args.label or str(src)
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import repro_torch as rt
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention import ref

    if not Path(rt.__file__).resolve().is_relative_to(src):
        print(f"ring_ab: imported {rt.__file__}, not from {src}",
              file=sys.stderr)
        return 2
    print(f"[{label}] card: {cs.nvidia_smi()}; repro_torch from {src}")
    timer = cs.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(26)
    rng = np.random.default_rng(26)
    for name, B, C, Hkv, n_rep, D, window, lo, hi in SHAPES:
        H = Hkv * n_rep
        q = torch.randn((B, 1, H, D), generator=g, device="cuda").bfloat16()
        ck, cv = (torch.randn((B, C, Hkv, D), generator=g,
                              device="cuda").bfloat16() for _ in range(2))
        pos = torch.from_numpy(rng.integers(lo, hi, B).astype(np.int32)
                               ).cuda()
        kw = dict(window=window, scale=D ** -0.5, n_rep=n_rep)

        def kernel():
            return ops.decode_attention_kernel(q, ck, cv, pos, **kw)

        err = (kernel().float() - ref.decode_ring_ref(
            q, ck, cv, pos, **kw).float()).abs().max().item()
        visible = ref.ring_visible(pos, C, window)
        bound, by = cs.bound_ms(*cs.ring_cost(visible, H, Hkv, D))
        ms = timer.ms(kernel)
        host = timer.host_us(kernel)
        print(f"[{label}] [ring] {name}: B={B} C={C} Hkv={Hkv} n_rep="
              f"{n_rep} D={D} window={window} pos={lo}..{hi - 1}: ms="
              f"{ms:.4f} bound_ms={bound:.5f} ({by}) max_abs_err={err:.3e} "
              f"host_us={host:.1f}")
        if name == "qwen3 decode":
            scratch = B * H * -(-C // 128) * (D + 2)
            for part, us in host_parts(torch, timer, ops, q, kernel,
                                       scratch).items():
                print(f"[{label}] [host] {name}: {part}: {us:.1f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
