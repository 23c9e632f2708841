#!/usr/bin/env python3
"""The ssm phase's ``prefill_chunk=0`` serve trace for the port found
under one source directory.  Runs on one NVIDIA card.

    python3 tools/ssm_host_ab.py SRC_DIR [--label NAME]

``SRC_DIR`` holds the ``repro_torch`` package to measure (``src`` of this
checkout, or of another one unpacked beside it), so that two versions of
the port are compared on one card by running this script once per
version, in the order A, B, B, A.  The trace, its checks and its
printing are ``chip_smoke.py``'s own (``ssm_serve``: mamba2-130m at full
width, random weights from a seed, the serve trace with a profiled wave
and a profiled admission step), taken from the checkout this script lies
in, so both versions run the same trace code.  It prints ``[ssm]`` lines:
step ms p50 and p99 of the trace, the profiled wave's device busy share,
the admission step's host wall and the chunk scan's device time per
admission.  The chunk scan wrapper's own host time, parent against change
in one process, is ``chip_smoke.wrapper_ab(..., "ssd_chunk_scan")``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", type=Path, help="directory holding repro_torch")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ssm_host_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    src = args.src.resolve()
    label = args.label or str(src)
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import repro_torch as rt
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.moe_ffn import ops as moe_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.rglru_scan import ops as scan_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    if not Path(rt.__file__).resolve().is_relative_to(src):
        print(f"ssm_host_ab: imported {rt.__file__}, not from {src}",
              file=sys.stderr)
        return 2
    print(f"[{label}] card: {cs.nvidia_smi()}; repro_torch from {src}")
    counters = {"paged_decode_chunk": paged_ops.paged_decode_chunk,
                "flash_attention_bhsd": flash_ops.flash_attention_bhsd,
                "decode_ring": paged_ops.decode_attention_kernel,
                "moe_ffn": moe_ops.moe_ffn,
                "ssd_chunk_scan": ssd_ops.ssd_chunk_scan,
                "rglru_scan": scan_ops.rglru_scan,
                "paged_decode": paged_ops.paged_decode}
    cfg = rt.get_config("mamba2-130m")
    model = rt.build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    try:
        cs.ssm_serve(torch, rt, model, params, counters,
                     cs.ForwardTally(model), 0)
    except cs.Failed as exc:
        print(f"ssm_host_ab: FAILED: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
