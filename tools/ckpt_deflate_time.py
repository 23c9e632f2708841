#!/usr/bin/env python3
"""The checkpoint's zlib deflate, on one thread and on the codec's threads.

    python3 tools/ckpt_deflate_time.py [--arch qwen3-0.6b] [--device cuda]
                                       [--smoke]

Draws the architecture's full-width bf16 params from a seed (on
``--device``, then packed on the host as ``checkpoint.save`` packs
them), and deflates the packed payload twice at level 6: once with
``zlib.compress(packed, 6)`` on one thread, as the JAX package writes an
``NLZL`` file, and once with the port's ``checkpoint._zlib`` (16 MiB
pieces on a thread per core, one stream).  Both streams are inflated and
checked against the payload.  ``--smoke`` takes the smoke config, to
try the script on a CPU.  Prints the host's core count, the
payload's bytes, and each deflate's seconds and output bytes, then the
card's name and power limit when ``nvidia-smi`` is there.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
import zlib
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.model import build_model
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.tree import tree_leaves

    dev = torch.device(args.device)
    model = build_model((get_smoke_config if args.smoke else get_config)(
        args.arch))
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                        device=dev)
    leaves = tree_leaves(params)
    packed = ckpt.packb({"treedef": ckpt.treedef_str(params),
                         "n_leaves": len(leaves),
                         "leaves": [ckpt._encode_array(x) for x in leaves]})
    del params, leaves
    print(f"[deflate] {args.arch}: host cores {os.cpu_count()}, payload "
          f"{len(packed)} bytes", flush=True)
    for name, fn in (("threaded", ckpt._zlib),
                     ("one_thread", lambda b: zlib.compress(b, 6))):
        t0 = time.perf_counter()
        comp = fn(packed)
        dt = time.perf_counter() - t0
        assert zlib.decompress(comp) == packed, name
        print(f"[deflate] {name}: {dt:.3f} s, {len(comp)} bytes, "
              f"{len(packed) / dt / 1e6:.2f} MB/s", flush=True)
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        card = "no nvidia-smi"
    print(f"[deflate] card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
