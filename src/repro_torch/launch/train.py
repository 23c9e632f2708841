"""Training launcher of the port, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 50 --batch 8 --seq 128

The port of the JAX package's ``launch/train.py`` without its mesh: the
params and optimizer state live on one device (``--device``, the CUDA
card by default; ``--device cpu`` with ``--smoke`` runs the reduced
config on the CPU).  Random weights from seed 0, the reference's synthetic
corpus, AdamW under a cosine schedule with 10 warm-up steps;
``--remat`` recomputes each layer in the backward and takes the chunked
cross entropy.  ``--ckpt`` saves the trained params in the reference's
checkpoint format.  ``--production-mesh`` and ``--multi-pod`` (the
reference's sharded meshes) are not ported: they belong to sharding
(ROADMAP.md A15).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ..configs import get_config, get_smoke_config
from ..device import resolve_device
from ..models import build_model
from ..training import checkpoint, train


def main(argv: Optional[List[str]] = None) -> dict:
    """Parse ``argv`` (``sys.argv`` when None), train, and return the
    trained params, so that a caller in process can hold the checkpoint
    to them."""
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true",
                   help="reduced same-family config")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ckpt", default="")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda")
    p.add_argument("--remat", action="store_true",
                   help="recompute each layer in the backward")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, remat=args.remat)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[launch.train] arch={cfg.arch_id} device={dev} ({name})")

    params, result = train(
        model, steps=args.steps, batch_size=args.batch, seq_len=args.seq,
        peak_lr=args.lr, warmup=10, seed=0, log_every=args.log_every,
        log_fn=lambda step, m: print(
            f"[launch.train] step {step:4d} loss={m['loss']:.4f}"),
        device=dev)
    print(f"[launch.train] {args.steps} steps in "
          f"{result.wall_seconds:.1f}s; loss {result.first_loss:.3f} -> "
          f"{result.last_loss:.3f}")
    if args.ckpt:
        n = checkpoint.save(args.ckpt, params)
        print(f"[launch.train] checkpoint {args.ckpt} ({n / 1e6:.1f} MB)")
    return params


if __name__ == "__main__":
    main()
