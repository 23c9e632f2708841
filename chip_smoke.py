#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, in order; any failed check ends
the run with a non-zero exit and no result line:

1. build   — compile every CUDA kernel of the port from ``src/repro_torch/
             csrc/`` (one ``nvcc`` per source, all at once).
2. kernels — hold each kernel against its plain PyTorch version on the card
             in bf16 at the shapes of the path that runs it (the expert
             FFN also bitwise across row counts; the SSD chunk scan also in
             float32, and against the token-by-token recurrence), and time
             kernel, plain version and a PyTorch yardstick (``library_ms``,
             never used by the port) against the card's bound.
3. serve   — qwen3-0.6b at full width (random weights from a seed) served by
             the port's paged ``InferenceEngine``: 16 requests with
             follow-up turns and a shared system prompt (timed), a third
             wave of 8 requests of which 10 steps run under
             ``torch.profiler``, one ``warm_session`` replay and one request
             on a ``prefill_chunk=0`` engine.  Every launch counter is set to
             0 before this phase and read after it (the paged chunk and
             flash kernels run here).
4. check   — first-step next-token logits of two short prompts on the card
             (bf16) against the same weights run on the CPU in float32.
5. decode  — the model API's dense path: ``prefill(pad_cache_to=1024)`` of 8
             prompts, then 64 ``decode_step``s, whose attention is the
             ring-decode kernel (counters set to 0 before, read after: 28
             launches per step); the first step's logits against the CPU in
             float32.
6. dense   — the serve trace on an ``InferenceEngine(paged_decode=False)``
             (the dense slot-cache plane, stepped by ``decode_chunk``, which
             launches none of the attention kernels); follow-up turns resume
             through ``gather_contiguous``.
7. moe     — granite-moe-1b-a400m at full width (random weights from a
             seed; qwen3-0.6b freed first): the serve trace on the paged
             plane and on the dense plane, in bf16 (timed; 10 steps of a
             third wave profiled on the paged plane) and in float32 (the
             kernels in f32), the counters set to 0 before each run and
             read after it: 24 paged chunk launches per paged step, 24
             expert-FFN launches per forward.  The float32 planes must give
             the same greedy tokens (or differ only at a tie); the bf16
             planes' agreement is reported.  Then next-token logits of two
             prompts through prefill, a paged step and ``decode_step`` on
             the card, bf16 and float32, against the CPU in float32.
8. ssm     — mamba2-130m at full width (random weights from a seed;
             granite freed first) on the engine's state-cache plane, bf16:
             the serve trace on a ``prefill_chunk=0`` engine (24 chunk-scan
             launches per admission) and on a ``prefill_chunk=8`` engine
             (the fused recurrent step, no launch), each timed and with a
             profiled wave; a ``warm_session`` (24 launches) and
             ``export_session`` -> ``import_session`` onto the other
             engine.  Then prefill and ``decode_step`` logits of two
             prompts, card bf16 and float32 against the CPU in float32;
             float32 prefill (the scan) against ``decode_chunk`` over the
             same prompt (the recurrence); and the fused step against the
             per-token masked step in float32 (the same greedy tokens).
9. hybrid  — recurrentgemma-9b at full width (random weights from a seed;
             mamba2 freed first; 38 layers, 26 RG-LRU and 12 local
             attention, head_dim 256, window 2048) on the state-cache
             plane.  First its kernels at its widths: the RG-LRU scan
             (bitwise against its plain version), the flash kernel at head
             dim 256 and the ring kernel at one kv head of 16 queries, D =
             256, over wrapped rings.  Then the serve trace in bf16 on a
             ``prefill_chunk=0`` engine (26 scan and 12 flash launches per
             admission) and a ``prefill_chunk=8`` one (neither), 12 ring
             launches per single step on both, each with a profiled wave; a
             ``warm_session`` and a session moved between the engines.
             Then the five-layer cut (one group and the two tail layers)
             against the CPU (card float32 within 1e-3, card bf16 within the
             logits bound with a CPU bf16 witness, float32 prefill against
             the recurrence, and 2100 tokens past the window over the
             wrapped ring); the full depth past the window (two prompts of
             2300 tokens, 32 decode_steps) in bf16 against float32 on the
             card; and the fused, masked and monolithic engines' float32
             tokens on the cut.

The last lines are the kernel table as JSON, the card's name and power
limit (``nvidia-smi``), and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 flop/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# float32 outside the tensor cores: a bound divides the operations by the
# peak of their own type, and the RG-LRU scan multiplies and adds in float32
F32_FLOP_PER_S = 67e12
# kernel vs plain version in bf16: both round the output to bf16 once (and
# the flash kernel rounds its probabilities to bf16 before P.V, the plain
# version its normalised ones), so they agree to about one bf16 ulp:
# relative 2^-7 < 1e-2, plus an absolute floor for outputs near zero
KERNEL_TOL = dict(rtol=1e-2, atol=1e-2)
# card bf16 vs CPU float32 logits through 28 layers: bf16 rounds every
# activation (relative 2^-9), compounding over ~10 roundings per layer
LOGITS_REL_L2_TOL = 5e-2
# card float32 vs CPU float32: the same math summed in another order (the
# kernels' tiles, cuBLAS's splits), float32 matmuls in full precision
F32_REL_L2_TOL = 1e-3
# SSD chunk scan vs its plain version, largest difference over the largest
# reference value: bf16 y within 1e-2 (the plain version also rounds the
# scores, the decayed score matrix and dt to bf16 before summing up to 256
# terms; the kernel rounds y only), float32 (and every final state, which
# is float32 on both sides) within 1e-3
SSD_REL_TOL = {"bfloat16": 1e-2, "float32": 1e-3}


class Failed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failed(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
class Timer:
    """Median device time of one call, with the 50 MB L2 flushed before
    each launch (the serving path meets every layer's pages cold).

    A spin kernel (``torch.cuda._sleep``, PyTorch's own, which its stream
    tests use) is queued after the flush, so the card is busy while the
    host runs the call's Python and the timed span holds the call's device
    work, not the host's launch overhead.  The spin is sized from the
    call's host time in the warm-up.  Each timed call checks that the spin
    was still running when the call returned (its start event not yet
    reached); if it was not, the card may have waited on the host inside
    the span, so the spin grows fourfold and the call is timed again.  A
    call that outruns the longest spin (one that synchronises inside, or
    whose host time is longer) is printed as a reading that includes host
    time, and counted in ``host_bound``."""

    MIN_SPIN_MS, MAX_SPIN_MS = 0.5, 64.0

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8,
                                     device="cuda")
        self.host_bound = 0
        # the spin's clock cycles per ms on this card, at its clock now
        cycles = 1 << 22
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(cycles)
        s.record()
        torch.cuda._sleep(cycles)
        e.record()
        torch.cuda.synchronize()
        self.cycles_per_ms = cycles / s.elapsed_time(e)

    def ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host_ms = (time.perf_counter() - t0) * 1e3
        spin = min(max(2 * host_ms, self.MIN_SPIN_MS), self.MAX_SPIN_MS)
        while True:
            starts = [torch.cuda.Event(enable_timing=True)
                      for _ in range(iters)]
            ends = [torch.cuda.Event(enable_timing=True)
                    for _ in range(iters)]
            outran = 0
            for s, e in zip(starts, ends):
                self.flush_buf.zero_()
                torch.cuda._sleep(int(spin * self.cycles_per_ms))
                s.record()
                fn()
                outran += s.query()
                e.record()
            torch.cuda.synchronize()
            if not outran or spin >= self.MAX_SPIN_MS:
                break
            spin = min(4 * spin, self.MAX_SPIN_MS)
        if outran:
            self.host_bound += 1
            print(f"[timer] the host outran a {spin:.1f} ms spin in "
                  f"{outran} of {iters} calls (host {host_ms:.2f} ms in the "
                  f"warm-up): the next reading includes host time")
        return float(np.median([s.elapsed_time(e)
                                for s, e in zip(starts, ends)]))


def bound_ms(n_bytes: float, flops: float,
             flop_per_s: float = BF16_FLOP_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# ---------------------------------------------------------- phase 2 inputs
def paged_inputs(torch, seed, B, T, H, Hkv, D, P, n_pages, maxp, pos_range):
    """bf16 q and pools on the card; tables drawn as a random permutation
    of the pool's pages, -1 padded past each row's chunk; ragged pos."""
    rng = np.random.default_rng(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    pos = rng.integers(pos_range[0], pos_range[1], B).astype(np.int32)
    perm = rng.permutation(n_pages)
    pt = np.full((B, maxp), -1, np.int32)
    used = 0
    for b in range(B):
        need = -(-(int(pos[b]) + T) // P)
        pt[b, :need] = perm[used:used + need]
        used += need
    check(used <= n_pages, "paged case needs more pages than the pool has")
    return (randn(B, T, H, D), randn(n_pages, P, Hkv, D),
            randn(n_pages, P, Hkv, D), torch.from_numpy(pt).cuda(),
            torch.from_numpy(pos).cuda())


def gather_sdpa(torch, q, kp, vp, pt, pos, scale):
    """The paged chunk's yardstick (never used by the port): the pool's
    pages gathered densely, GQA expanded, then one SDPA call with the
    chunk's causal mask over q [B,T,H,D].  Returns a closure."""
    F = torch.nn.functional
    B, T, H, D = q.shape
    _, P, Hkv, _ = kp.shape
    C = pt.shape[1] * P
    idx = pt.long().clamp(min=0)
    qpos = pos.long()[:, None] + torch.arange(T, device="cuda")[None]
    mask = ((torch.arange(C, device="cuda")[None, None] <= qpos[..., None])
            & (pt >= 0).repeat_interleave(P, 1)[:, None])[:, None]

    def library():
        kg = kp[idx].reshape(B, C, Hkv, 1, D).expand(
            B, C, Hkv, H // Hkv, D).reshape(B, C, H, D)
        vg = vp[idx].reshape(B, C, Hkv, 1, D).expand(
            B, C, Hkv, H // Hkv, D).reshape(B, C, H, D)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2),
            attn_mask=mask, scale=scale)
    return library


def paged_cost(pt, pos, T, H, Hkv, D, P):
    """Bytes the function must move and flops it must do on these inputs:
    q in, out back, the table and pos, and the K and V of every token a row
    can see (positions below pos+T whose page is in the table; the unused
    tail of the last page is not counted); 4*D flops per (query row,
    visible token)."""
    pt, pos = pt.cpu().numpy(), pos.cpu().numpy()
    B = len(pos)
    n_rep = H // Hkv
    tokens = visible = 0
    for b in range(B):
        n = int(pos[b]) + T
        present = np.repeat(pt[b] >= 0, P)[:n]
        tokens += int(present.sum())
        seen = np.cumsum(present)
        visible += sum(int(seen[int(pos[b]) + t]) for t in range(T))
    n_bytes = (2 * B * T * H * D * 2 + pt.nbytes + pos.nbytes
               + 2 * tokens * Hkv * D * 2)
    return n_bytes, 4 * D * visible * H


def flash_cost(BH, S, D, window):
    visible = sum(min(i + 1, window or i + 1) for i in range(S))
    return 4 * BH * S * D * 2, 4 * D * BH * visible


def ring_cost(visible, H, Hkv, D):
    """Bytes and flops of one ring-decode call: q in and out back (bf16),
    pos, and the K and V of every visible slot; 4*D flops per (query head,
    visible slot)."""
    B = visible.shape[0]
    n_vis = int(visible.sum())
    n_bytes = 2 * B * H * D * 2 + B * 4 + 2 * n_vis * Hkv * D * 2
    return n_bytes, 4 * D * H * n_vis


def moe_cost(E, C, D, F):
    """Bytes and flops of one expert-FFN call on a [C,D] token block
    expanded over E experts: every expert's three weight matrices, the
    block once and the [E,C,D] output (bf16); 6*E*C*D*F flops."""
    return 2 * (3 * E * D * F + C * D + E * C * D), 6 * E * C * D * F


# ----------------------------------------------------------------- phases
def phase_build(_build):
    t0 = time.perf_counter()
    built = _build.build_all()
    wall = time.perf_counter() - t0
    for name, (secs, log) in built.items():
        print(f"[build] {name}: {secs:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    print(f"[build] wall {wall:.1f} s for {sorted(built)} "
          f"(already built: {sorted(set(_build.SOURCES) - set(built))})")


def phase_kernels(torch, timer, paged_ops, paged_ref, flash_ops, flash_ref,
                  moe_ops, moe_ref, ssd_ops, ssd_ref, cfg, moe_cfg, ssm_cfg,
                  decode_batch, decode_ctx):
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    n_rep = H // Hkv
    P, max_seq, max_batch = 64, 1024, 8
    maxp = max_seq // P
    n_pages = max_batch * (max_seq // P + 1) * 2      # the engine's default
    scale = D ** -0.5
    rows = {}

    # --- paged_decode_chunk: main-path shapes, T in {1, 3, 8}
    err = 0.0
    for T in (1, 3, 8):
        q, kp, vp, pt, pos = paged_inputs(torch, T, max_batch, T, H, Hkv, D,
                                          P, n_pages, maxp,
                                          (0, max_seq - T))
        got = paged_ops.paged_decode_chunk(q, kp, vp, pt, pos, scale=scale,
                                           n_rep=n_rep)
        torch.cuda.synchronize()
        want = paged_ref.paged_decode_chunk_ref(q, kp, vp, pt, pos,
                                                scale=scale, n_rep=n_rep)
        e = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), **KERNEL_TOL)
        print(f"[kernels] paged_decode_chunk T={T} B={max_batch} "
              f"max_abs_err={e:.3e} tol={KERNEL_TOL} ok={ok}")
        check(ok and bool(torch.isfinite(got).all()),
              f"paged_decode_chunk disagrees with its plain version (T={T})")
        err = max(err, e)

    # timed at two serving shapes: a chunked-prefill step (T=8) and a decode
    # step (T=1), contexts of the served prompts (32..512 + 32 new tokens)
    timings = {}
    for T in (8, 1):
        q, kp, vp, pt, pos = paged_inputs(torch, 100 + T, max_batch, T, H,
                                          Hkv, D, P, n_pages, maxp,
                                          (32, 544))
        n_bytes, flops = paged_cost(pt, pos, T, H, Hkv, D, P)
        bound, by = bound_ms(n_bytes, flops)
        library = gather_sdpa(torch, q, kp, vp, pt, pos, scale)
        t = {"ms": timer.ms(lambda: paged_ops.paged_decode_chunk(
                 q, kp, vp, pt, pos, scale=scale, n_rep=n_rep)),
             "plain_ms": timer.ms(lambda: paged_ref.paged_decode_chunk_ref(
                 q, kp, vp, pt, pos, scale=scale, n_rep=n_rep)),
             "library_ms": timer.ms(library),
             "bound_ms": bound, "bound_by": by}
        timings[T] = t
        print(f"[kernels] paged_decode_chunk timed B={max_batch} T={T} "
              f"H={H} Hkv={Hkv} D={D} P={P} ctx={pos.min().item()}.."
              f"{pos.max().item()}: ms={t['ms']:.4f} plain_ms="
              f"{t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
              f"bound_ms={bound:.5f} ({by}; {n_bytes} B, {flops} flop)")
    rows["paged_decode_chunk"] = dict(
        source="src/repro_torch/csrc/paged_chunk.cu",
        replaces="src/repro/kernels/paged_attention/paged_attention.py:260",
        max_abs_err=err, **timings[8])
    rows["paged_decode"] = paged_decode_rows(torch, timer, paged_ops,
                                             paged_ref, H, Hkv, D)

    # --- flash_attention_bhsd: S in {17, 128, 500} causal, one windowed;
    # timed at the monolithic prefill of a 257..512-token prompt: one
    # sequence, bucket 512, 16 heads
    err, timed = flash_rows(
        torch, timer, flash_ops, flash_ref, "kernels", H, D, seed=7,
        cases=((17, None, False), (128, None, False), (500, None, False),
               (500, 128, False), (512, None, True)))
    rows["flash_attention_bhsd"] = dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:87",
        max_abs_err=err, **timed[512, None])

    # --- decode_ring (decode_attention_kernel): decode_step's shapes, a
    # 1024-slot cache without a window (ragged pos, some past C), a 256-slot
    # ring with a 256 window whose positions wrap it up to 7 times, and a
    # 1024-slot ring with a 256 window; timed at the decode phase's shapes:
    # a 1024-slot cache, contexts of its 64 steps after a 256-token prompt,
    # and once over a full cache
    B = decode_batch
    rng = np.random.default_rng(11)
    cases = []
    for C, window, hi in ((1024, None, 1400), (256, 256, 2000),
                          (1024, 256, 2000)):
        pos = rng.integers(0, hi, B)
        pos[:2] = (C - 1, C + 5)        # the last slot, and past it
        cases.append((None, C, window, pos))
    for label, lo, hi in (("decode", decode_ctx, decode_ctx + 64),
                          ("full", 960, 1024)):
        cases.append((label, 1024, None, rng.integers(lo, hi, B)))
    err, timed = ring_rows(torch, timer, paged_ops, paged_ref, "kernels", H,
                           Hkv, D, seed=11, cases=cases)
    rows["decode_ring"] = dict(
        source="src/repro_torch/csrc/decode_ring.cu",
        replaces="src/repro/kernels/paged_attention/paged_attention.py:81",
        max_abs_err=err, **timed["decode"])
    rows["moe_ffn"] = moe_kernel_rows(torch, timer, moe_ops, moe_ref, moe_cfg)
    rows["ssd_chunk_scan"] = ssd_kernel_rows(torch, timer, ssd_ops, ssd_ref,
                                             ssm_cfg)
    return rows


def paged_decode_rows(torch, timer, paged_ops, paged_ref, H, Hkv, D):
    """The one-token split-KV paged decode (B3) at qwen3-0.6b's shapes
    (pages of 64, tables from the engine's default pool of 272 pages):
    B=8 at contexts 264..319 (the row in the JSON line) and 975..1020, and
    one 8192-token sequence, whose 128 pages are 128 splits.  Each is held against its plain version and against the paged
    chunk kernel at T=1 (pos = lengths - 1, the same function), and timed
    beside both and beside gather + SDPA.  The bound counts q in, the
    output, the table and lengths, and the K and V of every visible token
    once; 4*D flops per (query head, visible token)."""
    n_rep, P = H // Hkv, 64
    scale = D ** -0.5
    err, timed = 0.0, {}
    for label, B, maxp, n_pages, (lo, hi) in (
            ("serve", 8, 16, 272, (264, 320)),
            ("full", 8, 16, 272, (975, 1021)),
            ("long", 1, 128, 130, (8192, 8193))):
        q4, kp, vp, pt, pos = paged_inputs(torch, 200 + B + lo, B, 1, H,
                                           Hkv, D, P, n_pages, maxp,
                                           (lo - 1, hi - 1))
        q, lengths = q4[:, 0].contiguous(), pos + 1
        got = paged_ops.paged_decode(q, kp, vp, pt, lengths, scale=scale,
                                     n_rep=n_rep)
        torch.cuda.synchronize()
        want = paged_ref.paged_decode_ref(q, kp, vp, pt, lengths,
                                          scale=scale, n_rep=n_rep)
        chunk = paged_ops.paged_decode_chunk(q4, kp, vp, pt, pos, scale=scale,
                                             n_rep=n_rep)[:, 0]
        e = (got.float() - want.float()).abs().max().item()
        e1 = (got.float() - chunk.float()).abs().max().item()
        ok = (torch.allclose(got.float(), want.float(), **KERNEL_TOL)
              and torch.allclose(got.float(), chunk.float(), **KERNEL_TOL)
              and bool(torch.isfinite(got).all()))
        print(f"[kernels] paged_decode {label} B={B} len={lo}..{hi - 1} "
              f"({maxp} page splits per (b, kv head)): "
              f"max_abs_err={e:.3e} vs plain, {e1:.3e} vs paged_decode_chunk "
              f"T=1; tol={KERNEL_TOL} ok={ok}")
        check(ok, f"paged_decode disagrees with its plain version or the "
                  f"paged chunk kernel ({label})")
        err = max(err, e)
        n_bytes, flops = paged_cost(pt, pos, 1, H, Hkv, D, P)
        bound, by = bound_ms(n_bytes, flops)
        library = gather_sdpa(torch, q4, kp, vp, pt, pos, scale)
        t = {"ms": timer.ms(lambda: paged_ops.paged_decode(
                 q, kp, vp, pt, lengths, scale=scale, n_rep=n_rep)),
             "plain_ms": timer.ms(lambda: paged_ref.paged_decode_ref(
                 q, kp, vp, pt, lengths, scale=scale, n_rep=n_rep)),
             "library_ms": timer.ms(library),
             "bound_ms": bound, "bound_by": by}
        b1_ms = timer.ms(lambda: paged_ops.paged_decode_chunk(
            q4, kp, vp, pt, pos, scale=scale, n_rep=n_rep))
        timed[label] = t
        print(f"[kernels] paged_decode timed {label} B={B} H={H} Hkv={Hkv} "
              f"D={D} P={P}: ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
              f"library_ms={t['library_ms']:.4f} (gather + SDPA) "
              f"paged_decode_chunk_T1_ms={b1_ms:.4f} bound_ms={bound:.5f} "
              f"({by}; {n_bytes} B, {flops} flop)")
    return dict(source="src/repro_torch/csrc/paged_decode.cu",
                replaces="src/repro/kernels/paged_attention/"
                         "paged_attention.py:166",
                max_abs_err=err, **timed["serve"])


def flash_rows(torch, timer, flash_ops, flash_ref, tag, H, D, seed,
               cases):
    """The flash kernel at BH=H, head dim D, bf16, causal: at each (S,
    window, timed) of ``cases`` held against its plain version, and where
    ``timed`` timed beside it and SDPA (``is_causal`` without a window, a
    boolean mask with one).  Returns the largest difference and the
    timings by (S, window)."""
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(seed)
    scale = D ** -0.5
    err, timings = 0.0, {}
    for S, window, timed in cases:
        q, k, v = (torch.randn((H, S, D), generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(3))
        got = flash_ops.flash_attention_bhsd(q, k, v, causal=True,
                                             window=window, scale=scale)
        torch.cuda.synchronize()
        want = flash_ref.flash_attention_bhsd_ref(q, k, v, causal=True,
                                                  window=window, scale=scale)
        e = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), **KERNEL_TOL)
        print(f"[{tag}] flash_attention_bhsd S={S} window={window} BH={H} "
              f"D={D} max_abs_err={e:.3e} tol={KERNEL_TOL} ok={ok}")
        check(ok and bool(torch.isfinite(got).all()),
              f"flash_attention_bhsd disagrees with its plain version "
              f"(S={S}, window={window}, D={D})")
        err = max(err, e)
        if not timed:
            continue
        n_bytes, flops = flash_cost(H, S, D, window)
        bound, by = bound_ms(n_bytes, flops)
        q4, k4, v4 = (x[None] for x in (q, k, v))
        if window is None:
            sdpa = dict(is_causal=True)
        else:
            i = torch.arange(S, device="cuda")
            sdpa = dict(attn_mask=(i[None, :] <= i[:, None])
                        & (i[None, :] > i[:, None] - window))
        t = {"ms": timer.ms(lambda: flash_ops.flash_attention_bhsd(
                 q, k, v, causal=True, window=window, scale=scale)),
             "plain_ms": timer.ms(lambda: flash_ref.flash_attention_bhsd_ref(
                 q, k, v, causal=True, window=window, scale=scale)),
             "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                 q4, k4, v4, scale=scale, **sdpa)),
             "bound_ms": bound, "bound_by": by}
        timings[S, window] = t
        print(f"[{tag}] flash_attention_bhsd timed BH={H} S={S} D={D} "
              f"window={window}: ms={t['ms']:.4f} plain_ms="
              f"{t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} (SDPA) "
              f"bound_ms={bound:.5f} ({by}; {n_bytes} B, {flops} flop)")
    return err, timings


def ring_rows(torch, timer, paged_ops, paged_ref, tag, H, Hkv, D, seed,
              cases):
    """The ring kernel (``decode_attention_kernel``) on bf16 q [B,1,H,D]
    and caches [B,C,Hkv,D]: at each (label, C, window, pos) of ``cases``
    held against its plain version, and where ``label`` is not None timed
    beside it and SDPA with a boolean mask over the GQA-repeated cache.
    Returns the largest difference and the timings by label."""
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(seed)
    n_rep, scale = H // Hkv, D ** -0.5
    err, timings = 0.0, {}
    for label, C, window, pos in cases:
        B = len(pos)
        q = torch.randn((B, 1, H, D), generator=g, device="cuda")
        ck, cv = (torch.randn((B, C, Hkv, D), generator=g, device="cuda")
                  for _ in range(2))
        q, ck, cv = (x.to(torch.bfloat16) for x in (q, ck, cv))
        pos_t = torch.from_numpy(pos.astype(np.int32)).cuda()
        got = paged_ops.decode_attention_kernel(q, ck, cv, pos_t,
                                                window=window, scale=scale,
                                                n_rep=n_rep)
        torch.cuda.synchronize()
        want = paged_ref.decode_ring_ref(q, ck, cv, pos_t, scale=scale,
                                         n_rep=n_rep, window=window)
        e = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), **KERNEL_TOL)
        wrapped = " (wrapped)" if int(pos.min()) >= C else ""
        print(f"[{tag}] decode_ring B={B} C={C} H={H} Hkv={Hkv} D={D} "
              f"window={window} pos={pos.min()}..{pos.max()}{wrapped} "
              f"max_abs_err={e:.3e} tol={KERNEL_TOL} ok={ok}")
        check(ok and bool(torch.isfinite(got).all()),
              f"decode_ring disagrees with its plain version (C={C}, "
              f"window={window}, D={D})")
        err = max(err, e)
        if label is None:
            continue
        visible = paged_ref.ring_visible(pos_t, C, window)
        n_bytes, flops = ring_cost(visible, H, Hkv, D)
        bound, by = bound_ms(n_bytes, flops)
        mask = visible[:, None, None, :]

        def library():
            kr = ck.repeat_interleave(n_rep, dim=2).transpose(1, 2)
            vr = cv.repeat_interleave(n_rep, dim=2).transpose(1, 2)
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), kr, vr, attn_mask=mask, scale=scale)

        t = {"ms": timer.ms(lambda: paged_ops.decode_attention_kernel(
                 q, ck, cv, pos_t, window=window, scale=scale, n_rep=n_rep)),
             "plain_ms": timer.ms(lambda: paged_ref.decode_ring_ref(
                 q, ck, cv, pos_t, scale=scale, n_rep=n_rep, window=window)),
             "library_ms": timer.ms(library),
             "bound_ms": bound, "bound_by": by}
        timings[label] = t
        print(f"[{tag}] decode_ring timed ({label}) B={B} C={C} H={H} "
              f"Hkv={Hkv} D={D} window={window}: ms={t['ms']:.4f} plain_ms="
              f"{t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
              f"(repeat + SDPA) bound_ms={bound:.5f} ({by}; {n_bytes} B, "
              f"{flops} flop; {B * Hkv} blocks)")
    return err, timings


def moe_kernel_rows(torch, timer, moe_ops, moe_ref, cfg):
    """The expert FFN at granite-moe-1b-a400m's full width (E=32, D=1024,
    F=512, bf16, the model's init scales): the dropless MoE's token block
    expanded over the experts at C=8 (a decode step of 8 slots) and C=64
    (a chunked-prefill step, 8 slots x 8 tokens), and a contiguous [E,37,D]
    buffer (a row-tile tail); then the C=64 launch's rows against the same
    rows launched as C=1 and C=8, bitwise; timed at C=64 and C=8."""
    F = torch.nn.functional
    E, D, Fe = cfg.n_experts, cfg.d_model, cfg.d_expert
    g = torch.Generator(device="cuda").manual_seed(13)

    def randn(*shape, std=(2.0 / (D + Fe)) ** 0.5):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(
            torch.bfloat16)

    w = (randn(E, D, Fe), randn(E, D, Fe), randn(E, Fe, D))
    err, blocks = 0.0, {}
    for C, expanded in ((8, True), (64, True), (37, False)):
        x = randn(C if expanded else E * C, D, std=1.0)
        xe = x[None].expand(E, C, D) if expanded else x.view(E, C, D)
        got = moe_ops.moe_ffn(xe, *w)
        torch.cuda.synchronize()
        want = moe_ref.moe_ffn_ref(xe, *w)
        e = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), **KERNEL_TOL)
        print(f"[kernels] moe_ffn E={E} C={C} D={D} F={Fe} "
              f"{'expanded' if expanded else 'contiguous'} max_abs_err="
              f"{e:.3e} |out|max={want.float().abs().max().item():.3f} "
              f"tol={KERNEL_TOL} ok={ok}")
        check(ok and bool(torch.isfinite(got).all()),
              f"moe_ffn disagrees with its plain version (C={C})")
        err = max(err, e)
        blocks[C] = (x, got)
    x, full = blocks[64]
    for width in (1, 8):
        for c0 in range(0, 64, width):
            part = moe_ops.moe_ffn(x[c0:c0 + width][None].expand(E, width, D),
                                   *w)
            check(torch.equal(part, full[:, c0:c0 + width]),
                  f"moe_ffn rows {c0}..{c0 + width - 1} launched as C={width} "
                  f"differ from the same rows of the C=64 launch")
    print("[kernels] moe_ffn: the 64 rows of the C=64 launch equal, bitwise, "
          "the same rows launched as C=1 (64 launches) and as C=8 (8)")

    timings = {}
    for C in (64, 8):
        xe = randn(C, D, std=1.0)[None].expand(E, C, D)
        n_bytes, flops = moe_cost(E, C, D, Fe)
        bound, by = bound_ms(n_bytes, flops)

        def library():
            # three bmm and silu in bf16: a yardstick, never the port's path
            return torch.bmm(F.silu(torch.bmm(xe, w[0])) * torch.bmm(xe, w[1]),
                             w[2])

        t = {"ms": timer.ms(lambda: moe_ops.moe_ffn(xe, *w)),
             "plain_ms": timer.ms(lambda: moe_ref.moe_ffn_ref(xe, *w)),
             "library_ms": timer.ms(library),
             "bound_ms": bound, "bound_by": by}
        timings[C] = t
        print(f"[kernels] moe_ffn timed E={E} C={C} D={D} F={Fe} (token "
              f"block expanded): ms={t['ms']:.4f} plain_ms="
              f"{t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
              f"bound_ms={bound:.5f} ({by}; {n_bytes} B, {flops} flop)")
    return dict(source="src/repro_torch/csrc/moe_ffn.cu",
                replaces="src/repro/kernels/moe_ffn/moe_ffn.py:50",
                max_abs_err=err, **timings[64])


def ssd_cost(B, S, H, P, N, Q):
    """Bytes and flops of one chunk scan (bf16 x, B, C and y; f32 dt, A and
    final state): each input read once, each output written once; per
    (b, h, chunk of Qc steps) the lower triangle of C.B^T over N and of the
    decayed scores times dt.x over P, Qc(Qc+1)/2 (N + P) multiply-adds, and
    C.S and the state update, 2 Qc N P."""
    n_bytes = (2 * 2 * B * S * H * P + 4 * B * S * H + 4 * H
               + 2 * 2 * B * S * N + 4 * B * H * P * N)
    macs = 0
    for s0 in range(0, S, Q):
        q = min(Q, S - s0)
        macs += q * (q + 1) // 2 * (N + P) + 2 * q * N * P
    return n_bytes, 2 * macs * B * H


def ssd_kernel_rows(torch, timer, ssd_ops, ssd_ref, cfg):
    """The chunk scan at mamba2-130m's full width (H=24, P=64, N=128, chunk
    256): x ~ 0.5 N(0,1), dt = softplus(N(0,1)), the model's initial rates
    A = linspace(1, 16), B and C ~ 0.3 N(0,1).  In bf16 at the prefill
    shapes the engine gives it (B=1 at the buckets 512 and 1024, and B=8 at
    512, the model API's batch), against the plain version; in float32 at
    B=1, S=512 and at a ragged B=2, S=300 with initial states, against the
    plain version and the token-by-token recurrence.  Timed in bf16 at the
    three shapes."""
    F = torch.nn.functional
    H, P, N, Q = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.ssm_chunk
    g = torch.Generator(device="cuda").manual_seed(17)
    A = torch.linspace(1.0, 16.0, H, device="cuda")

    def inputs(B, S, dtype, init=False):
        def randn(*shape):
            return torch.randn(shape, generator=g, device="cuda")
        x = (randn(B, S, H, P) * 0.5).to(dtype)
        dt = F.softplus(randn(B, S, H))
        Bm, Cm = ((randn(B, S, N) * 0.3).to(dtype) for _ in range(2))
        h0 = randn(B, H, P, N) * 0.5 if init else None
        return (x, dt, A, Bm, Cm), h0

    def rel(got, want):
        want = want.float()
        return ((got.float() - want).abs().max() / want.abs().max()).item()

    err, timed = 0.0, {}
    for B, S, dtype, init in ((1, 512, torch.bfloat16, False),
                              (1, 1024, torch.bfloat16, False),
                              (8, 512, torch.bfloat16, False),
                              (1, 512, torch.float32, False),
                              (2, 300, torch.float32, True)):
        args, h0 = inputs(B, S, dtype, init)
        y, final = ssd_ops.ssd_chunk_scan(*args, chunk=Q, init_state=h0)
        torch.cuda.synchronize()
        want_y, want_final = ssd_ref.ssd_chunked_ref(*args, Q, h0)
        e = (y.float() - want_y.float()).abs().max().item()
        ry, rs = rel(y, want_y), rel(final, want_final)
        name = str(dtype).removeprefix("torch.")
        tol = SSD_REL_TOL[name]
        ok = ry <= tol and rs <= SSD_REL_TOL["float32"]
        msg = ""
        if dtype == torch.float32:
            seq_y, seq_final = ssd_ref.ssd_sequential(*args, init_state=h0)
            qy, qs = rel(y, seq_y), rel(final, seq_final)
            ok = ok and qy <= tol and qs <= tol
            msg = f"; vs the recurrence y {qy:.3e} state {qs:.3e}"
        print(f"[kernels] ssd_chunk_scan B={B} S={S} H={H} P={P} N={N} "
              f"Q={Q} {name}{' init_state' if init else ''}: max_abs_err="
              f"{e:.3e} |y|max={want_y.float().abs().max():.3f}; relative "
              f"to the largest value y {ry:.3e} state {rs:.3e} (tol y {tol}"
              f", state {SSD_REL_TOL['float32']}){msg} ok={ok}")
        check(ok and bool(torch.isfinite(y).all())
              and bool(torch.isfinite(final).all()),
              f"ssd_chunk_scan disagrees with its plain version (B={B}, "
              f"S={S}, {dtype})")
        if dtype == torch.bfloat16:
            err = max(err, e)
            n_bytes, flops = ssd_cost(B, S, H, P, N, Q)
            bound, by = bound_ms(n_bytes, flops)
            t = {"ms": timer.ms(lambda: ssd_ops.ssd_chunk_scan(
                     *args, chunk=Q)),
                 "plain_ms": timer.ms(lambda: ssd_ref.ssd_chunked_ref(
                     *args, Q)),
                 "library_ms": None, "bound_ms": bound, "bound_by": by}
            timed[B, S] = t
            print(f"[kernels] ssd_chunk_scan timed B={B} S={S}: ms="
                  f"{t['ms']:.4f} plain_ms={t['plain_ms']:.4f} library_ms="
                  f"none (no PyTorch call computes the scan) bound_ms="
                  f"{bound:.5f} ({by}; {n_bytes} B, {flops} flop)")
    return dict(source="src/repro_torch/csrc/ssd.cu",
                replaces="src/repro/kernels/ssd/ssd.py:75",
                max_abs_err=err, **timed[1, 512])


def serve_trace(vocab):
    """Two waves of (session, prompt, max_new_tokens): 4 agent sessions
    that share a 128-token system prompt and come back for a second turn,
    and 8 single-turn users, half of them on the same system prompt."""
    rng = np.random.default_rng(0)
    sys_prompt = rng.integers(0, vocab, 128)

    def toks(lo, hi):
        return rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))

    wave1 = [(f"agent{i}", np.concatenate([sys_prompt, toks(32, 384)]))
             for i in range(4)]
    wave1 += [(f"user{i}", toks(32, 512)) for i in range(4)]
    wave2 = [(f"agent{i}", toks(32, 96)) for i in range(4)]
    wave2 += [(f"user{i}", np.concatenate([sys_prompt, toks(32, 384)]))
              for i in range(4, 8)]
    return [wave1, wave2]


def run_trace(engine, vocab, Request, sampling):
    """Serve both waves of :func:`serve_trace`, each until the engine is
    idle.  Returns (requests, per-step host ms, wall seconds); every step
    ends with the greedy tokens copied to the host, which synchronises."""
    reqs, step_ms = [], []
    t0 = time.perf_counter()
    for wave in serve_trace(vocab):
        for sid, prompt in wave:
            req = Request.make(prompt, session_id=sid, sampling=sampling)
            engine.submit(req)
            reqs.append(req)
        while True:
            t = time.perf_counter()
            n = engine.step()
            if n == 0 and len(engine.queue) == 0:
                break
            step_ms.append((time.perf_counter() - t) * 1e3)
    return reqs, step_ms, time.perf_counter() - t0


def profile_window(torch, engine, cfg, Request, sampling, n_warm=4,
                   n_steps=10):
    """A third wave of 8 fresh requests; ``n_steps`` engine steps of it run
    under ``torch.profiler``: the device's busy share of the window and
    the kernels that fill it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(4)
    reqs = [Request.make(rng.integers(0, cfg.vocab_size,
                                      int(rng.integers(64, 257))),
                         session_id=f"prof{i}", sampling=sampling)
            for i in range(8)]
    for r in reqs:
        engine.submit(r)
    for _ in range(n_warm):
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    engine.run_until_idle()
    check(all(r.finished for r in reqs), "a profiled request did not finish")
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels:
        print("[profile] the trace holds no device events: busy share not "
              "measured")
        return
    print(f"[profile] {n_steps} steps in {wall_ms:.1f} ms host wall; device "
          f"busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f} %; "
          f"{sum(e.count for e in kernels) / n_steps:.0f} kernel launches "
          f"per step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.2f} ms "
              f"{e.count:6d}x  {e.key[:90]}")


def phase_serve(torch, rt, cfg, counters):
    from repro_torch.serving import Request, SamplingParams

    t0 = time.perf_counter()
    model = rt.build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    engine = rt.InferenceEngine(model, params, max_batch=8, max_seq=1024,
                                page_size=64, prefill_chunk=8)
    torch.cuda.synchronize()
    print(f"[serve] {cfg.arch_id}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, head_dim "
          f"{cfg.head_dim_}, vocab {cfg.vocab_size}, {cfg.param_count()} "
          f"params in {cfg.dtype}; set up in {time.perf_counter() - t0:.1f} s")

    for c in counters.values():
        c.launches = 0
    greedy = SamplingParams(max_new_tokens=32)
    reqs, step_ms, serve_s = run_trace(engine, cfg.vocab_size, Request,
                                       greedy)
    m = engine.metrics
    paged_after_serve = counters["paged_decode_chunk"].launches
    served = dict(decode_steps=m.decode_steps, tokens=m.tokens_generated,
                  prefill_tokens=m.prefill_tokens)
    profile_window(torch, engine, cfg, Request, SamplingParams(
        max_new_tokens=16))
    flash_before = counters["flash_attention_bhsd"].launches

    warm_toks = np.random.default_rng(1).integers(0, cfg.vocab_size, 300)
    t = time.perf_counter()
    warmed = engine.warm_session("replay0", [int(x) for x in warm_toks])
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t) * 1e3
    flash_warm = counters["flash_attention_bhsd"].launches - flash_before

    mono = rt.InferenceEngine(model, params, max_batch=8, max_seq=1024,
                              page_size=64, prefill_chunk=0)
    t = time.perf_counter()
    mono_toks = np.random.default_rng(3).integers(0, cfg.vocab_size, 257)
    mono_req = mono.generate(mono_toks, session_id="mono0", sampling=greedy)
    mono_s = time.perf_counter() - t
    launches = {name: c.launches for name, c in counters.items()}

    check(all(r.finished and len(r.generated) == 32 for r in reqs),
          "not every request finished with 32 tokens")
    check(mono_req.finished and len(mono_req.generated) == 32,
          "the prefill_chunk=0 request did not finish")
    check(warmed == 300 and flash_warm > 0,
          f"warm_session replayed {warmed} tokens with {flash_warm} flash "
          f"launches")
    check(launches["paged_decode_chunk"] > 0
          and launches["flash_attention_bhsd"] > 0,
          f"a kernel of the path never launched: {launches}")
    check(m.prefix_hits >= 4 and m.shared_prefix_hits >= 4,
          f"resume / prefix sharing did not fire: {m}")
    check(m.completed == len(reqs) + 8 and m.paged_append_failures == 0,
          f"engine metrics: {m}")
    engine.pool.check_invariants()
    mono.pool.check_invariants()
    vocab_ok = all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated)
    check(vocab_ok, "a generated token is outside the vocabulary")

    gen, steps = served["tokens"], served["decode_steps"]
    print(f"[serve] {len(reqs)} requests, {gen} tokens generated in "
          f"{serve_s:.2f} s: {gen / serve_s:.1f} generated tok/s, "
          f"{(served['prefill_tokens'] + gen) / serve_s:.1f} processed tok/s;"
          f" {steps} steps, step ms p50 {np.percentile(step_ms, 50):.2f} p99 "
          f"{np.percentile(step_ms, 99):.2f} max {max(step_ms):.2f}")
    print(f"[serve] metrics after the profiled wave: prefills={m.prefills} "
          f"prefill_tokens={m.prefill_tokens} prefix_hits="
          f"{m.prefix_hits} shared_prefix_hits={m.shared_prefix_hits} "
          f"shared_prefix_tokens={m.shared_prefix_tokens} pool="
          f"{engine.pool.stats}")
    print(f"[serve] paged_decode_chunk launches: {paged_after_serve} over "
          f"{steps} steps ({paged_after_serve / steps:.1f}/step); "
          f"warm_session(300 tokens) {warm_ms:.1f} ms with "
          f"{flash_warm} flash launches; prefill_chunk=0 request "
          f"(257-token prompt, 32 new) {mono_s:.2f} s; launches over the "
          f"phase: {launches}")
    del engine, mono
    torch.cuda.empty_cache()
    return model, params, launches, [list(r.generated) for r in reqs]


def to_f32(tree, device="cpu"):
    """A float32 copy of a parameter tree, on ``device``."""
    return {k: to_f32(v, device) if isinstance(v, dict)
            else v.float().to(device) for k, v in tree.items()}


def tree_leaves(tree):
    """The tensors of a parameter tree."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from tree_leaves(v)
        else:
            yield v


def to_cpu(tree):
    """A copy of a parameter tree on the host, in its own dtypes."""
    return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


def compare_logits(torch, name, card, ref, tol=LOGITS_REL_L2_TOL,
                   card_type="bf16"):
    """Card logits [V] against CPU float32 ones: finite, relative L2 error
    within ``tol``.  Returns (same argmax, the CPU's logit gap between its
    argmax and the card's, the largest absolute difference)."""
    rel = ((card - ref).norm() / ref.norm()).item()
    err = (card - ref).abs().max().item()
    a, b = int(card.argmax()), int(ref.argmax())
    gap = (ref[b] - ref[a]).item()
    print(f"[check] {name} logits card {card_type} vs cpu f32: rel_l2="
          f"{rel:.3e} (tol {tol}) max_abs={err:.3e} "
          f"|ref|max={ref.abs().max().item():.3f} argmax {a} vs {b} "
          f"(cpu gap {gap:.3e})")
    check(bool(torch.isfinite(card).all()) and rel <= tol,
          f"{name} logits disagree with the CPU float32 run")
    return a == b, gap, err


def first_step_logits(torch, rt, mdl, prm, dev, prompt):
    """Next-token logits [V] (float32, on the host) of ``prompt`` through a
    monolithic prefill and through one paged chunk step over a fresh
    pool."""
    n = len(prompt)
    toks = torch.from_numpy(prompt[None]).to(dev)
    logits, _ = mdl.prefill(prm, {"tokens": toks})
    pool = rt.PagedKVPool(mdl.cfg, n_pages=2, page_size=64, device=dev)
    pt = torch.tensor([[0, -1]], dtype=torch.int32, device=dev)
    step, _, _, _ = mdl.decode_chunk_paged(
        prm, toks, torch.tensor([n], dtype=torch.int32, device=dev),
        {"pos": torch.zeros(1, dtype=torch.int32, device=dev)},
        pool.k, pool.v, pt, max_seq=1024)
    return logits[0].float().cpu(), step[0, -1].float().cpu()


def phase_check(torch, rt, model, params, cfg, cpu_params):
    """First-step logits on the card (bf16, kernels) against the CPU
    (float32, plain versions), through prefill and through a paged step."""
    cpu_model = rt.build_model(cfg.replace(dtype="float32"))
    rng = np.random.default_rng(2)
    for n in (11, 19):
        prompt = rng.integers(0, cfg.vocab_size, n)
        outs = [first_step_logits(torch, rt, mdl, prm, dev, prompt)
                for mdl, prm, dev in ((model, params, "cuda"),
                                      (cpu_model, cpu_params, "cpu"))]
        for (card, ref), name in zip(zip(*outs), ("prefill", "paged step")):
            compare_logits(torch, f"prompt of {n}: {name}", card, ref)


def phase_decode(torch, rt, cfg, model, params, cpu_params, counters,
                 batch, prompt_len, steps=64, max_seq=1024):
    """The model API's dense path on the card: prefill with decode
    headroom, then ``steps`` decode_steps (each through 28 ring kernel
    launches).  Returns the ring kernel's launches."""
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    toks = torch.from_numpy(prompts).cuda()
    logits, cache = model.prefill(params, {"tokens": toks},
                                  pad_cache_to=max_seq)
    check(tuple(cache["k"].shape) == (cfg.n_layers, batch, max_seq,
                                      cfg.n_kv_heads, cfg.head_dim_),
          f"prefill cache shape {tuple(cache['k'].shape)}")
    tok = torch.argmax(logits, dim=-1)
    first_tok = tok.cpu()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    step_ms, first = [], None
    t0 = time.perf_counter()
    for i in range(steps):
        t = time.perf_counter()
        out, cache = model.decode_step(params, tok, cache)
        tok = torch.argmax(out, dim=-1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        if first is None:
            first = out.float().cpu()
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    ring = launches["decode_ring"]
    check(ring == cfg.n_layers * steps,
          f"decode_ring launched {ring} times in {steps} steps "
          f"(want {cfg.n_layers} per step): {launches}")
    check(bool(torch.isfinite(out).all()) and out.shape == (
        batch, cfg.vocab_size), "decode_step logits are not finite")
    check(cache["pos"].tolist() == [prompt_len + steps] * batch,
          f"decode positions {cache['pos'].tolist()}")
    print(f"[decode] B={batch} prompt {prompt_len} + {steps} decode_steps "
          f"(cache {max_seq}): {batch * steps / wall:.1f} tok/s, "
          f"{steps / wall:.2f} steps/s, step ms p50 "
          f"{np.percentile(step_ms, 50):.2f} p99 "
          f"{np.percentile(step_ms, 99):.2f}; launches {launches}")
    # the first step of two rows in float32, from the same prompts and the
    # card's prefill tokens: on the CPU (plain versions), and on the card
    # (kernels in float32, the weights upcast)
    f32_model = rt.build_model(cfg.replace(dtype="float32"))
    n = 2
    f32 = {}
    for dev, prm in (("cpu", cpu_params),
                     ("cuda", to_f32(params, device="cuda"))):
        _, c = f32_model.prefill(
            prm, {"tokens": torch.from_numpy(prompts[:n]).to(dev)},
            pad_cache_to=max_seq)
        out, _ = f32_model.decode_step(prm, first_tok[:n].to(dev), c)
        f32[dev] = out.float().cpu()
        del c, prm
    for b in range(n):
        ref = f32["cpu"][b]
        # bf16: argmax equal, unless the two tokens are tied within the
        # two runs' own largest difference
        same, gap, err = compare_logits(torch, f"decode_step row {b}",
                                        first[b], ref)
        check(same or gap <= err,
              f"decode_step row {b}: card bf16 and CPU argmax differ by a "
              f"CPU logit gap of {gap:.3e} > the runs' max difference "
              f"{err:.3e}")
        same, _, _ = compare_logits(torch, f"decode_step row {b}",
                                    f32["cuda"][b], ref, tol=F32_REL_L2_TOL,
                                    card_type="f32")
        check(same, f"decode_step row {b}: card f32 and CPU argmax differ")
    return ring


def phase_dense(torch, rt, cfg, model, params, counters, paged_tokens):
    """The serve trace on the dense slot-cache plane."""
    from repro_torch.serving import Request, SamplingParams

    engine = rt.InferenceEngine(model, params, max_batch=8, max_seq=1024,
                                page_size=64, prefill_chunk=8,
                                paged_decode=False)
    check(engine.telemetry()["paged_decode"] is False,
          "paged_decode=False did not select the dense plane")
    for c in counters.values():
        c.launches = 0
    reqs, step_ms, wall = run_trace(engine, cfg.vocab_size, Request,
                                    SamplingParams(max_new_tokens=32))
    launches = {name: c.launches for name, c in counters.items()}
    m = engine.metrics
    check(all(r.finished and len(r.generated) == 32 for r in reqs),
          "dense plane: not every request finished with 32 tokens")
    check(all(r.decode_path == "fused" for r in reqs),
          "dense plane: a request took another decode path")
    check(m.prefix_hits >= 4 and m.completed == len(reqs),
          f"dense plane: follow-up turns did not resume: {m}")
    engine.pool.check_invariants()
    same = sum(a == list(r.generated) for a, r in zip(paged_tokens, reqs))
    print(f"[dense] {len(reqs)} requests, {m.tokens_generated} tokens in "
          f"{wall:.2f} s: {m.tokens_generated / wall:.1f} generated tok/s, "
          f"{(m.prefill_tokens + m.tokens_generated) / wall:.1f} processed "
          f"tok/s; {m.decode_steps} steps, step ms p50 "
          f"{np.percentile(step_ms, 50):.2f} p99 "
          f"{np.percentile(step_ms, 99):.2f}; prefix_hits={m.prefix_hits} "
          f"shared_prefix_hits={m.shared_prefix_hits} pool="
          f"{engine.pool.stats}; {same}/{len(reqs)} requests with the paged "
          f"plane's tokens (bf16); launches {launches}")
    del engine
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase nalar
def http_chat(port, payload, timeout=300):
    """One chat completion over TCP (urllib), as an OpenAI client sends it.
    Returns the answer's text, its ``usage`` (None when streamed), the
    seconds to the first content event (None when not streamed) and the
    number of content events."""
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if not payload.get("stream"):
            body = json.loads(resp.read())
            return dict(text=body["choices"][0]["message"]["content"],
                        usage=body["usage"], ttft=None, events=1)
        deltas, last, ttft = [], None, None
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            data = line[len("data: "):]
            if data == "[DONE]":
                break
            last = json.loads(data)
            check(last["object"] != "error", f"stream failed: {last}")
            text = last["choices"][0]["delta"].get("content")
            if text:
                if ttft is None:
                    ttft = time.perf_counter() - t0
                deltas.append(text)
    check(last is not None and last["choices"][0]["finish_reason"] == "stop",
          f"stream ended without a stop event: {last}")
    return dict(text="".join(deltas), usage=None, ttft=ttft,
                events=len(deltas))


def http_wave(port, calls):
    """Send every (name, payload) of ``calls`` at once, one client thread
    each; returns {name: http_chat result}."""
    import threading
    out = {}

    def go(name, payload):
        try:
            out[name] = http_chat(port, payload)
        except BaseException as e:  # noqa: BLE001 — reported below
            out[name] = e
    threads = [threading.Thread(target=go, args=c) for c in calls]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "an HTTP client hung")
    bad = {k: v for k, v in out.items() if isinstance(v, BaseException)}
    check(not bad, f"HTTP requests failed: {bad}")
    return out


def nalar_trace():
    """The serve phase's trace shape as chat requests (``user`` is the Nalar
    session): wave 1 opens 4 agent sessions on a shared system prompt of
    128 tokens ("system:" and 127 words) and sends 4 single-turn users, two
    of them on the system prompt; wave 2 sends each agent's second turn
    (its history rides the session) and the 4 user prompts again as 4 new
    users.  Half of the 16 requests stream: agents 0-1 in wave 1, agents
    2-3 and the repeated prompts in wave 2.  Returns the two waves of
    (name, messages, stream)."""
    rng = np.random.default_rng(0)

    def words(lo, hi):
        n = int(rng.integers(lo, hi + 1))
        return " ".join(f"w{int(x)}" for x in rng.integers(0, 1 << 30, n))

    sys_msg = {"role": "system",
               "content": " ".join(f"s{i}" for i in range(127))}

    def msgs(text, system):
        return ([sys_msg] if system else []) + [{"role": "user",
                                                 "content": text}]
    users = [msgs(words(32, 512), False) for _ in range(2)]
    users += [msgs(words(32, 384), True) for _ in range(2)]
    wave1 = [(f"agent{i}", msgs(words(32, 384), True), i < 2)
             for i in range(4)]
    wave1 += [(f"user{i}", m, False) for i, m in enumerate(users)]
    wave2 = [(f"agent{i}", msgs(words(32, 96), False), i >= 2)
             for i in range(4)]
    wave2 += [(f"user{i + 4}", m, True) for i, m in enumerate(users)]
    return [wave1, wave2]


def nalar_b3_over_pool(torch, rtm, paged_ops, paged_ref, dtype_name):
    """B3 over the served pool: for each replica, one call over every
    session resident in its pool (the pool's own page tables and token
    counts) at layer 0 and the last layer, held against its plain version
    and the paged chunk kernel at T=1 on the same pages.  Returns the
    number of sessions read."""
    pool = rtm.engine_backends["llm"]
    g = torch.Generator(device="cuda").manual_seed(7)
    seen = 0
    for iid in pool.instance_ids:
        eng = pool.bridge_of(iid).engine
        kv = eng.pool
        sids = [s for s in rtm.kv_registry.instance_sessions(iid)
                if kv.session(s) is not None and kv.session(s).tokens > 0]
        check(sids, f"{iid}: no resident session")
        maxp = kv.pages_needed(eng.max_seq)
        pt = torch.from_numpy(np.stack([kv.page_table(s, maxp)
                                        for s in sids])).cuda()
        lengths = torch.tensor([kv.session(s).tokens for s in sids],
                               dtype=torch.int32, device="cuda")
        cfg = eng.cfg
        n_rep = cfg.n_heads // cfg.n_kv_heads
        scale = cfg.head_dim_ ** -0.5
        q = torch.randn(len(sids), cfg.n_heads, cfg.head_dim_, generator=g,
                        device="cuda").to(kv.k.dtype)
        for layer in (0, cfg.n_layers - 1):
            kp, vp = kv.k[layer], kv.v[layer]
            got = paged_ops.paged_decode(q, kp, vp, pt, lengths, scale=scale,
                                         n_rep=n_rep)
            want = paged_ref.paged_decode_ref(q, kp, vp, pt, lengths,
                                              scale=scale, n_rep=n_rep)
            b1 = paged_ops.paged_decode_chunk(q[:, None].contiguous(), kp, vp,
                                              pt, lengths - 1, scale=scale,
                                              n_rep=n_rep)[:, 0]
            e = (got.float() - want.float()).abs().max().item()
            e1 = (got.float() - b1.float()).abs().max().item()
            ok = (torch.allclose(got.float(), want.float(), **KERNEL_TOL)
                  and torch.allclose(got.float(), b1.float(), **KERNEL_TOL)
                  and bool(torch.isfinite(got).all()))
            print(f"[nalar] {dtype_name} B3 over {iid}'s pool, layer "
                  f"{layer}: {len(sids)} sessions of "
                  f"{lengths.min().item()}..{lengths.max().item()} tokens; "
                  f"max_abs_err {e:.3e} vs plain, {e1:.3e} vs "
                  f"paged_decode_chunk T=1 (tol {KERNEL_TOL}) ok={ok}")
            check(ok, f"B3 over the served pages of {iid} (layer {layer}) "
                      f"disagrees")
        seen += len(sids)
    return seen


def profiled(torch, fn):
    """Run ``fn`` under ``torch.profiler`` (host and device activity, as
    :func:`profile_window`); returns (device busy ms, host wall ms) of the
    window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA) / 1e3
    return busy_ms, wall_ms


def nalar_run(torch, rt, model, params, dtype_name, paged_ops, paged_ref,
              profile):
    """One run of the Nalar serving path over HTTP in one dtype: two
    replicas behind ``register_engine_pool``, the OpenAI front end on a
    thread, the trace of :func:`nalar_trace`, two migrations (replay, then
    page shipping) of two sessions with the same history, B3 over the
    served pages.  Returns {request name: generated token ids} and the
    run's numbers."""
    import threading

    from repro_torch.core import NalarRuntime, PolicyChain
    from repro_torch.launch.serve import OpenAIFrontend
    from repro_torch.serving import SamplingParams, register_engine_pool

    step_ms = []

    def timed(engine):
        step = engine.step

        def timed_step():
            t = time.perf_counter()
            n = step()
            if n:
                step_ms.append((time.perf_counter() - t) * 1e3)
            return n
        engine.step = timed_step
        return engine

    engines = [timed(rt.InferenceEngine(model, params, max_batch=8,
                                        max_seq=1024, page_size=64,
                                        prefill_chunk=8))
               for _ in range(2)]
    # a quiet global policy: routing is the Router's own (pin, KV locality,
    # least ETA), so the trace lands the same way in both dtypes
    rtm = NalarRuntime(simulate=False, policy=PolicyChain(),
                       nodes={"n0": {"GPU": 2, "CPU": 8}})
    register_engine_pool(rtm, "llm", engines,
                         sampling=SamplingParams(max_new_tokens=32),
                         resources={"GPU": 1})
    rtm.start()
    server = OpenAIFrontend(rtm, default_max_tokens=32).serve(port=0)
    port = server.server_address[1]
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    pool = rtm.engine_backends["llm"]
    iids = pool.instance_ids
    try:
        def payload(name, messages, stream):
            return dict(model="nalar-llm", messages=messages, user=name,
                        max_tokens=32, stream=stream)

        results, homes = {}, {}
        waves = nalar_trace()
        t0 = time.perf_counter()
        for w, wave in enumerate(waves):
            if w == 1:
                homes = {n: rtm.kv_registry.lookup(n).instance_id
                         for n, _, _ in waves[0] if n.startswith("agent")}
            calls = [(n, payload(n, m, st)) for n, m, st in wave]
            results.update({(n, w + 1): r
                            for n, r in http_wave(port, calls).items()})
        wall = time.perf_counter() - t0
        wave_steps = np.array(step_ms)
        if profile:
            # a third wave, profiled: 4 new users of 64 words and 8 new
            # tokens each (a short window: reading back the host trace of
            # both replicas takes several times the window itself)
            rng = np.random.default_rng(5)
            calls = [(f"prof{i}", dict(payload(f"prof{i}", [{
                "role": "user", "content": " ".join(
                    f"p{int(x)}" for x in rng.integers(0, 1 << 30, 64))}],
                False), max_tokens=8)) for i in range(4)]
            busy_ms, wall_ms = profiled(torch,
                                        lambda: http_wave(port, calls))
        hits = sum(e.metrics.prefix_hits for e in engines)
        for (name, turn), r in results.items():
            n_tok = len(r["text"].split())
            check(n_tok == 32 and (r["usage"] is None
                                   or r["usage"]["completion_tokens"] == 32),
                  f"{dtype_name} {name} turn {turn}: {n_tok} tokens")
        turn2 = {n: m for n, m, _ in waves[1]}
        for name, home in homes.items():
            check(rtm.kv_registry.lookup(name).instance_id == home,
                  f"{name}'s second turn left the replica holding its KV")
            r = results[(name, 2)]
            # unstreamed answers carry usage: a warm turn sends only its
            # own "user:" and words, its history is resident
            want = 1 + len(turn2[name][0]["content"].split())
            check(r["usage"] is None or r["usage"]["prompt_tokens"] == want,
                  f"{name}'s second turn sent {r['usage']} tokens, not its "
                  f"{want} new ones")
        check(hits >= 4, f"{dtype_name}: only {hits} prefix hits")
        streamed = [r["ttft"] for r in results.values()
                    if r["ttft"] is not None]
        check(len(streamed) == 8 and all(r["events"] > 1 for r in
                                          results.values()
                                          if r["ttft"] is not None),
              f"{dtype_name}: the stream was not incremental")
        same_stream = [results[(f"user{i + 4}", 2)]["text"]
                       == results[(f"user{i}", 1)]["text"] for i in range(4)]

        # migration: two sessions with one history on one replica; the
        # first moves by transcript replay, its pages are then dropped, the
        # second moves by page shipping; the next turn must decode alike.
        # Their role ("developer") starts no other prompt, so the replay
        # finds no resident prefix at the destination (the pool matches a
        # prefix down to one token) and prefills the whole transcript.
        mig_rng = np.random.default_rng(9)
        first, second = ([{"role": "developer", "content": " ".join(
            f"m{int(x)}" for x in mig_rng.integers(0, 1 << 30, n))}]
            for n in (200, 40))
        mig = {}
        for sid in ("mig-replay", "mig-pages"):
            rtm.router.pin(sid, "llm", iids[0])
            mig[sid, 1] = http_chat(port, payload(sid, first, False))
        for sid, ship in (("mig-replay", False), ("mig-pages", True)):
            pool.page_migration = ship
            check(pool.migrate_session(sid, iids[0], iids[1]) >= 1,
                  f"{sid} did not migrate")
            mode = pool.migrations[-1]["mode"]
            check(mode == ("pages" if ship else "replay"),
                  f"{sid} migrated by {mode}")
            mig[sid, 2] = http_chat(port, payload(sid, second, False))
            check(rtm.kv_registry.lookup(sid).instance_id == iids[1],
                  f"{sid}'s next turn is not on the destination")
            if not ship:
                rtm.kv_registry.release(sid)
        pool.page_migration = True
        same_mig = mig["mig-replay", 2]["text"] == mig["mig-pages", 2]["text"]
        print(f"[nalar] {dtype_name} migrations: {pool.migrations}; "
              f"pool stats {pool.stats}; next turn after page shipping "
              f"{'equals' if same_mig else 'DIFFERS FROM'} replay")
        n_b3 = nalar_b3_over_pool(torch, rtm, paged_ops, paged_ref,
                                  dtype_name)
        for e in engines:
            e.pool.check_invariants()
        toks = {f"{n}/{t}": [int(x) for x in r["text"].split()]
                for (n, t), r in list(results.items()) + list(mig.items())}
        ttft = np.array(streamed) * 1e3
        print(f"[nalar] {dtype_name}: 2 replicas of {model.cfg.arch_id} "
              f"over HTTP, 16 requests (8 streamed) of 32 new tokens in "
              f"{wall:.2f} s: {16 * 32 / wall:.1f} generated tok/s; TTFT "
              f"(streamed, HTTP) p50 {np.percentile(ttft, 50):.1f} ms p99 "
              f"{np.percentile(ttft, 99):.1f} ms; engine step ms p50 "
              f"{np.percentile(wave_steps, 50):.2f} p99 "
              f"{np.percentile(wave_steps, 99):.2f} over {len(wave_steps)} "
              f"steps of both replicas; "
              f"prefix hits {hits}; B3 read {n_b3} resident sessions")
        if profile:
            print(f"[profile] nalar {dtype_name}, a third wave of 4 "
                  f"requests (8 new tokens) over HTTP: "
                  f"{wall_ms:.1f} ms host wall, device busy {busy_ms:.1f} ms "
                  f"({100 * busy_ms / wall_ms:.1f} %)")
        return toks, same_stream, same_mig
    finally:
        server.shutdown()
        server.server_close()
        serving.join(timeout=30)
        rtm.shutdown()


def phase_nalar(torch, rt, cfg, cpu_params, counters, paged_ops, paged_ref,
                card):
    """The Nalar serving path at full width: runtime, engine pool, bridge
    and OpenAI front end over two qwen3-0.6b replicas that share one
    params tree (the serve phase's weights, carried over with
    ``interop.params_from_numpy``), in float32 and in bf16.  Float32 holds
    streamed == unstreamed text and page shipping == replay; bf16 holds
    completion and the pools' invariants and reports its agreement with
    float32.  Then the port's own ``serve.selftest`` on the card.  Every
    launch counter is set to 0 before the two runs and read after them;
    returns B3's launches (its reads of the served pools)."""
    from repro_torch.launch.serve import selftest

    def to_numpy(tree):
        return {k: to_numpy(v) if isinstance(v, dict) else v.numpy()
                for k, v in tree.items()}
    np_params = to_numpy(cpu_params)
    for c in counters.values():
        c.launches = 0
    runs = {}
    for name, dt in (("float32", None), ("bfloat16", torch.bfloat16)):
        t0 = time.perf_counter()
        model = rt.build_model(cfg.replace(dtype=name))
        params = rt.params_from_numpy(np_params, device="cuda", dtype=dt)
        runs[name] = nalar_run(torch, rt, model, params, name, paged_ops,
                               paged_ref, profile=name == "bfloat16")
        del params
        torch.cuda.empty_cache()
        print(f"[time] nalar {name}: {time.perf_counter() - t0:.1f} s")
    launches = {name: c.launches for name, c in counters.items()}
    f32, same_stream, same_mig = runs["float32"]
    check(all(same_stream), f"float32: streamed text differs from the "
                            f"unstreamed answer to the same prompt: "
                            f"{same_stream}")
    check(same_mig, "float32: the next turn after page shipping differs "
                    "from the one after replay")
    bf16, bf_stream, bf_mig = runs["bfloat16"]
    agree = sum(f32[k] == bf16[k] for k in f32)
    print(f"[nalar] bf16 vs float32: {agree}/{len(f32)} requests with the "
          f"same tokens; bf16 streamed == unstreamed {sum(bf_stream)}/4, "
          f"page shipping == replay {bf_mig} (reported, not held); card "
          f"{card}")
    print(f"[nalar] launches over both runs: {launches}")
    check(launches["paged_decode"] > 0
          and launches["paged_decode_chunk"] > 0
          and launches["flash_attention_bhsd"] > 0,
          f"a kernel of the Nalar path never launched: {launches}")
    t0 = time.perf_counter()
    selftest(device="cuda")
    print(f"[nalar] serve.selftest(device='cuda') passed in "
          f"{time.perf_counter() - t0:.1f} s")
    return launches["paged_decode"]


class ForwardTally:
    """Counts the calls of a model's forward entry points, which the
    engine looks up on the model at every call, the chunk widths its steps
    feed, and the single-token steps they add up to (a ``decode_step`` is
    one, a ``decode_chunk`` of width T is T)."""

    NAMES = ("prefill", "decode_step", "decode_chunk", "decode_chunk_paged")

    def __init__(self, model):
        self.reset()
        for name in self.NAMES:
            if getattr(model, name) is not None:
                setattr(model, name, self._counted(name,
                                                   getattr(model, name)))

    def _counted(self, name, fn):
        def counted(*args, **kw):
            self.calls[name] += 1
            if name.startswith("decode_chunk"):
                self.widths.add(int(args[1].shape[1]))
                self.single_steps += int(args[1].shape[1])
            elif name == "decode_step":
                self.single_steps += 1
            return fn(*args, **kw)
        return counted

    def reset(self):
        self.calls = dict.fromkeys(self.NAMES, 0)
        self.widths = set()
        self.single_steps = 0

    @property
    def total(self) -> int:
        return sum(self.calls.values())


def record_next_token_rows(engine):
    """Keep on the device, per request id, the next-token logits row behind
    each token the engine samples (the engine's sampling step, wrapped)."""
    rows_of = {}
    sample_ready = engine._sample_ready

    def recording(active, valid, rows, greedy):
        for i in active:
            if valid[i] and i not in engine._pending_prompt:
                rows_of.setdefault(engine.slots[i].request_id, []).append(
                    rows[i].clone())
        return sample_ready(active, valid, rows, greedy)

    engine._sample_ready = recording
    return rows_of


def planes_agree(torch, label, paged, dense, tol=None):
    """Greedy tokens of one trace on the paged and the dense plane, with the
    logits rows behind them ([(tokens, rows)] per request, in trace order).
    While a request's tokens agree, both planes saw the same context: each
    row pair must agree to relative L2 ``tol``.  Where its tokens first
    differ, the paged plane's logits of the two tokens must be tied within
    the two rows' own largest difference (the rule of the decode phase's
    check).  With ``tol=None`` nothing is checked, only reported.  Returns
    the number of requests with equal tokens."""
    same = 0
    for j, ((ta, ra), (tb, rb)) in enumerate(zip(paged, dense)):
        check(len(ra) == len(ta) and len(rb) == len(tb),
              f"request {j}: {len(ra)} rows for {len(ta)} tokens")
        n = next((k for k, (a, b) in enumerate(zip(ta, tb)) if a != b), None)
        worst = 0.0
        for k in range(len(ta) if n is None else n + 1):
            a, b = ra[k].float(), rb[k].float()
            worst = max(worst, ((a - b).norm() / a.norm()).item())
        gap = err = 0.0
        if n is not None:
            a, b = ra[n].float(), rb[n].float()
            gap = (a[ta[n]] - a[tb[n]]).item()
            err = (a - b).abs().max().item()
            print(f"[moe] {label} request {j}: first different token at {n} "
                  f"({ta[n]} vs {tb[n]}); paged logit gap {gap:.3e}, the "
                  f"rows' max difference {err:.3e}; worst relative L2 up to "
                  f"there {worst:.3e}")
        same += n is None
        if tol is None:
            continue
        check(worst <= tol, f"{label} request {j}: the planes' logits differ "
              f"by relative L2 {worst:.3e} on the same context (tol {tol})")
        check(gap <= err, f"{label} request {j}: the planes' greedy tokens "
              f"differ at {n} by a logit gap of {gap:.3e} > the rows' max "
              f"difference {err:.3e}")
    print(f"[moe] {label}: {same}/{len(paged)} requests with the same greedy "
          f"tokens on both planes" + ("" if tol is None else
                                      f" (same-context logits within {tol})"))
    return same


def serve_plane(torch, rt, model, params, counters, tally, paged, profile):
    """The serve trace on one engine plane, greedy, the launch counters set
    to 0 just before and read just after.  Returns [(tokens, logits rows)]
    per request and the expert-FFN kernel's launches."""
    from repro_torch.serving import Request, SamplingParams

    cfg, L = model.cfg, model.cfg.n_layers
    plane = f"{cfg.dtype} {'paged' if paged else 'dense'} plane"
    engine = rt.InferenceEngine(model, params, max_batch=8, max_seq=1024,
                                page_size=64, prefill_chunk=8,
                                paged_decode=paged)
    rows_of = record_next_token_rows(engine)
    tally.reset()
    for c in counters.values():
        c.launches = 0
    reqs, step_ms, wall = run_trace(engine, cfg.vocab_size, Request,
                                    SamplingParams(max_new_tokens=32))
    m = engine.metrics
    gen, processed, steps = (m.tokens_generated,
                             m.prefill_tokens + m.tokens_generated,
                             m.decode_steps)
    if profile:
        profile_window(torch, engine, cfg, Request,
                       SamplingParams(max_new_tokens=16))
    launches = {name: c.launches for name, c in counters.items()}
    calls = dict(tally.calls)
    check(all(r.finished and len(r.generated) == 32 for r in reqs),
          f"moe, {plane}: not every request finished with 32 tokens")
    check(all(r.decode_path == ("paged" if paged else "fused") for r in reqs),
          f"moe, {plane}: a request took another decode path")
    check(m.prefix_hits >= 4 and (m.shared_prefix_hits >= 4 or not paged),
          f"moe, {plane}: resume / prefix sharing did not fire: {m}")
    check(8 in tally.widths, f"moe, {plane}: no chunked-prefill step of 8 "
          f"tokens ran (widths {sorted(tally.widths)})")
    check(launches["moe_ffn"] == L * tally.total,
          f"moe, {plane}: moe_ffn launched {launches['moe_ffn']} times in "
          f"{tally.total} forwards {calls} (want {L} each)")
    want_paged = L * calls["decode_chunk_paged"] if paged else 0
    check(launches["paged_decode_chunk"] == want_paged,
          f"moe, {plane}: paged_decode_chunk launched "
          f"{launches['paged_decode_chunk']} times (want {want_paged})")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          f"moe, {plane}: a token is outside the vocabulary")
    engine.pool.check_invariants()
    print(f"[moe] {plane}: {len(reqs)} requests, {gen} tokens in {wall:.2f} "
          f"s: {gen / wall:.1f} generated tok/s, {processed / wall:.1f} "
          f"processed tok/s; {steps} steps, step ms p50 "
          f"{np.percentile(step_ms, 50):.2f} p99 "
          f"{np.percentile(step_ms, 99):.2f}; prefix_hits={m.prefix_hits} "
          f"shared_prefix_hits={m.shared_prefix_hits}; forwards {calls}, "
          f"chunk widths {sorted(tally.widths)}; launches {launches}")
    out = [(list(r.generated), rows_of[r.request_id]) for r in reqs]
    del engine
    torch.cuda.empty_cache()
    return out, launches["moe_ffn"]


def phase_moe(torch, rt, counters):
    """granite-moe-1b-a400m at full width: the serve trace on both engine
    planes in bf16 (the model's type; timed), then again in float32
    (kernels in f32, the weights upcast), where the planes are held to each
    other; then first-step logits against the CPU.  In bf16 the planes'
    tokens are only reported: the planes attend with different code (the
    paged kernel, the dense plain math), bf16 rounds each, and top-k
    routing turns such a rounding step into another expert.  Returns the
    expert-FFN kernel's launches on the bf16 paged plane."""
    cfg = rt.get_config("granite-moe-1b-a400m")
    t0 = time.perf_counter()
    model = rt.build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    print(f"[moe] {cfg.arch_id}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, head_dim "
          f"{cfg.head_dim_}, {cfg.n_experts} experts top-{cfg.top_k} of width "
          f"{cfg.d_expert}, vocab {cfg.vocab_size}; {cfg.param_count()} "
          f"params ({cfg.param_count(active_only=True)} active) in "
          f"{cfg.dtype}; set up in {time.perf_counter() - t0:.1f} s")
    f32_model = rt.build_model(cfg.replace(dtype="float32"))
    f32_params = to_f32(params, device="cuda")
    runs, moe_launches = {}, 0
    for mdl, prm in ((model, params), (f32_model, f32_params)):
        tally = ForwardTally(mdl)
        for paged in (True, False):
            runs[mdl.cfg.dtype, paged], n = serve_plane(
                torch, rt, mdl, prm, counters, tally, paged,
                profile=paged and mdl is model)
            if paged and mdl is model:
                moe_launches = n
    planes_agree(torch, "bfloat16", runs["bfloat16", True],
                 runs["bfloat16", False])
    planes_agree(torch, "float32", runs["float32", True],
                 runs["float32", False], tol=F32_REL_L2_TOL)
    del runs
    moe_logits_check(torch, rt, model, params, f32_model, f32_params,
                     counters)
    return moe_launches


def decode_step_logits(torch, mdl, prm, dev, prompt, counters):
    """Logits [V] (float32, on the host) of one ``decode_step`` after a
    prefill of ``prompt`` with decode headroom, and the launches of that
    step alone (the counters set to 0 just before it, read just after)."""
    toks = torch.from_numpy(prompt[None]).to(dev)
    _, cache = mdl.prefill(prm, {"tokens": toks}, pad_cache_to=128)
    for c in counters.values():
        c.launches = 0
    out, _ = mdl.decode_step(prm, toks[:, 0], cache)
    return out[0].float().cpu(), {n: c.launches for n, c in counters.items()}


def moe_logits_check(torch, rt, model, params, f32_model, f32_params,
                     counters):
    """Next-token logits of two prompts (23 and 61 tokens: the CPU runs
    all 32 experts densely over them) through prefill, a paged step and a
    ``decode_step`` over the dense cache (the ring kernel at head_dim 64):
    the card in bf16 and in float32 against the CPU in float32."""
    cfg = model.cfg
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (23, 61)]
    runs = {}
    for label, mdl, prm, dev in (("bf16", model, params, "cuda"),
                                 ("f32", f32_model, f32_params, "cuda"),
                                 ("cpu", f32_model, to_f32(params), "cpu")):
        runs[label] = []
        for p in prompts:
            step, launches = decode_step_logits(torch, mdl, prm, dev, p,
                                                counters)
            runs[label].append(first_step_logits(torch, rt, mdl, prm, dev, p)
                               + (step,))
            if dev == "cuda":
                check(launches["decode_ring"] == cfg.n_layers
                      and launches["moe_ffn"] == cfg.n_layers,
                      f"{label} decode_step launched {launches} (want "
                      f"{cfg.n_layers} decode_ring and moe_ffn)")
        del prm
    print(f"[moe] one decode_step launches {cfg.n_layers} decode_ring and "
          f"{cfg.n_layers} moe_ffn kernels (bf16 and float32)")
    for i, prompt in enumerate(prompts):
        for j, name in enumerate(("prefill", "paged step", "decode_step")):
            ref = runs["cpu"][i][j]
            tag = f"{cfg.arch_id} prompt of {len(prompt)}: {name}"
            same, gap, err = compare_logits(torch, tag, runs["bf16"][i][j],
                                            ref)
            check(same or gap <= err,
                  f"{tag}: card bf16 and CPU argmax differ by a CPU logit "
                  f"gap of {gap:.3e} > the runs' max difference {err:.3e}")
            same, _, _ = compare_logits(torch, tag, runs["f32"][i][j], ref,
                                        tol=F32_REL_L2_TOL, card_type="f32")
            check(same, f"{tag}: card f32 and CPU argmax differ")


def ssm_serve(torch, rt, model, params, counters, tally, prefill_chunk):
    """The serve trace on one mamba2 engine (greedy, 32 new tokens each),
    the launch counters set to 0 just before and read just after, then a
    profiled third wave.  With ``prefill_chunk=0`` every admission is one
    monolithic prefill (the chunk scan in every layer); with 8 the prompts
    run through the fused recurrent step and the scan never launches.
    Returns (engine, requests, the scan's launches)."""
    from repro_torch.serving import Request, SamplingParams

    cfg, L = model.cfg, model.cfg.n_layers
    label = f"prefill_chunk={prefill_chunk}"
    engine = rt.InferenceEngine(model, params, max_batch=8, max_seq=1024,
                                prefill_chunk=prefill_chunk)
    tally.reset()
    for c in counters.values():
        c.launches = 0
    reqs, step_ms, wall = run_trace(engine, cfg.vocab_size, Request,
                                    SamplingParams(max_new_tokens=32))
    launches = {name: c.launches for name, c in counters.items()}
    calls, widths = dict(tally.calls), sorted(tally.widths)
    m = engine.metrics
    check(all(r.finished and len(r.generated) == 32 for r in reqs),
          f"ssm, {label}: not every request finished with 32 tokens")
    check(all(r.decode_path == "fused" for r in reqs),
          f"ssm, {label}: a request took another decode path")
    stored = [engine.pool.load(r.session_id) for r in reqs]
    check(m.completed == len(reqs) and m.prefix_hits == 0
          and all(x is not None and x[1] > 0 for x in stored),
          f"ssm, {label}: metrics {m}, or a finished session was not "
          f"stored in the state pool")
    want = L * len(reqs) if prefill_chunk == 0 else 0
    check(launches["ssd_chunk_scan"] == want
          and calls["prefill"] == want // L,
          f"ssm, {label}: ssd_chunk_scan launched "
          f"{launches['ssd_chunk_scan']} times over {calls['prefill']} "
          f"prefills (want {want}: {L} per admission)")
    check(prefill_chunk == 0 or 8 in widths,
          f"ssm, {label}: no fused step of 8 tokens ran (widths {widths})")
    check(all(n == 0 for name, n in launches.items()
              if name != "ssd_chunk_scan"),
          f"ssm, {label}: an attention or expert kernel launched: "
          f"{launches}")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          f"ssm, {label}: a token is outside the vocabulary")
    gen = m.tokens_generated
    print(f"[ssm] {label}: {len(reqs)} requests, {gen} tokens in {wall:.2f} "
          f"s: {gen / wall:.1f} generated tok/s, "
          f"{(m.prefill_tokens + gen) / wall:.1f} processed tok/s; "
          f"{m.decode_steps} steps, step ms p50 "
          f"{np.percentile(step_ms, 50):.2f} p99 "
          f"{np.percentile(step_ms, 99):.2f}; forwards {calls}, chunk "
          f"widths {widths}; launches {launches}")
    profile_window(torch, engine, cfg, Request,
                   SamplingParams(max_new_tokens=16))
    return engine, reqs, launches["ssd_chunk_scan"]


def ssm_logits_check(torch, rt, model, params, counters):
    """Next-token logits of two prompts through prefill (the chunk scan)
    and one ``decode_step`` after it, on the card in bf16 and in float32
    against the CPU in float32; and on the card in float32, prefill's last
    logits against ``decode_chunk`` over the same prompt from a zero state
    (the recurrence): the dual form's own invariant.

    A bf16 witness beside them: the same bf16 weights through the plain
    versions on the CPU (the path the tests hold to the JAX package in
    bf16).  Its distance from the CPU float32 logits is what bf16 rounding
    alone costs this model; the card's bf16 distance is printed beside it,
    with its margin to the bound, and so is the distance between the bf16
    prefill and the bf16 recurrence on each device (reported, not
    held)."""
    cfg = model.cfg
    f32_model = rt.build_model(cfg.replace(dtype="float32"))
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (23, 61)]
    runs = {}
    for label, mdl, prm, dev in (("bf16", model, params, "cuda"),
                                 ("f32", f32_model, to_f32(params, "cuda"),
                                  "cuda"),
                                 ("cpu", f32_model, to_f32(params), "cpu"),
                                 ("cpu-bf16", model, to_cpu(params),
                                  "cpu")):
        runs[label] = []
        for p in prompts:
            toks = torch.from_numpy(p[None]).to(dev)
            for c in counters.values():
                c.launches = 0
            logits, cache = mdl.prefill(prm, {"tokens": toks})
            n = counters["ssd_chunk_scan"].launches
            check(n == (cfg.n_layers if dev == "cuda" else 0),
                  f"{label} prefill launched ssd_chunk_scan {n} times")
            step, _ = mdl.decode_step(prm, toks[:, 0], cache)
            row = [logits[0].float().cpu(), step[0].float().cpu()]
            if label != "cpu":
                chunk, _ = mdl.decode_chunk(
                    prm, toks, torch.tensor([len(p)], dtype=torch.int32,
                                            device=dev),
                    mdl.init_cache(1, 1024, device=dev))
                row.append(chunk[0, -1].float().cpu())
            runs[label].append(row)
        del prm
    for i, prompt in enumerate(prompts):
        for j, name in enumerate(("prefill", "decode_step")):
            ref = runs["cpu"][i][j]
            tag = f"{cfg.arch_id} prompt of {len(prompt)}: {name}"
            same, gap, err = compare_logits(torch, tag, runs["bf16"][i][j],
                                            ref)
            check(same or gap <= err,
                  f"{tag}: card bf16 and CPU argmax differ by a CPU logit "
                  f"gap of {gap:.3e} > the runs' max difference {err:.3e}")
            same, _, _ = compare_logits(torch, tag, runs["f32"][i][j], ref,
                                        tol=F32_REL_L2_TOL, card_type="f32")
            check(same, f"{tag}: card f32 and CPU argmax differ")
            wit = runs["cpu-bf16"][i][j]
            check(bool(torch.isfinite(wit).all()),
                  f"{tag}: CPU bf16 logits are not finite")
            card_rel = ((runs["bf16"][i][j] - ref).norm() / ref.norm()).item()
            cpu_rel = ((wit - ref).norm() / ref.norm()).item()
            print(f"[ssm] bf16 witness, {tag}: rel_l2 from CPU f32: card "
                  f"bf16 {card_rel:.3e}, CPU bf16 {cpu_rel:.3e} (card/CPU "
                  f"{card_rel / cpu_rel:.2f}); card margin to the bound "
                  f"{LOGITS_REL_L2_TOL - card_rel:.3e} "
                  f"({card_rel / LOGITS_REL_L2_TOL:.1%} of "
                  f"{LOGITS_REL_L2_TOL}); card bf16 vs CPU bf16 "
                  f"{((runs['bf16'][i][j] - wit).norm() / wit.norm()).item():.3e}")
        for label in ("bf16", "cpu-bf16"):
            pre, rec = runs[label][i][0], runs[label][i][2]
            print(f"[ssm] prompt of {len(prompt)}, {label}: prefill (chunk "
                  f"scan or its plain version) vs decode_chunk (recurrence) "
                  f"last logits rel_l2="
                  f"{((pre - rec).norm() / rec.norm()).item():.3e} argmax "
                  f"equal {int(pre.argmax()) == int(rec.argmax())} "
                  f"(reported, not held)")
        pre, rec = runs["f32"][i][0], runs["f32"][i][2]
        rel = ((pre - rec).norm() / rec.norm()).item()
        same = int(pre.argmax()) == int(rec.argmax())
        print(f"[ssm] prompt of {len(prompt)}, card f32: prefill (chunk "
              f"scan) vs decode_chunk (recurrence) last logits rel_l2="
              f"{rel:.3e} (tol {F32_REL_L2_TOL}) argmax equal {same}")
        check(rel <= F32_REL_L2_TOL and same,
              f"prompt of {len(prompt)}: the chunked prefill and the "
              f"recurrence disagree on the card in float32")


def ssm_fused_vs_masked(torch, rt, model, params, counters):
    """Float32 on the card: 4 requests on the fused step (``decode_chunk``)
    and on the per-token masked step (a model without ``decode_chunk``)
    give the same greedy tokens, as the reference pins; and so does a
    ``prefill_chunk=0`` engine, whose admissions run the chunk scan over
    the left-padded bucket (the pad tokens' trace in the state is ~1e-5 of
    the logits, far below their gaps)."""
    import dataclasses
    from repro_torch.serving import Request, SamplingParams

    f32_model = rt.build_model(model.cfg.replace(dtype="float32"))
    f32_params = to_f32(params, "cuda")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, model.cfg.vocab_size, int(n))
               for n in rng.integers(20, 61, 4)]
    toks = {}
    for path, mdl, chunk in (
            ("fused", f32_model, 8),
            ("masked", dataclasses.replace(f32_model, decode_chunk=None), 8),
            ("monolithic", f32_model, 0)):
        engine = rt.InferenceEngine(mdl, f32_params, max_batch=4,
                                    max_seq=256, prefill_chunk=chunk)
        counters["ssd_chunk_scan"].launches = 0
        reqs = [Request.make(p, session_id=f"fm{i}",
                             sampling=SamplingParams(max_new_tokens=8))
                for i, p in enumerate(prompts)]
        for r in reqs:
            engine.submit(r)
        engine.run_until_idle()
        n = counters["ssd_chunk_scan"].launches
        want = path if chunk else "fused"
        check(all(r.finished and r.decode_path == want for r in reqs)
              and n == (0 if chunk else 4 * model.cfg.n_layers),
              f"ssm {path}: a request did not finish on the {want} path, "
              f"or the scan launched {n} times")
        toks[path] = [list(r.generated) for r in reqs]
    same = {path: sum(a == b for a, b in zip(toks["fused"], t))
            for path, t in toks.items() if path != "fused"}
    print(f"[ssm] float32: requests with the fused step's greedy tokens "
          f"out of 4: {same}")
    check(all(n == 4 for n in same.values()),
          "ssm: the fused, masked and monolithic paths disagree")


def phase_ssm(torch, rt, counters):
    """mamba2-130m at full width (random weights from a seed; granite
    freed first) on the engine's state-cache plane, bf16: the serve trace
    on a ``prefill_chunk=0`` engine (the chunk scan in every layer of every
    admission) and on a ``prefill_chunk=8`` one (the fused recurrent step;
    the scan never launches), each with a profiled wave; a
    ``warm_session`` (24 launches) and an ``export_session`` ->
    ``import_session`` onto the other engine; then logits against the CPU
    and the dual-form check, and the fused step against the masked one.
    Returns the scan's launches on the ``prefill_chunk=0`` trace."""
    cfg = rt.get_config("mamba2-130m")
    t0 = time.perf_counter()
    model = rt.build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    print(f"[ssm] {cfg.arch_id}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, d_inner {cfg.d_inner}, {cfg.n_ssm_heads} SSD heads "
          f"of {cfg.ssm_head_dim}, ssm_state {cfg.ssm_state}, conv "
          f"{cfg.ssm_conv}, chunk {cfg.ssm_chunk}, vocab {cfg.vocab_size}; "
          f"{cfg.param_count()} params in {cfg.dtype}; set up in "
          f"{time.perf_counter() - t0:.1f} s")
    tally = ForwardTally(model)
    mono, mono_reqs, launches = ssm_serve(torch, rt, model, params,
                                          counters, tally, 0)
    fused, fused_reqs, _ = ssm_serve(torch, rt, model, params, counters,
                                     tally, 8)
    same = sum(list(a.generated) == list(b.generated)
               for a, b in zip(mono_reqs, fused_reqs))
    print(f"[ssm] bf16: {same}/{len(mono_reqs)} requests with the same "
          f"greedy tokens through prefill (chunk scan) and through the "
          f"fused recurrent step (reported, not held: the two forms round "
          f"differently in bf16; float32 is held below)")

    warm_toks = np.random.default_rng(1).integers(0, cfg.vocab_size, 300)
    for c in counters.values():
        c.launches = 0
    t = time.perf_counter()
    warmed = mono.warm_session("replay0", [int(x) for x in warm_toks])
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t) * 1e3
    n = counters["ssd_chunk_scan"].launches
    check(warmed == 512 and n == cfg.n_layers,
          f"warm_session stored {warmed} tokens with {n} ssd_chunk_scan "
          f"launches (want 512 and {cfg.n_layers})")
    payload = mono.pool.export_session("replay0")
    check(fused.pool.import_session("replay0", payload),
          "import_session refused the session")
    state, tokens = fused.pool.load("replay0")
    before = {k: v.clone() for k, v in payload[0].items()}
    check(tokens == 512 and set(state) == {"conv", "ssm", "pos"}
          and all(torch.equal(state[k], before[k])
                  and state[k].data_ptr() != payload[0][k].data_ptr()
                  for k in state),
          "the imported session differs from the exported one or shares "
          "its tensors")
    for v in payload[0].values():
        v.add_(1)
    check(all(torch.equal(v, before[k]) for k, v in state.items()),
          "an in-place change to the exported row reached the imported one")
    print(f"[ssm] warm_session(300 tokens, bucket 512) {warm_ms:.1f} ms with "
          f"{n} ssd_chunk_scan launches; import_session copied "
          f"{sum(v.numel() * v.element_size() for v in state.values())}"
          f" bytes of state into tensors of its own")
    del mono, fused, mono_reqs, fused_reqs
    torch.cuda.empty_cache()
    ssm_logits_check(torch, rt, model, params, counters)
    ssm_fused_vs_masked(torch, rt, model, params, counters)
    return launches


# ------------------------------------------------------------ phase 9
# the cut of recurrentgemma-9b held against the CPU: its first (rec, rec,
# attn) group and its two tail layers (rec_layers 0, 1, 24, 25 and
# att_layers 0), five layers of the same pattern
HYBRID_CUT = ([0, 1, 24, 25], [0])
# RG-LRU scan vs its plain version: the same products and sums in the same
# order, each rounded to float32 (the kernel's __fmul_rn / __fadd_rn), so
# they must be equal bit for bit; the relative bound is stated beside it
RGLRU_REL_TOL = 1e-5


def rglru_cost(B, S, W):
    """Bytes and flops of one scan without h0: a and b read and y written
    (float32), the final state written; a multiply and an add per step and
    channel."""
    return 4 * (3 * B * S * W + B * W), 2 * B * S * W


def hybrid_kernel_rows(torch, timer, scan_ops, scan_ref, flash_ops,
                       flash_ref, paged_ops, paged_ref, cfg):
    """The hybrid's kernels at recurrentgemma-9b's widths, each against its
    plain version on the card and timed with the L2 flushed: the RG-LRU
    scan (W=4096, float32) at B=1 and B=8, S=512 and S=64, with and
    without h0; the flash kernel at head dim 256 (BH=16, S=512, bf16) with
    the model's 2048 window and a 128 one; the ring kernel at one kv head
    of 16 queries, D=256, window 2048, over 1024- and 2048-slot caches at
    positions past the window (the ring has wrapped).  Returns the scan's
    row of the kernel table."""
    W, H, Hkv = cfg.rglru_width, cfg.n_heads, cfg.n_kv_heads
    D, win = cfg.head_dim_, cfg.sliding_window
    g = torch.Generator(device="cuda").manual_seed(19)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    err, timed = 0.0, {}
    for B, S in ((1, 512), (1, 64), (8, 512), (8, 64)):
        # the decays' range of the reference's sweep, inputs * 0.1
        a = torch.rand((B, S, W), generator=g, device="cuda") * 0.299 + 0.7
        b = randn(B, S, W) * 0.1
        for h0 in (None, randn(B, W)):
            y, last = scan_ops.rglru_scan(a, b, h0)
            torch.cuda.synchronize()
            want_y, want_last = scan_ref.rglru_scan_ref(a, b, h0)
            e = (y - want_y).abs().max().item()
            rel = e / want_y.abs().max().item()
            same = torch.equal(y, want_y) and torch.equal(last, want_last)
            print(f"[hybrid] rglru_scan B={B} S={S} W={W} float32"
                  f"{' h0' if h0 is not None else ''}: max_abs_err={e:.3e} "
                  f"relative to the largest value {rel:.3e} (tol "
                  f"{RGLRU_REL_TOL}) bitwise equal {same}")
            check(same and rel <= RGLRU_REL_TOL
                  and bool(torch.isfinite(y).all()),
                  f"rglru_scan disagrees with its plain version (B={B}, "
                  f"S={S})")
            err = max(err, e)
        n_bytes, flops = rglru_cost(B, S, W)
        bound, by = bound_ms(n_bytes, flops, F32_FLOP_PER_S)
        t = {"ms": timer.ms(lambda: scan_ops.rglru_scan(a, b)),
             "plain_ms": timer.ms(lambda: scan_ref.rglru_scan_ref(a, b)),
             "library_ms": None, "bound_ms": bound, "bound_by": by}
        timed[B, S] = t
        print(f"[hybrid] rglru_scan timed B={B} S={S} W={W}: ms="
              f"{t['ms']:.4f} plain_ms={t['plain_ms']:.4f} library_ms=none "
              f"(no PyTorch call computes the recurrence) bound_ms="
              f"{bound:.5f} ({by}; {n_bytes} B, {flops} flop; "
              f"{B * W} threads)")

    flash_rows(torch, timer, flash_ops, flash_ref, "hybrid", H, D, seed=19,
               cases=((512, win, True), (512, 128, True)))
    rng = np.random.default_rng(19)
    ring_rows(torch, timer, paged_ops, paged_ref, "hybrid", H, Hkv, D,
              seed=19, cases=[(f"C={C}", C, win, rng.integers(lo, hi, 8))
                              for C, lo, hi in ((1024, 2048, 4096),
                                                (2048, 2048, 4096))])
    return dict(source="src/repro_torch/csrc/rglru_scan.cu",
                replaces="src/repro/kernels/rglru_scan/rglru_scan.py:50",
                max_abs_err=err, **timed[1, 512])


def hybrid_layer_counts(cfg):
    """(recurrent layers, attention layers) of a hybrid config."""
    n_att = sum((i + 1) % cfg.hybrid_period == 0 for i in range(cfg.n_layers))
    return cfg.n_layers - n_att, n_att


def hybrid_serve(torch, rt, model, params, counters, tally, prefill_chunk,
                 profile):
    """The serve trace on one recurrentgemma engine (greedy, 32 new tokens
    each), the launch counters set to 0 just before and read just after,
    then, with ``profile``, a profiled third wave.  With
    ``prefill_chunk=0`` every admission is one monolithic prefill of its
    left-padded bucket (the scan in each recurrent layer, the flash kernel
    in each attention layer); with 8 the prompts run through the fused
    step, 8 masked single steps, and neither launches.  Every single step
    attends through the ring kernel in each attention layer.  Returns
    (engine, requests, launches)."""
    from repro_torch.serving import Request, SamplingParams

    cfg = model.cfg
    n_rec, n_att = hybrid_layer_counts(cfg)
    label = f"prefill_chunk={prefill_chunk}"
    engine = rt.InferenceEngine(model, params, max_batch=8, max_seq=1024,
                                prefill_chunk=prefill_chunk)
    tally.reset()
    for c in counters.values():
        c.launches = 0
    reqs, step_ms, wall = run_trace(engine, cfg.vocab_size, Request,
                                    SamplingParams(max_new_tokens=32))
    launches = {name: c.launches for name, c in counters.items()}
    calls, widths = dict(tally.calls), sorted(tally.widths)
    steps = tally.single_steps
    m = engine.metrics
    check(all(r.finished and len(r.generated) == 32 for r in reqs),
          f"hybrid, {label}: not every request finished with 32 tokens")
    check(all(r.decode_path == "fused" for r in reqs),
          f"hybrid, {label}: a request took another decode path")
    stored = [engine.pool.load(r.session_id) for r in reqs]
    check(m.completed == len(reqs) and m.prefix_hits == 0
          and all(x is not None and x[1] > 0 for x in stored),
          f"hybrid, {label}: metrics {m}, or a finished session was not "
          f"stored in the state pool")
    admissions = len(reqs) if prefill_chunk == 0 else 0
    check(calls["prefill"] == admissions
          and launches["rglru_scan"] == n_rec * admissions
          and launches["flash_attention_bhsd"] == n_att * admissions,
          f"hybrid, {label}: {calls['prefill']} prefills launched "
          f"rglru_scan {launches['rglru_scan']} and flash_attention_bhsd "
          f"{launches['flash_attention_bhsd']} times (want {n_rec} and "
          f"{n_att} per admission, {admissions} admissions)")
    check(launches["decode_ring"] == n_att * steps,
          f"hybrid, {label}: decode_ring launched {launches['decode_ring']} "
          f"times over {steps} single steps (want {n_att} each)")
    check(all(launches[k] == 0 for k in ("paged_decode_chunk", "moe_ffn",
                                         "ssd_chunk_scan")),
          f"hybrid, {label}: a kernel off this path launched: {launches}")
    check(prefill_chunk == 0 or 8 in widths,
          f"hybrid, {label}: no fused step of 8 tokens ran (widths "
          f"{widths})")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          f"hybrid, {label}: a token is outside the vocabulary")
    gen = m.tokens_generated
    per = (f"; per admission rglru_scan {launches['rglru_scan'] // admissions}"
           f", flash_attention_bhsd "
           f"{launches['flash_attention_bhsd'] // admissions}"
           if admissions else "")
    print(f"[hybrid] {label}: {len(reqs)} requests, {gen} tokens in "
          f"{wall:.2f} s: {gen / wall:.1f} generated tok/s, "
          f"{(m.prefill_tokens + gen) / wall:.1f} processed tok/s; "
          f"{m.decode_steps} steps, step ms p50 "
          f"{np.percentile(step_ms, 50):.2f} p99 "
          f"{np.percentile(step_ms, 99):.2f}; forwards {calls}, chunk "
          f"widths {widths}, {steps} single steps ("
          f"{launches['decode_ring'] / max(steps, 1):.0f} decode_ring each)"
          f"{per}; launches {launches}")
    if profile:
        profile_window(torch, engine, cfg, Request,
                       SamplingParams(max_new_tokens=16))
    return engine, reqs, launches


def hybrid_cut(cfg, params):
    """The five-layer cut (``HYBRID_CUT``) of a full-depth hybrid: its
    config and its parameters (the layers copied, the embedding shared)."""
    rec, att = HYBRID_CUT

    def take(tree, idx):
        return {k: take(v, idx) if isinstance(v, dict) else v[idx]
                for k, v in tree.items()}

    return cfg.replace(n_layers=5), {
        "embed": params["embed"], "final_norm": params["final_norm"],
        "rec_layers": take(params["rec_layers"], rec),
        "att_layers": take(params["att_layers"], att)}


def hybrid_logits_check(torch, rt, cut_model, cut_params, counters):
    """On the cut: next-token logits of two prompts through prefill and one
    ``decode_step`` after it, on the card in bf16 and in float32 against
    the CPU in float32, with a CPU bf16 witness (the same bf16 weights
    through the plain versions: what bf16 alone costs); on the card in
    float32, prefill's last logits against ``decode_chunk`` over the same
    prompt from a zero state (the recurrence and the ring, per token).
    Then a prompt of 2100 tokens (past the 2048 window), prefilled into the
    2048-slot ring and stepped 4 times over the wrapped ring: card float32
    against CPU float32 at every step."""
    cfg = cut_model.cfg
    n_rec, n_att = hybrid_layer_counts(cfg)
    f32_model = rt.build_model(cfg.replace(dtype="float32"))
    f32_card = to_f32(cut_params, "cuda")
    f32_cpu = to_f32(cut_params)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (23, 61)]
    runs = {}
    for label, mdl, prm, dev in (("bf16", cut_model, cut_params, "cuda"),
                                 ("f32", f32_model, f32_card, "cuda"),
                                 ("cpu", f32_model, f32_cpu, "cpu"),
                                 ("cpu-bf16", cut_model, to_cpu(cut_params),
                                  "cpu")):
        runs[label] = []
        for p in prompts:
            toks = torch.from_numpy(p[None]).to(dev)
            for c in counters.values():
                c.launches = 0
            logits, cache = mdl.prefill(prm, {"tokens": toks},
                                        pad_cache_to=128)
            got = (counters["rglru_scan"].launches,
                   counters["flash_attention_bhsd"].launches)
            want = (n_rec, n_att) if dev == "cuda" else (0, 0)
            check(got == want, f"{label} prefill launched (rglru_scan, "
                  f"flash_attention_bhsd) {got}, want {want}")
            step, _ = mdl.decode_step(prm, toks[:, 0], cache)
            n = counters["decode_ring"].launches
            check(n == (n_att if dev == "cuda" else 0),
                  f"{label} decode_step launched decode_ring {n} times")
            row = [logits[0].float().cpu(), step[0].float().cpu()]
            if dev == "cuda":
                chunk, _ = mdl.decode_chunk(
                    prm, toks, torch.tensor([len(p)], dtype=torch.int32,
                                            device=dev),
                    mdl.init_cache(1, 4096, device=dev))
                row.append(chunk[0, -1].float().cpu())
            runs[label].append(row)
        del prm
    for i, prompt in enumerate(prompts):
        for j, name in enumerate(("prefill", "decode_step")):
            ref = runs["cpu"][i][j]
            tag = f"{cfg.arch_id} cut prompt of {len(prompt)}: {name}"
            same, gap, err = compare_logits(torch, tag, runs["bf16"][i][j],
                                            ref)
            check(same or gap <= err,
                  f"{tag}: card bf16 and CPU argmax differ by a CPU logit "
                  f"gap of {gap:.3e} > the runs' max difference {err:.3e}")
            same, _, _ = compare_logits(torch, tag, runs["f32"][i][j], ref,
                                        tol=F32_REL_L2_TOL, card_type="f32")
            check(same, f"{tag}: card f32 and CPU argmax differ")
            wit = runs["cpu-bf16"][i][j]
            check(bool(torch.isfinite(wit).all()),
                  f"{tag}: CPU bf16 logits are not finite")
            card_rel = ((runs["bf16"][i][j] - ref).norm() / ref.norm()).item()
            cpu_rel = ((wit - ref).norm() / ref.norm()).item()
            print(f"[hybrid] bf16 witness, {tag}: rel_l2 from CPU f32: card "
                  f"bf16 {card_rel:.3e}, CPU bf16 {cpu_rel:.3e} (card/CPU "
                  f"{card_rel / cpu_rel:.2f}); card margin to the bound "
                  f"{LOGITS_REL_L2_TOL - card_rel:.3e}")
        pre, rec = runs["bf16"][i][0], runs["bf16"][i][2]
        print(f"[hybrid] cut prompt of {len(prompt)}, card bf16: prefill vs "
              f"decode_chunk last logits rel_l2="
              f"{((pre - rec).norm() / rec.norm()).item():.3e} argmax equal "
              f"{int(pre.argmax()) == int(rec.argmax())} (reported, not "
              f"held: the two forms round differently in bf16; float32 is "
              f"held next)")
        pre, rec = runs["f32"][i][0], runs["f32"][i][2]
        rel = ((pre - rec).norm() / rec.norm()).item()
        same = int(pre.argmax()) == int(rec.argmax())
        print(f"[hybrid] cut prompt of {len(prompt)}, card f32: prefill "
              f"(scan, flash) vs decode_chunk (recurrence, ring) last logits "
              f"rel_l2={rel:.3e} (tol {F32_REL_L2_TOL}) argmax equal {same}")
        check(rel <= F32_REL_L2_TOL and same,
              f"prompt of {len(prompt)}: prefill and the recurrence disagree "
              f"on the card in float32")

    # past the window: the prefill rolls its last 2048 positions into the
    # ring, and every decode_step overwrites its oldest slot
    prompt = np.random.default_rng(11).integers(0, cfg.vocab_size, (1, 2100))
    rows, fed = {}, []
    for label, prm, dev in (("f32", f32_card, "cuda"), ("cpu", f32_cpu,
                                                        "cpu")):
        logits, cache = f32_model.prefill(
            prm, {"tokens": torch.from_numpy(prompt).to(dev)},
            pad_cache_to=4096)
        check(cache["k"].shape[2] == cfg.sliding_window,
              f"the cut's prefill ring has {cache['k'].shape[2]} slots")
        rows[label] = [logits[0].float().cpu()]
        tok = torch.argmax(logits, -1)
        for t in range(4):
            if label == "f32":
                fed.append(tok.cpu())     # the card's tokens feed both runs
            out, cache = f32_model.decode_step(prm, fed[t].to(dev), cache)
            rows[label].append(out[0].float().cpu())
            tok = torch.argmax(out, -1)
        check(cache["pos"].tolist() == [2104], "wrapped-ring positions")
    for t, (card, ref) in enumerate(zip(rows["f32"], rows["cpu"])):
        name = "prefill" if t == 0 else f"decode_step {t}"
        same, _, _ = compare_logits(
            torch, f"{cfg.arch_id} cut, 2100 tokens past the window: {name}",
            card, ref, tol=F32_REL_L2_TOL, card_type="f32")
        check(same, f"the cut's wrapped ring: card f32 and CPU argmax "
              f"differ at {name}")
    del f32_card, f32_cpu


def hybrid_ring_wrap(torch, rt, model, params, counters, steps=32):
    """Full depth, past the window: two prompts of 2300 tokens prefilled
    with ``pad_cache_to`` (the 2048-slot ring, rolled), then ``steps``
    ``decode_step``s over the wrapped ring, in bf16 and in float32 on the
    card (the weights upcast; the bf16 run's greedy tokens feed both).
    bf16 logits are held against float32 at the prefill and at every step:
    relative L2 within the bound, argmax equal unless tied within the two
    rows' largest difference."""
    cfg = model.cfg
    n_rec, n_att = hybrid_layer_counts(cfg)
    S, B = 2300, 2
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab_size, (B, S))).cuda()
    f32_model = rt.build_model(cfg.replace(dtype="float32"))
    rows, fed = {}, []
    for label in ("bf16", "f32"):
        mdl, prm = ((model, params) if label == "bf16" else
                    (f32_model, to_f32(params, "cuda")))
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        logits, cache = mdl.prefill(prm, {"tokens": toks}, pad_cache_to=4096)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        got = (counters["rglru_scan"].launches,
               counters["flash_attention_bhsd"].launches)
        check(got == (n_rec, n_att)
              and tuple(cache["k"].shape) == (n_att, B, cfg.sliding_window,
                                              cfg.n_kv_heads, cfg.head_dim_),
              f"{label} prefill of {S}: launches {got}, ring "
              f"{tuple(cache['k'].shape)}")
        rows[label] = [logits.float().cpu()]
        tok = torch.argmax(logits, -1)
        for c in counters.values():
            c.launches = 0
        step_ms = []
        for t in range(steps):
            if label == "bf16":
                fed.append(tok)
            t0 = time.perf_counter()
            out, cache = mdl.decode_step(prm, fed[t], cache)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            rows[label].append(out.float().cpu())
            tok = torch.argmax(out, -1)
        n = counters["decode_ring"].launches
        check(n == n_att * steps and cache["pos"].tolist() == [S + steps] * B
              and bool(torch.isfinite(out).all()),
              f"{label}: decode_ring launched {n} times in {steps} steps "
              f"(want {n_att} each), positions {cache['pos'].tolist()}")
        print(f"[hybrid] full depth, {label}: prefill of {B} x {S} tokens "
              f"{pre_ms:.1f} ms ({got[0]} rglru_scan, {got[1]} flash "
              f"launches, ring {cfg.sliding_window} slots rolled); {steps} "
              f"decode_steps over the wrapped ring, step ms p50 "
              f"{np.percentile(step_ms, 50):.2f} ({n_att} decode_ring each)")
        del prm, cache
        torch.cuda.empty_cache()
    worst, ties = 0.0, 0
    for t, (card, ref) in enumerate(zip(rows["bf16"], rows["f32"])):
        for b in range(B):
            a, r = card[b], ref[b]
            rel = ((a - r).norm() / r.norm()).item()
            err = (a - r).abs().max().item()
            x, y = int(a.argmax()), int(r.argmax())
            gap = (r[y] - r[x]).item()
            worst = max(worst, rel)
            ties += x != y
            name = "prefill" if t == 0 else f"decode_step {t}"
            check(bool(torch.isfinite(a).all()) and rel <= LOGITS_REL_L2_TOL,
                  f"full depth, {name} row {b}: bf16 vs f32 rel_l2 {rel:.3e}")
            check(x == y or gap <= err,
                  f"full depth, {name} row {b}: bf16 and f32 argmax differ "
                  f"by an f32 logit gap of {gap:.3e} > the rows' max "
                  f"difference {err:.3e}")
            if t in (0, 1, steps):
                print(f"[hybrid] full depth {name} row {b}: card bf16 vs "
                      f"card f32 rel_l2={rel:.3e} (tol {LOGITS_REL_L2_TOL}) "
                      f"max_abs={err:.3e} argmax {x} vs {y} (f32 gap "
                      f"{gap:.3e})")
    print(f"[hybrid] full depth over {len(rows['bf16'])} x {B} rows: worst "
          f"bf16 vs f32 rel_l2 {worst:.3e} (tol {LOGITS_REL_L2_TOL}); "
          f"{ties} argmax differences, each within the rows' max "
          f"difference")


def hybrid_fused_vs_masked(torch, rt, cut_model, cut_params, counters):
    """Float32 on the card, on the cut: the fused step (``decode_chunk``),
    the per-token masked step (a model without ``decode_chunk``) and a
    ``prefill_chunk=0`` engine give the same greedy tokens on 4 requests
    whose prompts fill their buckets (16, 32, 64 and 128 tokens).  A
    shorter prompt is left-padded to its bucket on a ``prefill_chunk=0``
    engine, and the pads then enter the recurrence and the attention
    window (as on the reference): a different function, so on 4 ragged
    prompts the monolithic engine's agreement is reported, not held."""
    import dataclasses
    from repro_torch.serving import Request, SamplingParams

    f32_model = rt.build_model(cut_model.cfg.replace(dtype="float32"))
    f32_params = to_f32(cut_params, "cuda")
    n_rec, _ = hybrid_layer_counts(f32_model.cfg)
    rng = np.random.default_rng(9)
    vocab = f32_model.cfg.vocab_size
    full = [rng.integers(0, vocab, n) for n in (16, 32, 64, 128)]
    ragged = [rng.integers(0, vocab, int(n)) for n in rng.integers(20, 61, 4)]
    toks = {}
    for path, mdl, chunk in (
            ("fused", f32_model, 8),
            ("masked", dataclasses.replace(f32_model, decode_chunk=None), 8),
            ("monolithic", f32_model, 0)):
        for kind, prompts in (("full", full), ("ragged", ragged)):
            engine = rt.InferenceEngine(mdl, f32_params, max_batch=4,
                                        max_seq=256, prefill_chunk=chunk)
            counters["rglru_scan"].launches = 0
            reqs = [Request.make(p, session_id=f"fm{i}",
                                 sampling=SamplingParams(max_new_tokens=8))
                    for i, p in enumerate(prompts)]
            for r in reqs:
                engine.submit(r)
            engine.run_until_idle()
            n = counters["rglru_scan"].launches
            want = path if chunk else "fused"
            check(all(r.finished and r.decode_path == want for r in reqs)
                  and n == (0 if chunk else 4 * n_rec),
                  f"hybrid {path}: a request did not finish on the {want} "
                  f"path, or the scan launched {n} times")
            toks[path, kind] = [list(r.generated) for r in reqs]
    same = {(path, kind): sum(a == b for a, b in zip(toks["fused", kind], t))
            for (path, kind), t in toks.items() if path != "fused"}
    print(f"[hybrid] float32 cut: requests with the fused step's greedy "
          f"tokens out of 4: {same} (held: masked on both sets, monolithic "
          f"on prompts that fill their buckets; monolithic on ragged "
          f"prompts reported: its pads enter the recurrence and window)")
    check(same["masked", "full"] == same["masked", "ragged"]
          == same["monolithic", "full"] == 4,
          "hybrid: the fused, masked and monolithic paths disagree")
    del f32_params


def phase_hybrid(torch, rt, counters, timer, scan_ops, scan_ref, flash_ops,
                 flash_ref, paged_ops, paged_ref):
    """recurrentgemma-9b at full width (random weights from a seed; mamba2
    freed first) on the engine's state-cache plane: the hybrid's kernel
    rows; the serve trace in bf16 on a ``prefill_chunk=0`` engine and on a
    ``prefill_chunk=8`` one (a profiled wave on the first); a
    ``warm_session`` and an ``export_session`` -> ``import_session`` onto
    the other engine; logits of the five-layer cut against the CPU; the
    full depth past the window, bf16 against float32; and the float32
    paths' tokens on the cut.  Returns (the scan's kernel row, its
    launches on the ``prefill_chunk=0`` serve trace)."""
    cfg = rt.get_config("recurrentgemma-9b")
    row = hybrid_kernel_rows(torch, timer, scan_ops, scan_ref, flash_ops,
                             flash_ref, paged_ops, paged_ref, cfg)
    n_rec, n_att = hybrid_layer_counts(cfg)
    t0 = time.perf_counter()
    model = rt.build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    leaves = list(tree_leaves(params))
    n_params = sum(v.numel() for v in leaves)
    n_bytes = sum(v.numel() * v.element_size() for v in leaves)
    print(f"[hybrid] {cfg.arch_id}: {cfg.n_layers} layers ({n_rec} "
          f"recurrent, {n_att} local attention, window "
          f"{cfg.sliding_window}), d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, head_dim {cfg.head_dim_}, d_ff "
          f"{cfg.d_ff}, RG-LRU width {cfg.rglru_width}, conv {cfg.ssm_conv}, "
          f"vocab {cfg.vocab_size}; {n_params} params in {cfg.dtype}, "
          f"{n_bytes / 2**30:.1f} GiB; set up in "
          f"{time.perf_counter() - t0:.1f} s")
    tally = ForwardTally(model)
    mono, mono_reqs, launches = hybrid_serve(torch, rt, model, params,
                                             counters, tally, 0, True)
    fused, fused_reqs, _ = hybrid_serve(torch, rt, model, params, counters,
                                        tally, 8, False)
    print(f"[time] hybrid: served, {time.perf_counter() - t0:.1f} s into "
          f"the phase's set-up")
    same = sum(list(a.generated) == list(b.generated)
               for a, b in zip(mono_reqs, fused_reqs))
    print(f"[hybrid] bf16: {same}/{len(mono_reqs)} requests with the same "
          f"greedy tokens on the prefill_chunk=0 and prefill_chunk=8 "
          f"engines (reported, not held: the left-padded bucket's pads "
          f"enter the recurrence and the window of a monolithic admission, "
          f"and the two forms round differently in bf16; float32 is held "
          f"on the cut)")

    warm_toks = np.random.default_rng(1).integers(0, cfg.vocab_size, 300)
    for c in counters.values():
        c.launches = 0
    t = time.perf_counter()
    warmed = mono.warm_session("replay0", [int(x) for x in warm_toks])
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t) * 1e3
    got = (counters["rglru_scan"].launches,
           counters["flash_attention_bhsd"].launches)
    check(warmed == 512 and got == (n_rec, n_att),
          f"warm_session stored {warmed} tokens with (rglru_scan, "
          f"flash_attention_bhsd) launches {got} (want 512 and "
          f"{(n_rec, n_att)})")
    payload = mono.pool.export_session("replay0")
    check(fused.pool.import_session("replay0", payload),
          "import_session refused the session")
    state, tokens = fused.pool.load("replay0")
    before = {k: v.clone() for k, v in payload[0].items()}
    check(tokens == 512 and set(state) == {"conv", "h", "k", "v", "pos"}
          and all(torch.equal(state[k], before[k])
                  and state[k].data_ptr() != payload[0][k].data_ptr()
                  for k in state),
          "the imported session differs from the exported one or shares "
          "its tensors")
    for v in payload[0].values():
        v.add_(1)
    check(all(torch.equal(v, before[k]) for k, v in state.items()),
          "an in-place change to the exported row reached the imported one")
    print(f"[hybrid] warm_session(300 tokens, bucket 512) {warm_ms:.1f} ms "
          f"with {got[0]} rglru_scan and {got[1]} flash_attention_bhsd "
          f"launches; import_session copied "
          f"{sum(v.numel() * v.element_size() for v in state.values())} "
          f"bytes of state (conv, h, K/V rings of {state['k'].shape[2]} "
          f"slots) into tensors of its own")
    del mono, fused, mono_reqs, fused_reqs, payload, state, before
    torch.cuda.empty_cache()

    cut_cfg, cut_params = hybrid_cut(cfg, params)
    cut_model = rt.build_model(cut_cfg)
    hybrid_logits_check(torch, rt, cut_model, cut_params, counters)
    print(f"[time] hybrid: cut held against the CPU, "
          f"{time.perf_counter() - t0:.1f} s into the phase's set-up")
    hybrid_fused_vs_masked(torch, rt, cut_model, cut_params, counters)
    print(f"[time] hybrid: float32 paths, {time.perf_counter() - t0:.1f} s "
          f"into the phase's set-up")
    del cut_params
    torch.cuda.empty_cache()
    hybrid_ring_wrap(torch, rt, model, params, counters)
    print(f"[time] hybrid: full depth, {time.perf_counter() - t0:.1f} s "
          f"into the phase's set-up")
    return row, launches["rglru_scan"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import repro_torch as rt
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.moe_ffn import ops as moe_ops
    from repro_torch.kernels.moe_ffn import ref as moe_ref
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_attention import ref as paged_ref
    from repro_torch.kernels.rglru_scan import ops as scan_ops
    from repro_torch.kernels.rglru_scan import ref as scan_ref
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref

    t_start = time.perf_counter()
    card = nvidia_smi()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    cfg = rt.get_config("qwen3-0.6b")
    moe_cfg = rt.get_config("granite-moe-1b-a400m")
    ssm_cfg = rt.get_config("mamba2-130m")
    counters = {"paged_decode_chunk": paged_ops.paged_decode_chunk,
                "flash_attention_bhsd": flash_ops.flash_attention_bhsd,
                "decode_ring": paged_ops.decode_attention_kernel,
                "moe_ffn": moe_ops.moe_ffn,
                "ssd_chunk_scan": ssd_ops.ssd_chunk_scan,
                "rglru_scan": scan_ops.rglru_scan,
                "paged_decode": paged_ops.paged_decode}
    decode_batch, decode_prompt = 8, 256
    try:
        phase_build(_build)
        timer = Timer(torch)
        rows = phase_kernels(torch, timer, paged_ops, paged_ref,
                             flash_ops, flash_ref, moe_ops, moe_ref, ssd_ops,
                             ssd_ref, cfg, moe_cfg, ssm_cfg, decode_batch,
                             decode_prompt)
        model, params, launches, paged_tokens = phase_serve(torch, rt, cfg,
                                                            counters)
        print(f"[time] serve done at {time.perf_counter() - t_start:.1f} s")
        cpu_params = to_f32(params)
        phase_check(torch, rt, model, params, cfg, cpu_params)
        launches["decode_ring"] = phase_decode(
            torch, rt, cfg, model, params, cpu_params, counters,
            decode_batch, decode_prompt)
        phase_dense(torch, rt, cfg, model, params, counters, paged_tokens)
        del model, params
        torch.cuda.empty_cache()
        launches["paged_decode"] = phase_nalar(
            torch, rt, cfg, cpu_params, counters, paged_ops, paged_ref, card)
        print(f"[time] nalar done at {time.perf_counter() - t_start:.1f} s")
        del cpu_params
        torch.cuda.empty_cache()
        print(f"[time] qwen3 phases done at "
              f"{time.perf_counter() - t_start:.1f} s")
        launches["moe_ffn"] = phase_moe(torch, rt, counters)
        print(f"[time] moe done at {time.perf_counter() - t_start:.1f} s")
        torch.cuda.empty_cache()
        launches["ssd_chunk_scan"] = phase_ssm(torch, rt, counters)
        print(f"[time] ssm done at {time.perf_counter() - t_start:.1f} s")
        torch.cuda.empty_cache()
        rows["rglru_scan"], launches["rglru_scan"] = phase_hybrid(
            torch, rt, counters, timer, scan_ops, scan_ref, flash_ops,
            flash_ref, paged_ops, paged_ref)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"[timer] {timer.host_bound} readings include host time")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    kernels = [dict(name=name, route="cuda", launches=launches[name], **row)
               for name, row in rows.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
