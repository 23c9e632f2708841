#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, in order; any failed check ends
the run with a non-zero exit and no result line:

1. build   — compile every CUDA kernel of the port from ``src/repro_torch/
             csrc/`` (one ``nvcc`` per source, all at once).
2. kernels — hold each kernel against its plain PyTorch version on the card
             in bf16 at the shapes of the path that runs it (the expert
             FFN also bitwise across row counts, the flash kernel's rows
             bitwise across sequence lengths, the SSD chunk scan's and the
             ring kernel's across batch sizes, the paged chunk kernel's
             across batch sizes and chunk lengths, and past its old
             128-row cap at R = 144 and 256; the one-token paged decode
             bitwise against the paged chunk kernel at T=1 and across
             batch sizes, up to one 32768-token sequence whose 256 splits
             a row go through the merge; the SSD chunk scan, the ring and
             the paged kernels also in float32, the scan against the
             token-by-token recurrence), and time kernel, plain version
             and a PyTorch yardstick (``library_ms``, never used by the
             port) against the card's bound; the timed paged, flash,
             expert-FFN, ring, SSD and RG-LRU rows name their design and
             each launch's ptxas registers and spills, the paged and ring
             rows also the wrapper's host time per call.
3. serve   — qwen3-0.6b at full width (random weights from a seed) served by
             the port's paged ``InferenceEngine``: 16 requests with
             follow-up turns and a shared system prompt (timed), a third
             wave of 8 requests of which 10 steps run under
             ``torch.profiler`` (the paged chunk kernel's split launches
             and merge apart), one ``warm_session`` replay and one request
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
7. spec    — speculative decoding on the paged plane over the same model,
             with a one-layer self-draft (``truncated_draft``, spec_k=3):
             the serve trace on a plain and a speculating engine in bf16
             (timed; spec rounds, acceptance and B1's launches by chunk
             width printed, B1 held to 28 launches a step and to launches
             at T=4; token agreement and committed K/V bytes reported),
             then in float32, where the speculating engine's greedy tokens
             must equal the plain engine's (or differ only at a tie), and
             so must a full-depth self-draft's (both waves, prompts cut to
             their last 64 tokens), which must accept at least 0.9 of its
             proposals (full accepts and bonus tokens); whether
             bf16 projections give the same bits at M = B and 4B rows; and
             a seeded stochastic run (temperature 0.8, seed 17) twice on
             fresh engines, which must give the same tokens.
8. moe     — granite-moe-1b-a400m at full width (random weights from a
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
9. ssm     — mamba2-130m at full width (random weights from a seed;
             granite freed first) on the engine's state-cache plane, bf16:
             the serve trace on a ``prefill_chunk=0`` engine (24 chunk-scan
             launches per admission) and on a ``prefill_chunk=8`` engine
             (the fused recurrent step, no launch), each timed and with a
             profiled wave, and a profiled step that admits two requests on
             the first (the chunk scan's device time per admission); a
             ``warm_session`` (24 launches) and
             ``export_session`` -> ``import_session`` onto the other
             engine.  Then prefill and ``decode_step`` logits of two
             prompts, card bf16 and float32 against the CPU in float32;
             float32 prefill (the scan) against ``decode_chunk`` over the
             same prompt (the recurrence); and the fused step against the
             per-token masked step in float32 (the same greedy tokens).
10. hybrid — recurrentgemma-9b at full width (random weights from a seed;
             mamba2 freed first; 38 layers, 26 RG-LRU and 12 local
             attention, head_dim 256, window 2048) on the state-cache
             plane.  First its kernels at its widths: the RG-LRU scan
             (bitwise against its plain version), the flash kernel at head
             dim 256 and the ring kernel at one kv head of 16 queries, D =
             256, over wrapped rings.  Then the serve trace in bf16 on a
             ``prefill_chunk=0`` engine (26 scan and 12 flash launches per
             admission) and a ``prefill_chunk=8`` one (neither), 12 ring
             launches per single step on both, a profiled wave and a
             profiled step that admits two requests on the first (the scan's
             and the flash kernel's device time per admission); a
             ``warm_session`` and a session moved between the engines.
             Then the five-layer cut (one group and the two tail layers)
             against the CPU (card float32 within 1e-3, card bf16 within the
             logits bound with a CPU bf16 witness, float32 prefill against
             the recurrence, and 2100 tokens past the window over the
             wrapped ring); the full depth past the window (two prompts of
             2300 tokens, 32 decode_steps) in bf16 against float32 on the
             card; and the fused, masked and monolithic engines' float32
             tokens on the cut.
11. variants — the five other architectures at full width (random
             weights from seed 0, bf16; recurrentgemma freed first), one
             after the other, each freed before the next: qwen3-1.7b,
             stablelm-1.6b (layer norm, a quarter of head dim 64 rotated),
             starcoder2-15b (layer norm, gelu, 48 query heads over 4 kv
             heads, window 4096), phi-3-vision-4.2b (576 image tokens
             before the text, head dim 96) and whisper-medium (encoder-
             decoder, 1500 frames).  First the shapes they give the
             kernels: B1 at head dims 64 and 96 with n_rep 1 and at n_rep
             12, B2 at head dims 96 (576 + 256 positions) and 64, B4 at
             head dim 64 with n_rep 1 and at n_rep 12, each held against
             its plain version (and bitwise across batch, chunk or length)
             and timed with its bound and the library call.  Then for each
             arch a trace of 8 requests of 16 tokens (two sessions with a
             second turn, prompts of 64..256; phi-3: half of them with an
             image; whisper: every one with frames) on the paged plane,
             ``max_seq`` 1024, pages of 64, ``prefill_chunk`` 8 (whisper
             also at ``prefill_chunk=0`` and on the dense plane, its second
             turns refused and counted in ``resume_unsupported``), B1 held
             to a launch a layer per paged step and B2 per prefill; then
             next-token logits of two prompts through prefill, a paged step
             and ``decode_step`` (B4, a launch a layer): card bf16 against
             card float32 at full depth (starcoder2: its first 8 layers)
             within 5e-2 relative L2, argmax equal unless tied, and card
             float32 against the CPU on the first 8 layers within 1e-3.

The last lines are the kernel table as JSON, the card's name and power
limit (``nvidia-smi``), and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
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

    def host_us(self, fn, batches: int = 4, per_batch: int = 25) -> float:
        """Median host microseconds of one call of ``fn`` (a wrapper's own
        cost): the calls are queued behind a 20 ms spin, so none waits on
        the card."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        us = []
        for _ in range(batches):
            torch.cuda._sleep(int(20 * self.cycles_per_ms))
            for _ in range(per_batch):
                t0 = time.perf_counter()
                fn()
                us.append((time.perf_counter() - t0) * 1e6)
            torch.cuda.synchronize()
        return float(np.median(us))


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
# ptxas's report (-Xptxas -v) of every kernel built in this run, by mangled
# name: {"regs": registers a thread, "spill": (store bytes, load bytes)}
PTXAS = {}


def ptxas_usage(log):
    usage, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            usage[fn] = {}
        elif fn is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                usage[fn]["spill"] = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                usage[fn]["regs"] = int(m.group(1))
    return usage


def ptxas_tag(*symbols):
    """Registers and spills of the built kernels whose mangled names hold
    each of ``symbols``."""
    tags = []
    for sym in symbols:
        for name, u in PTXAS.items():
            if sym in name:
                st, ld = u.get("spill", ("?", "?"))
                tags.append(f"{sym}: {u.get('regs', '?')} registers, "
                            f"spill {st}/{ld} bytes")
    return "; ".join(tags) or "ptxas: not built in this run"


def flash_design(D):
    """The bf16 flash kernel's tiles at head dim D (flash_attention.cu)."""
    dmax = next(w for w in (64, 128, 256) if D <= w)
    where = "registers" if dmax <= 128 else "shared memory"
    keys = 64 if dmax <= 128 else 32
    return (f"design=mma.sync m16n8k16 bf16, 64 q-rows x {keys} keys, "
            f"d-tile {dmax}, Q in {where}, 2-stage cp.async "
            f"[{ptxas_tag(f'flash_tc_kernelILi{dmax}E')}]")


MOE_DESIGN = ("design=mma.sync m16n8k16 bf16, gate/up 64x64 tiles, down "
              "64x128 tiles over all F with h split hi+lo, k-chunks of 64 "
              "in 3 cp.async stages")
SSD_DESIGN = ("design=chunk-parallel, 4 launches: C.B^T once per (b, chunk) "
              "in 64x64 tiles; chunk states per (b, chunk, head); the state "
              "pass over chunks; y per (b, chunk, head, 64 rows); ")
SSD_PRODUCTS = {"bfloat16": "mma.sync m16n8k16 bf16 with the f32 operands "
                            "(w x, S_in, the decayed scores) split hi+lo",
                "float32": "fmaf chains on the CUDA cores"}
RGLRU_DESIGN = ("design=one warp of 32 channels a block, 32-step tiles of a "
                "and b in 4 cp.async stages, __fmul_rn/__fadd_rn in order, y "
                "staged in shared memory and written as 16-byte rows")


def ssd_design(name):
    """The chunk scan's design and each launch's registers and spills."""
    t = "I13__nv_bfloat16" if name == "bfloat16" else "IfE"
    usage = ptxas_tag(f"ssd_cb_kernel{t}", f"ssd_state_kernel{t}",
                      f"ssd_pass_kernel{t}", f"ssd_out_kernel{t}")
    return f"{SSD_DESIGN}{SSD_PRODUCTS[name]} [{usage}]"


def phase_build(_build):
    t0 = time.perf_counter()
    built = _build.build_all()
    wall = time.perf_counter() - t0
    for name, (secs, log) in built.items():
        print(f"[build] {name}: {secs:.1f} s")
        PTXAS.update(ptxas_usage(log))
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    print(f"[build] wall {wall:.1f} s for {sorted(built)} "
          f"(already built: {sorted(set(_build.SOURCES) - set(built))})")


def phase_kernels(torch, timer, paged_ops, paged_ref, flash_ops, flash_ref,
                  moe_ops, moe_ref, ssd_ops, ssd_ref, cfg, moe_cfg, ssm_cfg,
                  decode_batch, decode_ctx):
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    rows = {}
    rows["paged_decode_chunk"] = paged_chunk_rows(torch, timer, paged_ops,
                                                  paged_ref, H, Hkv, D)
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


# the merge's warp-a-row launch (bf16), in ptxas's mangled name
MERGE_ROWS = "24merge_splits_rows_kernelI13__nv_bfloat16E"
# the paged chunk kernel's split launches (bf16, f32) and the merge's
# launches, in ptxas's mangled names
PAGED_SYMBOLS = ("18paged_split_kernelI13__nv_bfloat16E",
                 "18paged_split_kernelIfE",
                 "19merge_splits_kernelI13__nv_bfloat16Li",
                 MERGE_ROWS)
PAGED_DESIGN = ("design=split-KV, fixed splits of {S} table positions, grid "
                "(splits, Hkv, B) = {blocks} blocks ({live} with a visible "
                "token) + the shared merge; bf16 mma.sync m16n8k16, {R} rows "
                "in m-tiles of 16, P as bf16 hi + lo")


# ---------------------------------------------- wrapper A/B of two trees
_PORTS = {}  # a port's directory -> the name it was imported under


def load_port(src):
    """The name of the package the port under the directory ``src``
    (``src`` of a checkout) is imported as, ``port_ab<i>``, imported the
    first time.  The port's own imports are relative, so two trees import
    side by side in one process, nothing imported before is touched, and
    each tree builds its kernels into its own ``build/``."""
    pkg = Path(src).resolve() / "repro_torch"
    name = _PORTS.get(pkg)
    if name is None:
        name = _PORTS[pkg] = f"port_ab{len(_PORTS)}"
        spec = importlib.util.spec_from_file_location(
            name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        port = importlib.util.module_from_spec(spec)
        sys.modules[name] = port
        spec.loader.exec_module(port)
    return name


def ab_cases(torch, kernel):
    """The wrapper of ``kernel`` (its path in the port) and {label: (args,
    kwargs)} of the shapes :func:`wrapper_ab` times it at, bf16: the paged
    chunk kernel at phase 2's timed shapes (B=8, D=128, pages of 64,
    contexts 32..544: qwen3-0.6b's T=8 and T=1, and qwen3-moe-235b's 4 kv
    heads of 16 queries at T=8 and 16, 128 and 256 rows); the one-token
    paged decode at :func:`paged_decode_rows`' serve, long and 32768
    shapes (B=8, lengths 264..319; one sequence of 8192 and one of 32768
    tokens) and at one sequence of 2048 and of 4096 tokens (16 and 32
    splits of 16 rows); the ring kernel
    at qwen3-0.6b's ``decode_step`` (B=8, C=1024, positions 256..319) and
    recurrentgemma-9b's wrapped ring (B=8, C=2048, one kv head of 16, D=256,
    window 2048); the SSD chunk scan at mamba2-130m's admission (B=1,
    S=512, H=24, P=64, N=128, chunk 256)."""
    g = torch.Generator(device="cuda").manual_seed(28)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    if kernel == "paged_decode_chunk":
        cases = {}
        for label, seed, T, H, Hkv in (("T=8", 108, 8, 16, 8),
                                       ("T=1", 101, 1, 16, 8),
                                       ("R=128", 112, 8, 64, 4),
                                       ("R=256", 116, 16, 64, 4)):
            args = paged_inputs(torch, seed, 8, T, H, Hkv, 128, 64, 272, 16,
                                (32, 544))
            cases[label] = args, dict(scale=128 ** -0.5, n_rep=H // Hkv)
        return "kernels.paged_attention.ops.paged_decode_chunk", cases
    if kernel == "paged_decode":
        cases = {}
        for label, B, maxp, n_pages, (lo, hi) in (
                ("serve", 8, 16, 272, (264, 320)),
                ("long", 1, 128, 130, (8192, 8193)),
                ("32768", 1, 512, 514, (32768, 32769)),
                ("B=1 2048", 1, 32, 34, (2048, 2049)),
                ("B=1 4096", 1, 64, 66, (4096, 4097))):
            q4, kp, vp, pt, pos = paged_inputs(
                torch, 200 + B + lo, B, 1, 16, 8, 128, 64, n_pages, maxp,
                (lo - 1, hi - 1))
            cases[label] = ((q4[:, 0].contiguous(), kp, vp, pt, pos + 1),
                            dict(scale=128 ** -0.5, n_rep=2))
        return "kernels.paged_attention.ops.paged_decode", cases
    if kernel == "decode_ring":
        cases = {}
        for label, C, Hkv, D, window, lo, hi in (
                ("qwen3 decode", 1024, 8, 128, None, 256, 320),
                ("rg C=2048", 2048, 1, 256, 2048, 2048, 4096)):
            pos = torch.randint(lo, hi, (8,), generator=g, device="cuda",
                                dtype=torch.int32)
            args = (randn(8, 1, 16, D), randn(8, C, Hkv, D),
                    randn(8, C, Hkv, D), pos)
            cases[label] = args, dict(window=window, scale=D ** -0.5,
                                      n_rep=16 // Hkv)
        return "kernels.paged_attention.ops.decode_attention_kernel", cases
    if kernel == "ssd_chunk_scan":
        B, S, H, P, N = 1, 512, 24, 64, 128
        dt = torch.nn.functional.softplus(randn(B, S, H).float())
        A = torch.linspace(1.0, 16.0, H, device="cuda")
        args = (randn(B, S, H, P), dt, A, randn(B, S, N), randn(B, S, N))
        return ("kernels.ssd.ops.ssd_chunk_scan",
                {"B=1 S=512": (args, dict(chunk=256))})
    raise ValueError(f"no A/B shapes for {kernel}")


def wrapper_ab(torch, timer, srcs, kernel, rounds=4):
    """The device time (``Timer.ms``) of ``kernel`` and its wrapper's host
    microseconds per call (``Timer.host_us``) at the shapes of
    :func:`ab_cases`, for the ports under ``srcs`` = [A, B] (each loaded by
    :func:`load_port`) in one process, on the same inputs, timed in the
    order A, B, B, A ``rounds`` times, so that like runs pair and the
    host's speed, which differs between processes, is the same for both.
    For two trees unpacked beside each other with ``git archive``, from the
    root of the checkout that holds this script:

        python3 -c "import torch, chip_smoke as c; c.wrapper_ab(torch, \\
            c.Timer(torch), ['PARENT/src', 'src'], 'paged_decode_chunk')"

    A shape that either tree's wrapper refuses is named and not timed.
    Prints every reading and each tree's medians; returns the medians by
    (src, label, "ms" or "host_us")."""
    path, cases = ab_cases(torch, kernel)
    module, name = path.rsplit(".", 1)
    wrappers = {src: getattr(importlib.import_module(
        f"{load_port(src)}.{module}"), name) for src in srcs}
    for label, (args, kw) in list(cases.items()):
        for src in srcs:
            try:
                wrappers[src](*args, **kw)
            except ValueError as e:  # a shape one tree's wrapper refuses
                print(f"[ab] {kernel} {src} {label}: refused ({e}); not "
                      f"timed")
                del cases[label]
                break
    got = {(src, label, what): [] for src in srcs for label in cases
           for what in ("ms", "host_us")}
    for _ in range(rounds):
        for src in srcs + srcs[::-1]:
            for label, (args, kw) in cases.items():
                def call():
                    return wrappers[src](*args, **kw)
                got[src, label, "ms"].append(timer.ms(call))
                got[src, label, "host_us"].append(timer.host_us(call))
    for (src, label, what), xs in got.items():
        print(f"[ab] {kernel} {src} {label} {what}: median "
              f"{np.median(xs):.4f} of {' '.join(f'{x:.4f}' for x in xs)}")
    return {key: float(np.median(xs)) for key, xs in got.items()}


def paged_chunk_rows(torch, timer, paged_ops, paged_ref, H, Hkv, D):
    """The paged chunk kernel (``paged_decode_chunk``, B1) at qwen3-0.6b's
    serving shapes (B=8, pages of 64, tables of 16 entries from the
    engine's default pool of 272 pages): held against its plain version in
    bf16 at T in {1, 3, 8}; past the old 128-row cap, R = T * n_rep = 144
    (one kv head of 16 queries, T=9) and 256 (qwen3-moe-235b's 4 kv heads
    of 16 queries, T=16), in bf16 and float32; every row of the T=8 and
    R=256 launches bitwise against a B=1 launch of its sequence and a T=1
    launch of its q row at pos + t, in both types; the same at T=8 over
    tables of 48 entries (contexts 1024..3071: 24 splits a row in bf16,
    so the merge's warp-a-row kernel sums splits 16..23 in its second
    stage; 48 splits in float32, the sliced merge).  Timed (bf16) at T=8
    (the row in the JSON line), T=1 and R=256, beside the plain version
    and gather + SDPA, with the wrapper's host time per call.  Returns the
    JSON row."""
    n_rep, P, maxp, n_pages, B = H // Hkv, 64, 16, 272, 8
    scale = D ** -0.5
    err = 0.0
    for T in (1, 3, 8):
        q, kp, vp, pt, pos = paged_inputs(torch, T, B, T, H, Hkv, D, P,
                                          n_pages, maxp, (0, 1024 - T))
        got = paged_ops.paged_decode_chunk(q, kp, vp, pt, pos, scale=scale,
                                           n_rep=n_rep)
        torch.cuda.synchronize()
        want = paged_ref.paged_decode_chunk_ref(q, kp, vp, pt, pos,
                                                scale=scale, n_rep=n_rep)
        e = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), **KERNEL_TOL)
        print(f"[kernels] paged_decode_chunk T={T} B={B} "
              f"max_abs_err={e:.3e} tol={KERNEL_TOL} ok={ok}")
        check(ok and bool(torch.isfinite(got).all()),
              f"paged_decode_chunk disagrees with its plain version (T={T})")
        err = max(err, e)

    # label: (seed, T, H, Hkv), contexts of the served prompts (32..512 +
    # 32 new tokens): a chunked-prefill step (T=8), a decode step (T=1),
    # and two shapes past the old cap
    shapes = {"T=8": (108, 8, H, Hkv), "T=1": (101, 1, H, Hkv),
              "R=144": (109, 9, 16, 1), "R=256": (116, 16, 64, 4)}
    inputs = {label: paged_inputs(torch, seed, B, T, h, hkv, D, P, n_pages,
                                  maxp, (32, 544))
              for label, (seed, T, h, hkv) in shapes.items()}
    shapes["splits=24"] = (124, 8, H, Hkv)
    inputs["splits=24"] = paged_inputs(torch, 124, B, 8, H, Hkv, D, P,
                                       B * 48, 48, (1024, 3064))
    for label in ("T=8", "R=144", "R=256", "splits=24"):
        _, T, h, hkv = shapes[label]
        q, kp, vp, pt, pos = inputs[label]
        kw = dict(scale=scale, n_rep=h // hkv)
        for dt, tol in ((torch.bfloat16, KERNEL_TOL),
                        (torch.float32, dict(rtol=1e-5, atol=1e-5))):
            qd, kd, vd = (x.to(dt) for x in (q, kp, vp))
            got = paged_ops.paged_decode_chunk(qd, kd, vd, pt, pos, **kw)
            want = paged_ref.paged_decode_chunk_ref(qd, kd, vd, pt, pos, **kw)
            same_b = same_t = None
            if label != "R=144":
                same_b = all(torch.equal(paged_ops.paged_decode_chunk(
                    qd[b:b + 1], kd, vd, pt[b:b + 1].contiguous(),
                    pos[b:b + 1], **kw), got[b:b + 1]) for b in range(B))
                same_t = all(torch.equal(paged_ops.paged_decode_chunk(
                    qd[:, t:t + 1].contiguous(), kd, vd, pt, pos + t, **kw),
                    got[:, t:t + 1]) for t in range(T))
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), **tol)
            name = "bf16" if dt == torch.bfloat16 else "f32"
            print(f"[kernels] paged_decode_chunk {name} B={B} T={T} H={h} "
                  f"Hkv={hkv} R={T * h // hkv} splits="
                  f"{paged_ops.paged_splits(pt.shape[1], P, dt)} "
                  f"max_abs_err={e:.3e} "
                  f"tol={tol} ok={ok}; rows bitwise equal to B=1 launches: "
                  f"{same_b}, to T=1 launches at pos + t: {same_t}")
            check(ok and same_b is not False and same_t is not False
                  and bool(torch.isfinite(got).all()),
                  f"paged_decode_chunk {name} {label} disagrees with its "
                  f"plain version or its rows depend on the batch or chunk")
            if dt == torch.bfloat16:
                err = max(err, e)

    timings = {}
    for label in ("T=8", "T=1", "R=256"):
        _, T, h, hkv = shapes[label]
        q, kp, vp, pt, pos = inputs[label]
        kw = dict(scale=scale, n_rep=h // hkv)
        n_bytes, flops = paged_cost(pt, pos, T, h, hkv, D, P)
        bound, by = bound_ms(n_bytes, flops)
        library = gather_sdpa(torch, q, kp, vp, pt, pos, scale)

        def kernel():
            return paged_ops.paged_decode_chunk(q, kp, vp, pt, pos, **kw)
        t = {"ms": timer.ms(kernel),
             "plain_ms": timer.ms(lambda: paged_ref.paged_decode_chunk_ref(
                 q, kp, vp, pt, pos, **kw)),
             "library_ms": timer.ms(library),
             "bound_ms": bound, "bound_by": by}
        timings[label] = t
        host = timer.host_us(kernel)
        S = paged_ops.SPLIT[q.dtype]
        n_splits = paged_ops.paged_splits(maxp, P, q.dtype)
        end = (pos + T).tolist()
        table = pt.tolist()
        live = hkv * sum(any(table[b][e] >= 0
                             for e in range(s * S // P, (s + 1) * S // P)
                             if e * P < end[b])
                         for b in range(B) for s in range(n_splits))
        design = PAGED_DESIGN.format(S=S, blocks=B * hkv * n_splits,
                                     live=live, R=T * h // hkv)
        print(f"[kernels] paged_decode_chunk timed B={B} T={T} H={h} "
              f"Hkv={hkv} D={D} P={P} ctx={pos.min().item()}.."
              f"{pos.max().item()}: ms={t['ms']:.4f} plain_ms="
              f"{t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
              f"(gather + SDPA) bound_ms={bound:.5f} ({by}; {n_bytes} B, "
              f"{flops} flop); wrapper host us per call {host:.1f} (queued "
              f"behind a spin) {design} [{ptxas_tag(*PAGED_SYMBOLS)}]")
    return dict(source="src/repro_torch/csrc/paged_chunk.cu",
                replaces="src/repro/kernels/paged_attention/"
                         "paged_attention.py:260",
                max_abs_err=err, **timings["T=8"])


def paged_decode_rows(torch, timer, paged_ops, paged_ref, H, Hkv, D):
    """The one-token split-KV paged decode (B3) at qwen3-0.6b's shapes
    (pages of 64): B=8 at contexts 264..319 (the row in the JSON line) and
    975..1020 over tables from the engine's default pool of 272 pages, one
    8192-token sequence (64 splits of 128 tokens in bf16) and one of 32768
    tokens (a pool of 514 pages; 256 splits a row for the merge).  Each is
    held against its plain version (bf16), and in bf16 and float32 bitwise
    against the paged chunk kernel at T=1 with pos = lengths - 1 (the same
    function through the same table walk, split block and merge) and its
    rows bitwise against B=1 launches.  Timed (bf16) beside the plain
    version, B1 at T=1 and gather + SDPA, with the wrapper's host time per
    call.  The bound counts q in, the output, the table and lengths, and
    the K and V of every visible token once; 4*D flops per (query head,
    visible token)."""
    n_rep, P = H // Hkv, 64
    scale = D ** -0.5
    kw = dict(scale=scale, n_rep=n_rep)
    err, timed = 0.0, {}
    for label, B, maxp, n_pages, (lo, hi) in (
            ("serve", 8, 16, 272, (264, 320)),
            ("full", 8, 16, 272, (975, 1021)),
            ("long", 1, 128, 130, (8192, 8193)),
            ("32768", 1, 512, 514, (32768, 32769))):
        q4, kp, vp, pt, pos = paged_inputs(torch, 200 + B + lo, B, 1, H,
                                           Hkv, D, P, n_pages, maxp,
                                           (lo - 1, hi - 1))
        q, lengths = q4[:, 0].contiguous(), pos + 1
        got = paged_ops.paged_decode(q, kp, vp, pt, lengths, **kw)
        torch.cuda.synchronize()
        want = paged_ref.paged_decode_ref(q, kp, vp, pt, lengths, **kw)
        e = (got.float() - want.float()).abs().max().item()
        ok = (torch.allclose(got.float(), want.float(), **KERNEL_TOL)
              and bool(torch.isfinite(got).all()))
        same = {}
        for dt in (torch.bfloat16, torch.float32):
            qd, kd, vd = (x.to(dt) for x in (q, kp, vp))
            mine = got if dt == torch.bfloat16 else paged_ops.paged_decode(
                qd, kd, vd, pt, lengths, **kw)
            b1 = paged_ops.paged_decode_chunk(qd[:, None].contiguous(), kd,
                                              vd, pt, pos, **kw)[:, 0]
            alone = all(torch.equal(paged_ops.paged_decode(
                qd[b:b + 1], kd, vd, pt[b:b + 1].contiguous(),
                lengths[b:b + 1], **kw), mine[b:b + 1]) for b in range(B))
            torch.cuda.synchronize()
            same[dt] = (torch.equal(mine, b1), alone)
        print(f"[kernels] paged_decode {label} B={B} len={lo}..{hi - 1} "
              f"({paged_ops.paged_splits(maxp, P, q.dtype)} splits of "
              f"{paged_ops.SPLIT[q.dtype]} tokens per (b, kv head)): "
              f"max_abs_err={e:.3e} vs plain, tol={KERNEL_TOL} ok={ok}; "
              f"bitwise equal to paged_decode_chunk T=1 and rows to B=1 "
              f"launches: bf16 {same[torch.bfloat16]}, f32 "
              f"{same[torch.float32]}")
        check(ok and all(all(v) for v in same.values()),
              f"paged_decode disagrees with its plain version, or differs "
              f"from the paged chunk kernel at T=1 or from B=1 launches "
              f"({label})")
        err = max(err, e)
        n_bytes, flops = paged_cost(pt, pos, 1, H, Hkv, D, P)
        bound, by = bound_ms(n_bytes, flops)
        library = gather_sdpa(torch, q4, kp, vp, pt, pos, scale)

        def kernel():
            return paged_ops.paged_decode(q, kp, vp, pt, lengths, **kw)
        t = {"ms": timer.ms(kernel),
             "plain_ms": timer.ms(lambda: paged_ref.paged_decode_ref(
                 q, kp, vp, pt, lengths, **kw)),
             "library_ms": timer.ms(library),
             "bound_ms": bound, "bound_by": by}
        b1_ms = timer.ms(lambda: paged_ops.paged_decode_chunk(
            q4, kp, vp, pt, pos, **kw))
        host = timer.host_us(kernel)
        timed[label] = t
        print(f"[kernels] paged_decode timed {label} B={B} H={H} Hkv={Hkv} "
              f"D={D} P={P}: ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
              f"library_ms={t['library_ms']:.4f} (gather + SDPA) "
              f"paged_decode_chunk_T1_ms={b1_ms:.4f} bound_ms={bound:.5f} "
              f"({by}; {n_bytes} B, {flops} flop); wrapper host us per "
              f"call {host:.1f} (queued behind a spin) "
              f"[{ptxas_tag(*PAGED_SYMBOLS)}]")
    return dict(source="src/repro_torch/csrc/paged_chunk.cu",
                replaces="src/repro/kernels/paged_attention/"
                         "paged_attention.py:166",
                max_abs_err=err, **timed["serve"])


def flash_rows(torch, timer, flash_ops, flash_ref, tag, H, D, seed,
               cases):
    """The flash kernel at BH=H, head dim D, bf16, causal: at each (S,
    window, timed) of ``cases`` held against its plain version, and where
    ``timed`` timed beside it and SDPA (``is_causal`` without a window, a
    boolean mask with one), and its first 300 rows held bitwise equal to
    an S=300 launch over the first 300 positions (a row's output does not
    depend on the sequence's length).  Returns the largest difference and
    the timings by (S, window)."""
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
        head = flash_ops.flash_attention_bhsd(
            *(x[:, :300].contiguous() for x in (q, k, v)), causal=True,
            window=window, scale=scale)
        check(torch.equal(head, got[:, :300]),
              f"flash_attention_bhsd rows 0..299 of the S={S} launch differ "
              f"from an S=300 launch (window={window}, D={D})")
        print(f"[{tag}] flash_attention_bhsd S={S} window={window} D={D}: "
              f"rows 0..299 equal, bitwise, an S=300 launch")
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
              f"bound_ms={bound:.5f} ({by}; {n_bytes} B, {flops} flop) "
              f"{flash_design(D)}")
    return err, timings


# the ring kernel's split launches (bf16, f32) and the merge's, in ptxas's
# mangled names
RING_SYMBOLS = ("17ring_split_kernelI13__nv_bfloat16E",
                "17ring_split_kernelIfE",
                "19merge_splits_kernelI13__nv_bfloat16Li",
                MERGE_ROWS)
RING_DESIGN = ("design=split-KV, fixed splits of {S} slots, grid (splits, "
               "Hkv, B) = {blocks} blocks ({live} with a visible slot) + "
               "the shared merge; bf16 mma.sync m16n8k16, n_rep rows in "
               "m-tiles of 16, P as bf16 hi + lo")


def ring_rows(torch, timer, paged_ops, paged_ref, tag, H, Hkv, D, seed,
              cases):
    """The ring kernel (``decode_attention_kernel``) on q [B,1,H,D] and
    caches [B,C,Hkv,D]: at each (label, C, window, pos) of ``cases`` held
    against its plain version in bf16 and in float32, and each row of the
    launch bitwise against a B=1 launch of that row in both; where
    ``label`` is not None timed (bf16) beside the plain version and SDPA
    with a boolean mask over the GQA-repeated cache, with the wrapper's host
    time per call.  Returns the largest bf16 difference and the timings by
    label."""
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(seed)
    n_rep, scale = H // Hkv, D ** -0.5
    err, timings = 0.0, {}
    for label, C, window, pos in cases:
        B = len(pos)
        q32 = torch.randn((B, 1, H, D), generator=g, device="cuda")
        ck32, cv32 = (torch.randn((B, C, Hkv, D), generator=g, device="cuda")
                      for _ in range(2))
        pos_t = torch.from_numpy(pos.astype(np.int32)).cuda()
        kw = dict(window=window, scale=scale, n_rep=n_rep)
        wrapped = " (wrapped)" if int(pos.min()) >= C else ""
        for dt, tol in ((torch.bfloat16, KERNEL_TOL),
                        (torch.float32, dict(rtol=1e-5, atol=1e-5))):
            q, ck, cv = (x.to(dt) for x in (q32, ck32, cv32))
            got = paged_ops.decode_attention_kernel(q, ck, cv, pos_t, **kw)
            rows_same = all(torch.equal(
                paged_ops.decode_attention_kernel(
                    q[b:b + 1], ck[b:b + 1], cv[b:b + 1], pos_t[b:b + 1],
                    **kw), got[b:b + 1]) for b in range(B))
            torch.cuda.synchronize()
            want = paged_ref.decode_ring_ref(q, ck, cv, pos_t, scale=scale,
                                             n_rep=n_rep, window=window)
            e = (got.float() - want.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), **tol)
            name = "bf16" if dt == torch.bfloat16 else "f32"
            print(f"[{tag}] decode_ring {name} B={B} C={C} H={H} Hkv={Hkv} "
                  f"D={D} window={window} pos={pos.min()}..{pos.max()}"
                  f"{wrapped} max_abs_err={e:.3e} tol={tol} ok={ok}; rows "
                  f"bitwise equal to B=1 launches: {rows_same}")
            check(ok and rows_same and bool(torch.isfinite(got).all()),
                  f"decode_ring {name} disagrees with its plain version or "
                  f"its rows depend on the batch (C={C}, window={window}, "
                  f"D={D})")
            if dt == torch.bfloat16:
                err = max(err, e)
        if label is None:
            continue
        q, ck, cv = (x.to(torch.bfloat16) for x in (q32, ck32, cv32))
        visible = paged_ref.ring_visible(pos_t, C, window)
        n_bytes, flops = ring_cost(visible, H, Hkv, D)
        bound, by = bound_ms(n_bytes, flops)
        mask = visible[:, None, None, :]

        def library():
            kr = ck.repeat_interleave(n_rep, dim=2).transpose(1, 2)
            vr = cv.repeat_interleave(n_rep, dim=2).transpose(1, 2)
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), kr, vr, attn_mask=mask, scale=scale)

        def kernel():
            return paged_ops.decode_attention_kernel(q, ck, cv, pos_t, **kw)

        t = {"ms": timer.ms(kernel),
             "plain_ms": timer.ms(lambda: paged_ref.decode_ring_ref(
                 q, ck, cv, pos_t, scale=scale, n_rep=n_rep, window=window)),
             "library_ms": timer.ms(library),
             "bound_ms": bound, "bound_by": by}
        timings[label] = t
        host = timer.host_us(kernel)
        S = paged_ops.SPLIT[q.dtype]
        n_splits = paged_ops.ring_splits(C, q.dtype)
        vis = visible.cpu()
        live = Hkv * sum(bool(vis[b, s * S:(s + 1) * S].any())
                         for b in range(B) for s in range(n_splits))
        design = RING_DESIGN.format(S=S, blocks=B * Hkv * n_splits,
                                    live=live)
        print(f"[{tag}] decode_ring timed ({label}) B={B} C={C} H={H} "
              f"Hkv={Hkv} D={D} window={window}: ms={t['ms']:.4f} plain_ms="
              f"{t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
              f"(repeat + SDPA) bound_ms={bound:.5f} ({by}; {n_bytes} B, "
              f"{flops} flop); wrapper host us per call {host:.1f} (queued "
              f"behind a spin) {design} [{ptxas_tag(*RING_SYMBOLS)}]")
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
        usage = ptxas_tag("moe_gate_up_kernel", "moe_down_kernel")
        print(f"[kernels] moe_ffn timed E={E} C={C} D={D} F={Fe} (token "
              f"block expanded): ms={t['ms']:.4f} plain_ms="
              f"{t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
              f"bound_ms={bound:.5f} ({by}; {n_bytes} B, {flops} flop) "
              f"{MOE_DESIGN} [{usage}]")
    return dict(source="src/repro_torch/csrc/moe_ffn.cu",
                replaces="src/repro/kernels/moe_ffn/moe_ffn.py:50",
                max_abs_err=err, **timings[64])


def ssd_cost(B, S, H, P, N, Q, itemsize=2):
    """Bytes and flops of one chunk scan (x, B, C and y of ``itemsize``
    bytes; f32 dt, A and final state): each input read once, each output
    written once; per (b, h, chunk of Qc steps) the lower triangle of C.B^T
    over N and of the decayed scores times dt.x over P, Qc(Qc+1)/2 (N + P)
    multiply-adds, and C.S and the state update, 2 Qc N P."""
    n_bytes = (2 * itemsize * B * S * H * P + 4 * B * S * H + 4 * H
               + 2 * itemsize * B * S * N + 4 * B * H * P * N)
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
    plain version and the token-by-token recurrence.  Every row of the B=8
    launch (and of the B=2 one) equals, bitwise, the same row launched at
    B=1.  Timed in bf16 at the three shapes, and in float32 at B=1, S=512
    (the precision witness: printed, no bar)."""
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
        if B > 1:
            x, dt, _, Bm, Cm = args
            for b in range(B):
                yb, fb = ssd_ops.ssd_chunk_scan(
                    x[b:b + 1], dt[b:b + 1], A, Bm[b:b + 1], Cm[b:b + 1],
                    chunk=Q, init_state=None if h0 is None else h0[b:b + 1])
                check(torch.equal(yb, y[b:b + 1])
                      and torch.equal(fb, final[b:b + 1]),
                      f"ssd_chunk_scan row {b} of the B={B}, S={S} {name} "
                      f"launch differs from the same row launched alone")
            print(f"[kernels] ssd_chunk_scan: the {B} rows of the B={B}, "
                  f"S={S} {name} launch equal, bitwise, the same rows "
                  f"launched at B=1 (y and the final state)")
        if dtype == torch.bfloat16 or (B, S) == (1, 512):
            n_bytes, flops = ssd_cost(B, S, H, P, N, Q, dtype.itemsize)
            bound, by = bound_ms(n_bytes, flops, BF16_FLOP_PER_S
                                 if dtype == torch.bfloat16
                                 else F32_FLOP_PER_S)
            t = {"ms": timer.ms(lambda: ssd_ops.ssd_chunk_scan(
                     *args, chunk=Q)),
                 "plain_ms": timer.ms(lambda: ssd_ref.ssd_chunked_ref(
                     *args, Q)),
                 "library_ms": None, "bound_ms": bound, "bound_by": by}
            if dtype == torch.bfloat16:
                err = max(err, e)
                timed[B, S] = t
            print(f"[kernels] ssd_chunk_scan timed B={B} S={S} {name}: ms="
                  f"{t['ms']:.4f} plain_ms={t['plain_ms']:.4f} library_ms="
                  f"none (no PyTorch call computes the scan) bound_ms="
                  f"{bound:.5f} ({by}; {n_bytes} B, {flops} flop)"
                  f"{'' if dtype == torch.bfloat16 else ' (no bar)'} "
                  f"{ssd_design(name)}")
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


def run_trace(engine, vocab, Request, sampling, waves=None):
    """Serve ``waves`` (both waves of :func:`serve_trace` by default), each
    until the engine is idle.  Returns (requests, per-step host ms, wall
    seconds); every step ends with the greedy tokens copied to the host,
    which synchronises."""
    reqs, step_ms = [], []
    t0 = time.perf_counter()
    for wave in waves or serve_trace(vocab):
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
                   n_steps=10, names=()):
    """A third wave of 8 fresh requests; ``n_steps`` engine steps of it run
    under ``torch.profiler``: the device's busy share of the window, the
    kernels that fill it, and the device time and launches of the kernels
    whose names hold one of ``names``."""
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
    for name in names:
        hit = [e for e in kernels if name in e.key]
        ms = sum(e.self_device_time_total for e in hit) / 1e3
        print(f"[profile] {name}: {ms:.3f} ms over "
              f"{sum(e.count for e in hit)} launches in the {n_steps} steps")


def admission_window(torch, engine, cfg, Request, sampling, tag, kernels):
    """Two fresh requests (prompts of 300 and 450 tokens, bucket 512) on
    the idle ``prefill_chunk=0`` engine: the step that admits them, a
    monolithic prefill each, runs under ``torch.profiler``.  Prints the
    step's host wall and device time and, per admission, the device time
    and launches of the kernels whose names hold one of ``kernels``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(5)
    reqs = [Request.make(rng.integers(0, cfg.vocab_size, n),
                         session_id=f"admit{i}", sampling=sampling)
            for i, n in enumerate((300, 450))]
    engine.run_until_idle()
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    engine.run_until_idle()
    check(all(r.finished and r.prefix_reused_tokens == 0 for r in reqs),
          f"{tag}: an admission-window request did not finish cold")
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    if not events:
        print(f"[{tag}] admission window: the trace holds no device events: "
              f"not measured")
        return
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    mine = [e for e in events if any(k in e.key for k in kernels)]
    n = len(reqs)
    scan_ms = sum(e.self_device_time_total for e in mine) / 1e3
    print(f"[{tag}] admission window: one step admitting {n} requests "
          f"(bucket 512, a monolithic prefill each) in {wall_ms:.1f} ms host "
          f"wall, device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}"
          f" %); {'/'.join(kernels)} kernels {scan_ms / n:.3f} ms and "
          f"{sum(e.count for e in mine) / n:.0f} launches per admission")
    for e in sorted(mine, key=lambda e: -e.self_device_time_total):
        print(f"[{tag}]   {e.self_device_time_total / 1e3 / n:8.3f} ms "
              f"{e.count / n:5.0f}x per admission  {e.key[:80]}")


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
        max_new_tokens=16), names=("paged_split_kernel",
                                   "merge_splits"))
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
                   card_type="bf16", ref_type="cpu f32"):
    """Card logits [V] against reference ones (CPU float32 unless
    ``ref_type`` names another run): finite, relative L2 error within
    ``tol``.  Returns (same argmax, the reference's logit gap between its
    argmax and the card's, the largest absolute difference)."""
    rel = ((card - ref).norm() / ref.norm()).item()
    err = (card - ref).abs().max().item()
    a, b = int(card.argmax()), int(ref.argmax())
    gap = (ref[b] - ref[a]).item()
    print(f"[check] {name} logits card {card_type} vs {ref_type}: rel_l2="
          f"{rel:.3e} (tol {tol}) max_abs={err:.3e} "
          f"|ref|max={ref.abs().max().item():.3f} argmax {a} vs {b} "
          f"({ref_type.split()[0]} gap {gap:.3e})")
    check(bool(torch.isfinite(card).all()) and rel <= tol,
          f"{name} logits disagree with the {ref_type} run")
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


# ------------------------------------------------------------- phase spec
class WidthLaunches:
    """B1's launches inside a model's paged chunk steps, by chunk width T:
    the kernel wrapper's count read before and after every
    ``decode_chunk_paged`` call (the engine looks the entry point up on the
    model at every call)."""

    def __init__(self, model, counter):
        self.model, self.fn = model, model.decode_chunk_paged
        self.reset()

        def counted(*args, **kw):
            T, before = int(args[1].shape[1]), counter.launches
            out = self.fn(*args, **kw)
            self.calls[T] = self.calls.get(T, 0) + 1
            self.launches[T] = (self.launches.get(T, 0) + counter.launches
                                - before)
            return out
        model.decode_chunk_paged = counted

    def reset(self):
        self.calls, self.launches = {}, {}

    def restore(self):
        self.model.decode_chunk_paged = self.fn


def record_verified_rows(engine, rows_of):
    """Add to ``rows_of`` (see :func:`record_next_token_rows`) the logits
    row behind each token a verification round emits: row j of the slot's
    verified chunk for its j-th token."""
    verify = engine._verify_slot

    def recording(req, slot, drafts, t_prev, pos0, logits, greedy_all, now):
        n = len(req.generated)
        verify(req, slot, drafts, t_prev, pos0, logits, greedy_all, now)
        for j in range(len(req.generated) - n):
            rows_of.setdefault(req.request_id, []).append(
                logits[slot, j].clone())

    engine._verify_slot = recording


def spec_run(torch, rt, model, params, draft, counters, widths, sampling,
             label, waves=None, record=True):
    """A trace (the serve trace by default) on a fresh paged engine, plain
    (``draft`` None) or speculating with ``draft`` = (model, params) at
    spec_k=3, the launch counters set to 0 just before and read just after.
    Holds every request to its tokens, the pool's invariants and B1's
    launches (each inside a target step, 28 a step), and a speculating
    engine to spec rounds and B1 launches at T=4.  Returns the engine, the
    requests and [(tokens, logits rows)] per request (rows when
    ``record``)."""
    from repro_torch.serving import Request

    cfg, L = model.cfg, model.cfg.n_layers
    kw = {} if draft is None else dict(draft_model=draft[0],
                                       draft_params=draft[1], spec_k=3,
                                       spec_min_accept=0.0)
    engine = rt.InferenceEngine(model, params, max_batch=8, max_seq=1024,
                                page_size=64, prefill_chunk=8, **kw)
    rows_of = {}
    if record:
        rows_of = record_next_token_rows(engine)
        record_verified_rows(engine, rows_of)
    draft_s = [0.0, 0]
    if draft is not None:
        # the draft's host wall per call (each ends with its greedy tokens
        # on the host, which synchronises)
        propose = engine._spec.propose

        def timed(want):
            t = time.perf_counter()
            out = propose(want)
            draft_s[0] += time.perf_counter() - t
            draft_s[1] += 1
            return out
        engine._spec.propose = timed
    widths.reset()
    for c in counters.values():
        c.launches = 0
    reqs, step_ms, wall = run_trace(engine, cfg.vocab_size, Request,
                                    sampling, waves)
    launches = {name: c.launches for name, c in counters.items()}
    m = engine.metrics
    b1 = launches["paged_decode_chunk"]
    check(all(r.finished and len(r.generated) == sampling.max_new_tokens
              for r in reqs), f"spec, {label}: not every request finished "
          f"with {sampling.max_new_tokens} tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          f"spec, {label}: a token is outside the vocabulary")
    engine.pool.check_invariants()
    check(b1 > 0 and b1 == sum(widths.launches.values()) and all(
        widths.launches[T] == L * n for T, n in widths.calls.items()),
        f"spec, {label}: B1 launched {b1} times, by chunk width "
        f"{widths.launches} in {widths.calls} paged steps (want {L} a step)")
    if draft is not None:
        check(m.spec_rounds > 0 and widths.launches.get(4, 0) > 0,
              f"spec, {label}: {m.spec_rounds} spec rounds, B1 launches by "
              f"width {widths.launches}")
    print(f"[spec] {label}: {len(reqs)} requests, {m.tokens_generated} "
          f"tokens in {wall:.2f} s: {m.tokens_generated / wall:.1f} "
          f"generated tok/s; {m.decode_steps} steps, step ms p50 "
          f"{np.percentile(step_ms, 50):.2f} p99 "
          f"{np.percentile(step_ms, 99):.2f}; spec_rounds={m.spec_rounds} "
          f"spec_proposed={m.spec_proposed} spec_accepted={m.spec_accepted} "
          f"spec_acceptance={m.spec_acceptance:.3f} decode_tokens_per_step="
          f"{m.decode_tokens_per_step:.3f}; B1 launches {b1}, at T=4 "
          f"{widths.launches.get(4, 0)} (by width "
          f"{dict(sorted(widths.launches.items()))}); draft propose "
          f"{draft_s[0] * 1e3:.1f} ms in {draft_s[1]} calls "
          f"({100 * draft_s[0] * 1e3 / sum(step_ms):.1f} % of the steps' "
          f"wall)")
    out = [(list(r.generated), rows_of.get(r.request_id, [])) for r in reqs]
    return engine, reqs, out


def committed_pages_equal(torch, plain, spec, reqs_a, reqs_b):
    """For every session whose turns got the same tokens on both engines:
    whether its committed K/V bytes are bitwise equal.  Returns (equal,
    compared)."""
    toks = {}
    for ra, rb in zip(reqs_a, reqs_b):
        toks.setdefault(ra.session_id, []).append(
            ra.generated == rb.generated)
    equal = compared = 0
    for sid, same in toks.items():
        a = plain.pool.gather_contiguous(sid, plain.max_seq)
        b = spec.pool.gather_contiguous(sid, spec.max_seq)
        if not all(same) or a is None or b is None:
            continue
        compared += 1
        n = a[2]
        equal += (n == b[2] and torch.equal(a[0][:, :n], b[0][:, :n])
                  and torch.equal(a[1][:, :n], b[1][:, :n]))
    return equal, compared


def projection_rows_bitwise(torch, cfg, params, batch=8):
    """Whether a bf16 projection's rows are bitwise the same at M = B rows
    (a one-token step) and at M = 4B (a verify chunk of T=4), layer 0's
    weights, for each projection of the step.  Reported, not held."""
    lay, emb = params["layers"], params["embed"]
    dev = emb["tok"].device
    g = torch.Generator(device=dev).manual_seed(7)
    D, H, Dh, Fd = cfg.d_model, cfg.n_heads, cfg.head_dim_, cfg.d_ff
    projections = {
        "wq": ((D,), lambda x: torch.einsum("bsd,dhk->bshk", x,
                                            lay["attn"]["wq"][0])),
        "wk": ((D,), lambda x: torch.einsum("bsd,dhk->bshk", x,
                                            lay["attn"]["wk"][0])),
        "wo": ((H, Dh), lambda x: torch.einsum("bshk,hkd->bsd", x,
                                               lay["attn"]["wo"][0])),
        "w_gate": ((D,), lambda x: x @ lay["mlp"]["w_gate"][0]),
        "w_down": ((Fd,), lambda x: x @ lay["mlp"]["w_down"][0]),
        "unembed": ((D,), lambda x: torch.einsum("...d,vd->...v", x,
                                                 emb["tok"])),
    }
    out = {}
    for name, (shape, fn) in projections.items():
        x = torch.randn((batch, 4) + shape, generator=g, device=dev,
                        dtype=torch.float32).to(torch.bfloat16)
        chunk = fn(x)
        out[name] = all(torch.equal(chunk[:, t], fn(x[:, t:t + 1])[:, 0])
                        for t in range(4))
    return out


def phase_spec(torch, rt, cfg, model, params, counters):
    """Speculative decoding on the paged plane over the serve model with a
    one-layer self-draft (``truncated_draft``): the serve trace on a plain
    and on a speculating engine in bf16 (timed; token agreement and
    committed K/V bytes reported), then in float32, where the speculating
    engine's greedy tokens are held to the plain engine's (the tie rule of
    ``planes_agree``), and so are those of a full-depth self-draft on both
    waves' prompts cut to their last 64 tokens, which must accept at least
    0.9 of its proposals; whether bf16 projections are bitwise the same at
    M = B and 4B; and a seeded stochastic run (temperature 0.8, seed 17; the
    first wave's prompts cut to 64 tokens) twice on fresh engines, which
    must give the same tokens."""
    from repro_torch.serving import SamplingParams
    from repro_torch.serving.speculative import truncated_draft

    t0 = time.perf_counter()
    counter = counters["paged_decode_chunk"]
    greedy = SamplingParams(max_new_tokens=32)
    f32_model = rt.build_model(cfg.replace(dtype="float32"))
    f32_params = to_f32(params, device=params["embed"]["tok"].device)
    runs = {}
    for mdl, prm in ((model, params), (f32_model, f32_params)):
        widths = WidthLaunches(mdl, counter)
        draft = truncated_draft(mdl, prm, 1)
        dtype = mdl.cfg.dtype
        try:
            plain, reqs_p, runs[dtype, False] = spec_run(
                torch, rt, mdl, prm, None, counters, widths, greedy,
                f"{dtype} plain")
            spec, reqs_s, runs[dtype, True] = spec_run(
                torch, rt, mdl, prm, draft, counters, widths, greedy,
                f"{dtype} speculating")
            pairs = [("", plain, spec, reqs_p, reqs_s)]
            if dtype == "float32":
                # a draft of the target's full depth proposes what the
                # target decodes: its rounds commit k+1 positions, take the
                # bonus token and roll the draft back past a full accept.
                # Both waves on their prompts' last 64 tokens keep the
                # draft's catch-up over the prompts short.
                short = [[(sid, prompt[-64:]) for sid, prompt in wave]
                         for wave in serve_trace(cfg.vocab_size)]
                plain_s, reqs_ps, runs["short", False] = spec_run(
                    torch, rt, mdl, prm, None, counters, widths, greedy,
                    f"{dtype} plain, prompts cut to 64", waves=short)
                full, reqs_f, runs["short", True] = spec_run(
                    torch, rt, mdl, prm,
                    truncated_draft(mdl, prm, mdl.cfg.n_layers), counters,
                    widths, greedy,
                    f"{dtype} speculating, full-depth draft, prompts cut to "
                    f"64", waves=short)
                m = full.metrics
                check(m.spec_accepted >= 0.9 * m.spec_proposed,
                      f"spec, full-depth draft: {m.spec_accepted} of "
                      f"{m.spec_proposed} proposals accepted (want >= 0.9)")
                pairs.append((", full-depth draft", plain_s, full, reqs_ps,
                              reqs_f))
                del plain_s, full, reqs_ps, reqs_f
        finally:
            widths.restore()
        for label, a, b, reqs_a, reqs_b in pairs:
            equal, compared = committed_pages_equal(torch, a, b, reqs_a,
                                                    reqs_b)
            print(f"[spec] {dtype}{label}: committed K/V bytes bitwise equal "
                  f"for {equal}/{compared} sessions with equal tokens")
        del plain, spec, reqs_p, reqs_s, pairs
        torch.cuda.empty_cache()
    planes_agree(torch, "bfloat16 plain vs speculating",
                 runs["bfloat16", False], runs["bfloat16", True], tag="spec")
    planes_agree(torch, "float32 plain vs speculating",
                 runs["float32", False], runs["float32", True],
                 tol=F32_REL_L2_TOL, tag="spec")
    planes_agree(torch, "float32 plain vs speculating, full-depth draft",
                 runs["short", False], runs["short", True],
                 tol=F32_REL_L2_TOL, tag="spec")
    del runs, f32_model, f32_params
    torch.cuda.empty_cache()
    print(f"[spec] bf16 projection rows bitwise equal at M = B and 4B: "
          f"{projection_rows_bitwise(torch, cfg, params)}")

    widths = WidthLaunches(model, counter)
    draft = truncated_draft(model, params, 1)
    # the first wave's sessions on their prompts' first 64 tokens: eight
    # prefill steps, then decoding
    wave = [(sid, prompt[:64]) for sid, prompt in serve_trace(
        cfg.vocab_size)[0]]
    sampled = []
    try:
        for i in range(2):
            engine, _, out = spec_run(
                torch, rt, model, params, draft, counters, widths,
                SamplingParams(temperature=0.8, seed=17, max_new_tokens=32),
                f"bfloat16 speculating, temperature 0.8 seed 17, run {i}",
                waves=[wave], record=False)
            sampled.append([t for t, _ in out])
            del engine
    finally:
        widths.restore()
    check(sampled[0] == sampled[1], "spec: the same seed gave other tokens "
          "on a fresh engine")
    print(f"[spec] seeded stochastic runs: same tokens on fresh engines "
          f"({sum(map(len, sampled[0]))} tokens); phase "
          f"{time.perf_counter() - t0:.1f} s")
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
    and bitwise against the paged chunk kernel at T=1 on the same pages.
    Returns the number of sessions read."""
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
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            same = torch.equal(got, b1)
            ok = (torch.allclose(got.float(), want.float(), **KERNEL_TOL)
                  and same and bool(torch.isfinite(got).all()))
            print(f"[nalar] {dtype_name} B3 over {iid}'s pool, layer "
                  f"{layer}: {len(sids)} sessions of "
                  f"{lengths.min().item()}..{lengths.max().item()} tokens; "
                  f"max_abs_err {e:.3e} vs plain (tol {KERNEL_TOL}); "
                  f"bitwise equal to paged_decode_chunk T=1: {same}; "
                  f"ok={ok}")
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


def planes_agree(torch, label, paged, dense, tol=None, tag="moe"):
    """Greedy tokens of one trace on two runs (the paged and the dense
    plane; the plain and the speculating engine, phase ``spec``), with the
    logits rows behind them ([(tokens, rows)] per request, in trace order).
    While a request's tokens agree, both runs saw the same context: each
    row pair must agree to relative L2 ``tol``.  Where its tokens first
    differ, the first run's logits of the two tokens must be tied within
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
            print(f"[{tag}] {label} request {j}: first different token at "
                  f"{n} ({ta[n]} vs {tb[n]}); first run's logit gap "
                  f"{gap:.3e}, the rows' max difference {err:.3e}; worst "
                  f"relative L2 up to there {worst:.3e}")
        same += n is None
        if tol is None:
            continue
        check(worst <= tol, f"{label} request {j}: the planes' logits differ "
              f"by relative L2 {worst:.3e} on the same context (tol {tol})")
        check(gap <= err, f"{label} request {j}: the planes' greedy tokens "
              f"differ at {n} by a logit gap of {gap:.3e} > the rows' max "
              f"difference {err:.3e}")
    print(f"[{tag}] {label}: {same}/{len(paged)} requests with the same "
          f"greedy tokens on both runs" + ("" if tol is None else
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
    if prefill_chunk == 0:
        admission_window(torch, engine, cfg, Request,
                         SamplingParams(max_new_tokens=4), "ssm", ("ssd_",))
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
              f"{B * -(-W // 32)} blocks of 32 channels) {RGLRU_DESIGN} "
              f"[{ptxas_tag('rglru_scan_kernel')}]")

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
                       SamplingParams(max_new_tokens=16),
                       names=("ring_split_kernel", "merge_splits"))
        if prefill_chunk == 0:
            admission_window(torch, engine, cfg, Request,
                             SamplingParams(max_new_tokens=4), "hybrid",
                             ("rglru_scan", "flash_"))
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


# ---------------------------------------------------------- phase variants
# the five architectures this phase serves, in order, each at full width
VARIANTS = ("qwen3-1.7b", "stablelm-1.6b", "starcoder2-15b",
            "phi-3-vision-4.2b", "whisper-medium")
# depth of the card's bf16-vs-float32 comparison where float32 does not
# fit beside bf16 (starcoder2-15b: 32 GB bf16, 64 GB float32): its first
# layers; the others compare at full depth
VARIANT_F32_LAYERS = {"starcoder2-15b": 8}
# depth of the float32 card-vs-CPU comparison: the CPU's float32 runs at
# full depth (phi-3's 576-token image prefixes, whisper's 1500-frame
# encoder passes) cost ~100 s of the run's 1200 s limit
VARIANT_CPU_LAYERS = 8


def variant_paged_rows(torch, timer, paged_ops, paged_ref, tag, cases):
    """The paged chunk kernel (B1) at one arch's serving shape each: B=8,
    T=8 (a chunked-prefill step), pages of 64, tables of 16 entries from
    the engine's default pool of 272 pages, contexts 32..544.  Each case
    (label, seed, H, Hkv, D) is held against the plain version in bf16 and
    in float32, its rows bitwise against B=1 and T=1 launches in both, and
    timed (bf16) beside the plain version and gather + SDPA.  Returns the
    largest bf16 difference and the timings by label."""
    B, T, P, maxp, n_pages = 8, 8, 64, 16, 272
    err, timings = 0.0, {}
    for label, seed, H, Hkv, D in cases:
        q, kp, vp, pt, pos = paged_inputs(torch, seed, B, T, H, Hkv, D, P,
                                          n_pages, maxp, (32, 544))
        kw = dict(scale=D ** -0.5, n_rep=H // Hkv)
        for dt, tol in ((torch.bfloat16, KERNEL_TOL),
                        (torch.float32, dict(rtol=1e-5, atol=1e-5))):
            qd, kd, vd = (x.to(dt) for x in (q, kp, vp))
            got = paged_ops.paged_decode_chunk(qd, kd, vd, pt, pos, **kw)
            want = paged_ref.paged_decode_chunk_ref(qd, kd, vd, pt, pos, **kw)
            same_b = all(torch.equal(paged_ops.paged_decode_chunk(
                qd[b:b + 1], kd, vd, pt[b:b + 1].contiguous(), pos[b:b + 1],
                **kw), got[b:b + 1]) for b in range(B))
            same_t = all(torch.equal(paged_ops.paged_decode_chunk(
                qd[:, t:t + 1].contiguous(), kd, vd, pt, pos + t, **kw),
                got[:, t:t + 1]) for t in range(T))
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), **tol)
            name = "bf16" if dt == torch.bfloat16 else "f32"
            print(f"[{tag}] paged_decode_chunk {name} ({label}) B={B} T={T} "
                  f"H={H} Hkv={Hkv} D={D} R={T * H // Hkv} "
                  f"max_abs_err={e:.3e} tol={tol} ok={ok}; rows bitwise "
                  f"equal to B=1 launches: {same_b}, to T=1 launches at "
                  f"pos + t: {same_t}")
            check(ok and same_b and same_t
                  and bool(torch.isfinite(got).all()),
                  f"paged_decode_chunk {name} ({label}) disagrees with its "
                  f"plain version or its rows depend on the batch or chunk")
            if dt == torch.bfloat16:
                err = max(err, e)
        n_bytes, flops = paged_cost(pt, pos, T, H, Hkv, D, P)
        bound, by = bound_ms(n_bytes, flops)
        library = gather_sdpa(torch, q, kp, vp, pt, pos, kw["scale"])
        t = {"ms": timer.ms(lambda: paged_ops.paged_decode_chunk(
                 q, kp, vp, pt, pos, **kw)),
             "plain_ms": timer.ms(lambda: paged_ref.paged_decode_chunk_ref(
                 q, kp, vp, pt, pos, **kw)),
             "library_ms": timer.ms(library),
             "bound_ms": bound, "bound_by": by}
        timings[label] = t
        print(f"[{tag}] paged_decode_chunk timed ({label}) B={B} T={T} H={H} "
              f"Hkv={Hkv} D={D} P={P}: ms={t['ms']:.4f} plain_ms="
              f"{t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
              f"(gather + SDPA) bound_ms={bound:.5f} ({by}; {n_bytes} B, "
              f"{flops} flop) [{ptxas_tag(*PAGED_SYMBOLS)}]")
    return err, timings


def variant_kernel_rows(torch, timer, paged_ops, paged_ref, flash_ops,
                        flash_ref):
    """The shapes the five architectures give B1, B2 and B4 that no other
    phase runs: head dims 64 and 96, full MHA (n_rep 1) and starcoder2's
    group of 12 (48 query heads over 4 kv heads).  Each is held against
    its plain version (and bitwise across batch, chunk or sequence length)
    and timed in bf16 with its bound and the library call."""
    tag = "variants"
    variant_paged_rows(torch, timer, paged_ops, paged_ref, tag, [
        ("stablelm-1.6b", 201, 32, 32, 64),
        ("whisper-medium", 202, 16, 16, 64),
        ("phi-3-vision-4.2b", 203, 32, 32, 96),
        ("starcoder2-15b", 204, 48, 4, 128)])
    # monolithic prefills: phi-3's 576 image tokens before a text bucket of
    # 256; stablelm's and whisper's decoder over a bucket of 256; the card
    # tests' S = 576 + 128 at D=64
    flash_rows(torch, timer, flash_ops, flash_ref, tag, 32, 96, 205,
               [(576 + 256, None, True), (576 + 128, None, False)])
    flash_rows(torch, timer, flash_ops, flash_ref, tag, 32, 64, 206,
               [(256, None, True), (576 + 128, None, False)])
    flash_rows(torch, timer, flash_ops, flash_ref, tag, 16, 64, 207,
               [(256, None, True)])
    # decode_step over a 1024-slot cache at the serve trace's contexts
    pos = np.random.default_rng(208).integers(64, 288, 8)
    ring_rows(torch, timer, paged_ops, paged_ref, tag, 32, 32, 64, 209,
              [("stablelm-1.6b", 1024, None, pos)])
    ring_rows(torch, timer, paged_ops, paged_ref, tag, 16, 16, 64, 210,
              [("whisper-medium", 1024, None, pos)])
    ring_rows(torch, timer, paged_ops, paged_ref, tag, 48, 4, 128, 211,
              [("starcoder2-15b", 1024, None, pos),
               (None, 4096, 4096, np.array([100, 4095, 4096, 5000]))])


def variant_extras(cfg, rng):
    """One request's stubbed frontend input, at the scale of a token
    embedding (std d_model^-0.5): phi-3's projected image patches
    [576, 3072] or whisper's frame embeddings [1500, 1024]."""
    if cfg.family == "vlm":
        shape = (cfg.n_image_tokens, cfg.d_model)
        key = "image_embeds"
    else:
        shape = (cfg.encoder_seq, cfg.d_model)
        key = "frames"
    return {key: (rng.standard_normal(shape)
                  * cfg.d_model ** -0.5).astype(np.float32)}


def variant_trace(cfg):
    """Two waves, 8 requests: two sessions with a second turn and four
    single-turn users, prompts of 64..256 tokens (second turns 32..64).
    phi-3: the sessions' first turns and two users carry an image (half
    the requests); whisper: every request carries frames.  Returns
    [[(session, prompt, extras)]]."""
    rng = np.random.default_rng(0)

    def toks(lo, hi):
        return rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi + 1)))

    def ex(with_image):
        if cfg.family == "audio" or (cfg.family == "vlm" and with_image):
            return variant_extras(cfg, rng)
        return {}

    wave1 = [(f"sess{i}", toks(64, 256), ex(True)) for i in range(2)]
    wave1 += [(f"user{i}", toks(64, 256), ex(i < 2)) for i in range(4)]
    wave2 = [(f"sess{i}", toks(32, 64), ex(False)) for i in range(2)]
    return [wave1, wave2]


def variant_serve(torch, rt, model, params, counters, tally, tag,
                  prefill_chunk=8, paged=True):
    """The variant trace on one engine (greedy, 16 new tokens each), the
    launch counters set to 0 just before and read just after.  Holds every
    request to its 16 tokens and the pool's invariants, B1 to L launches
    per paged step and B2 to L per monolithic prefill.  Returns the
    requests and the launches."""
    from repro_torch.serving import Request, SamplingParams

    cfg, L = model.cfg, model.cfg.n_layers
    engine = rt.InferenceEngine(model, params, max_batch=8, max_seq=1024,
                                page_size=64, prefill_chunk=prefill_chunk,
                                paged_decode=paged)
    sampling = SamplingParams(max_new_tokens=16)
    tally.reset()
    for c in counters.values():
        c.launches = 0
    reqs, step_ms = [], []
    t0 = time.perf_counter()
    for wave in variant_trace(cfg):
        for sid, prompt, ex in wave:
            req = Request.make(prompt, session_id=sid, sampling=sampling,
                               **ex)
            engine.submit(req)
            reqs.append(req)
        while True:
            t = time.perf_counter()
            n = engine.step()
            if n == 0 and len(engine.queue) == 0:
                break
            step_ms.append((time.perf_counter() - t) * 1e3)
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    calls = dict(tally.calls)
    m = engine.metrics
    where = (f"{tag}, {'paged' if paged else 'dense'} plane, "
             f"prefill_chunk={prefill_chunk}")
    check(all(r.finished and len(r.generated) == 16 for r in reqs),
          f"{where}: not every request finished with 16 tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          f"{where}: a token is outside the vocabulary")
    want_path = "paged" if paged else "fused"
    check(all(r.decode_path == want_path for r in reqs),
          f"{where}: a request took another decode path than {want_path}")
    engine.pool.check_invariants()
    want_b1 = L * calls["decode_chunk_paged"] if paged else 0
    check(launches["paged_decode_chunk"] == want_b1
          and (want_b1 > 0) == paged,
          f"{where}: paged_decode_chunk launched "
          f"{launches['paged_decode_chunk']} times (want {want_b1})")
    check(launches["flash_attention_bhsd"] == L * calls["prefill"],
          f"{where}: flash_attention_bhsd launched "
          f"{launches['flash_attention_bhsd']} times in {calls['prefill']} "
          f"prefills (want {L} each)")
    images = sum("image_embeds" in r.extras for r in reqs)
    if cfg.family == "vlm" and prefill_chunk:
        # image requests take the monolithic prefill (B2 over 576 + bucket)
        check(calls["prefill"] == images == 4,
              f"{where}: {calls['prefill']} prefills for {images} images")
    if cfg.family == "audio":
        check(m.resume_unsupported == 2 and m.prefix_hits == 0,
              f"{where}: audio second turns were not refused and counted "
              f"({m.resume_unsupported} refused, {m.prefix_hits} resumed)")
    elif paged or cfg.family != "vlm":
        check(m.prefix_hits >= 2, f"{where}: the second turns did not "
              f"resume ({m.prefix_hits} prefix hits)")
    gen = m.tokens_generated
    print(f"[{tag}] {where}: {len(reqs)} requests ({images} with images), "
          f"{gen} tokens in {wall:.2f} s: {gen / wall:.1f} generated tok/s, "
          f"{(m.prefill_tokens + gen) / wall:.1f} processed tok/s; "
          f"{m.decode_steps} steps, step ms p50 "
          f"{np.percentile(step_ms, 50):.2f} p99 "
          f"{np.percentile(step_ms, 99):.2f}; prefix_hits={m.prefix_hits} "
          f"shared_prefix_hits={m.shared_prefix_hits} resume_unsupported="
          f"{m.resume_unsupported}; forwards {calls}; launches "
          f"paged_decode_chunk={launches['paged_decode_chunk']} "
          f"flash_attention_bhsd={launches['flash_attention_bhsd']} "
          f"decode_ring={launches['decode_ring']}")
    del engine
    torch.cuda.empty_cache()
    return reqs, launches


def variant_cut(cfg, params, n):
    """The first ``n`` layers (decoder and encoder alike) of a model: its
    config and its parameters (views of the stacked layers; the embedding,
    the norms and the encoder's position table shared)."""
    def take(tree):
        return {k: take(v) if isinstance(v, dict) else v[:n]
                for k, v in tree.items()}

    if cfg.family == "audio":
        return (cfg.replace(n_layers=n, n_encoder_layers=n),
                dict(params, enc_layers=take(params["enc_layers"]),
                     dec_layers=take(params["dec_layers"])))
    return cfg.replace(n_layers=n), dict(params, layers=take(params["layers"]))


def variant_logits(torch, rt, mdl, prm, dev, prompt, ex, counters):
    """Next-token logits [V] (float32, on the host) of ``prompt`` (with its
    extras) through the monolithic prefill, one paged chunk step over a
    fresh pool (text only for the VLM; the audio memory from
    ``encode_cross``) and one ``decode_step`` after the prefill; and the
    launches of the prefill and of the ``decode_step`` alone."""
    n = len(prompt)
    toks = torch.from_numpy(prompt[None]).to(dev)
    batch = {"tokens": toks}
    batch.update({k: torch.from_numpy(v[None]).to(dev)
                  for k, v in ex.items()})
    S = n + (mdl.cfg.n_image_tokens if "image_embeds" in ex else 0)
    for c in counters.values():
        c.launches = 0
    logits, cache = mdl.prefill(prm, batch, pad_cache_to=S + 8)
    launches = {"prefill": {k: c.launches for k, c in counters.items()}}
    slim = {"pos": torch.zeros(1, dtype=torch.int32, device=dev)}
    if "frames" in ex:
        slim["xk"], slim["xv"] = mdl.encode_cross(prm, batch["frames"])
    pool = rt.PagedKVPool(mdl.cfg, n_pages=2, page_size=64, device=dev)
    pt = torch.tensor([[0, -1]], dtype=torch.int32, device=dev)
    step, _, _, _ = mdl.decode_chunk_paged(
        prm, toks, torch.tensor([n], dtype=torch.int32, device=dev), slim,
        pool.k, pool.v, pt, max_seq=1024)
    for c in counters.values():
        c.launches = 0
    one, _ = mdl.decode_step(prm, toks[:, 0], cache)
    launches["decode_step"] = {k: c.launches for k, c in counters.items()}
    return ([x.float().cpu() for x in (logits[0], step[0, -1], one[0])],
            launches)


def variant_logits_check(torch, rt, cfg, model, params, counters, tag):
    """Next-token logits of two prompts (23 and 61 tokens, each with its
    own extras) through prefill, a paged step and ``decode_step``: the card
    in bf16 against the card in float32 at full depth (or the first
    ``VARIANT_F32_LAYERS`` layers where float32 does not fit beside bf16)
    within 5e-2 relative L2, argmax equal unless tied; and the card in
    float32 against the CPU in float32 on the first
    ``VARIANT_CPU_LAYERS`` layers (whisper's encoder cut alike) within
    1e-3.  On the card a prefill launches B2 once a layer and a
    ``decode_step`` B4 once a layer."""
    rng = np.random.default_rng(6)
    prompts = []
    for n in (23, 61):
        ex = (variant_extras(cfg, rng) if cfg.family in ("vlm", "audio")
              else {})
        prompts.append((rng.integers(0, cfg.vocab_size, n), ex))
    depth = VARIANT_F32_LAYERS.get(cfg.arch_id, cfg.n_layers)
    depth = min(depth, cfg.n_layers)
    if depth < cfg.n_layers:
        cut_cfg, cut = variant_cut(cfg, params, depth)
        bf16 = (rt.build_model(cut_cfg), cut)
    else:
        cut_cfg, bf16 = cfg, (model, params)
    f32_model = rt.build_model(cut_cfg.replace(dtype="float32"))
    pairs = {"bf16": (bf16, "cuda"),
             "f32": ((f32_model, to_f32(bf16[1], device="cuda")), "cuda")}
    cpu_depth = min(VARIANT_CPU_LAYERS, depth)
    small_cfg, small = variant_cut(cfg, params, cpu_depth)
    small_model = rt.build_model(small_cfg.replace(dtype="float32"))
    if cpu_depth < depth:
        pairs["f32 cut"] = ((small_model, to_f32(small, device="cuda")),
                            "cuda")
    pairs["cpu"] = ((small_model, to_f32(small)), "cpu")
    runs = {}
    for label, ((mdl, prm), dev) in pairs.items():
        runs[label] = []
        for prompt, ex in prompts:
            out, launches = variant_logits(torch, rt, mdl, prm, dev, prompt,
                                           ex, counters)
            runs[label].append(out)
            if dev == "cuda":
                L = mdl.cfg.n_layers
                check(launches["prefill"]["flash_attention_bhsd"] == L
                      and launches["decode_step"]["decode_ring"] == L,
                      f"{tag} {label}: prefill / decode_step launched "
                      f"{launches} (want {L} flash_attention_bhsd and "
                      f"{L} decode_ring)")
        del prm
    del pairs, bf16
    torch.cuda.empty_cache()
    print(f"[{tag}] a prefill launches one flash_attention_bhsd and a "
          f"decode_step one decode_ring a layer (bf16 and float32)")
    for i, (prompt, ex) in enumerate(prompts):
        for j, name in enumerate(("prefill", "paged step", "decode_step")):
            what = (f"{cfg.arch_id} prompt of {len(prompt)}"
                    f"{' + ' + '/'.join(ex) if ex else ''}: {name}")
            same, gap, err = compare_logits(
                torch, f"{what} ({depth} layers)", runs["bf16"][i][j],
                runs["f32"][i][j], ref_type="card f32")
            check(same or gap <= err,
                  f"{what}: card bf16 and f32 argmax differ by a logit gap "
                  f"of {gap:.3e} > the runs' max difference {err:.3e}")
            same, _, _ = compare_logits(
                torch, f"{what} ({cpu_depth} layers)",
                runs["f32 cut" if cpu_depth < depth else "f32"][i][j],
                runs["cpu"][i][j], tol=F32_REL_L2_TOL, card_type="f32")
            check(same, f"{what}: card f32 and CPU argmax differ")


def phase_variants(torch, rt, counters, timer, paged_ops, paged_ref,
                   flash_ops, flash_ref):
    """The five remaining architectures at full width (random weights from
    seed 0, bf16), one after the other, each freed before the next: their
    kernel shapes first, then for each the variant trace on the paged
    plane (whisper also at ``prefill_chunk=0`` and on the dense plane) and
    the logits checks.  Returns the launches of B1, B2 and B4 by arch."""
    t0 = time.perf_counter()
    variant_kernel_rows(torch, timer, paged_ops, paged_ref, flash_ops,
                        flash_ref)
    print(f"[time] variants: kernel shapes, {time.perf_counter() - t0:.1f} s "
          f"into the phase")
    out = {}
    for arch in VARIANTS:
        t1 = time.perf_counter()
        cfg = rt.get_config(arch)
        tag = f"variants {arch}"
        model = rt.build_model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
        torch.cuda.synchronize()
        leaves = list(tree_leaves(params))
        n_bytes = sum(v.numel() * v.element_size() for v in leaves)
        extra = ""
        if cfg.family == "audio":
            mem = (2 * cfg.n_layers * cfg.encoder_seq * cfg.n_kv_heads
                   * cfg.head_dim_ * 2)
            extra = f"; cross-attention memory {mem} bytes a slot"
        print(f"[{tag}] {cfg.family}, {cfg.n_layers} layers"
              f"{f' (+{cfg.n_encoder_layers} encoder)' if cfg.family == 'audio' else ''}"
              f", d_model {cfg.d_model}, heads {cfg.n_heads}/"
              f"{cfg.n_kv_heads}, head_dim {cfg.head_dim_}, d_ff {cfg.d_ff}, "
              f"{cfg.norm_type} norm, {cfg.mlp_type}, rope_pct "
              f"{cfg.rope_pct}, window {cfg.sliding_window}, vocab "
              f"{cfg.vocab_size}; {sum(v.numel() for v in leaves)} params, "
              f"{n_bytes} bytes of weights measured "
              f"({n_bytes / 2**30:.2f} GiB){extra}; set up in "
              f"{time.perf_counter() - t1:.1f} s")
        tally = ForwardTally(model)
        _, launches = variant_serve(torch, rt, model, params, counters,
                                    tally, tag)
        got = {k: launches[k] for k in ("paged_decode_chunk",
                                        "flash_attention_bhsd")}
        if cfg.family == "audio":
            _, mono = variant_serve(torch, rt, model, params, counters,
                                    tally, tag, prefill_chunk=0)
            check(mono["flash_attention_bhsd"] == cfg.n_layers * 8,
                  f"{tag}: prefill_chunk=0 launched "
                  f"{mono['flash_attention_bhsd']} flash kernels")
            got["flash_attention_bhsd (prefill_chunk=0)"] = \
                mono["flash_attention_bhsd"]
            variant_serve(torch, rt, model, params, counters, tally, tag,
                          paged=False)
        variant_logits_check(torch, rt, cfg, model, params, counters, tag)
        got["decode_ring (one decode_step)"] = cfg.n_layers
        out[arch] = got
        del model, params, leaves, tally
        torch.cuda.empty_cache()
        print(f"[time] variants: {arch} done, "
              f"{time.perf_counter() - t0:.1f} s into the phase "
              f"({time.perf_counter() - t1:.1f} s)")
    print(f"[variants] launches by arch: {json.dumps(out)}")
    return out


# -------------------------------------------------------------- phase train
# card float32 vs CPU float32 on one loss and its gradients: the same
# float32 math (cuBLAS without TF32, which is torch's default) summed in
# another order
TRAIN_LOSS_REL_TOL = 1e-5
TRAIN_GRAD_REL_L2_TOL = 1e-4
# qwen3-0.6b's parameters (the model-FLOPs share counts 6 per parameter
# and token)
QWEN3_PARAMS = 0.596e9


def train_leaves(tree):
    """(path, tensor) of a parameter tree in the port's leaf order (keys
    sorted, as the gradients of ``loss_and_grads`` come)."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            for path, v in train_leaves(tree[k]):
                yield f"{k}.{path}", v
        else:
            yield k, tree[k]


def train_batches(cfg, batch, seq, n, seed=0):
    """``n`` batches of the synthetic corpus, made before any step (the
    corpus draws on the host: ~0.6 s a batch of 8 x 512 at qwen3's vocab)."""
    from repro_torch.training import DataConfig, Syntheticcorpus, extra_inputs
    corpus = Syntheticcorpus(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=seq, global_batch=batch,
                                        seed=seed))
    extras = extra_inputs(cfg, batch, seed)
    return [dict(corpus.batch(i), **extras) for i in range(n)]


def train_card_vs_cpu(torch, rt, arch, moe_impl, B, S):
    """One ``loss_fn`` and its gradients at full width cut to 2 layers,
    float32, on the card and on the CPU, from the same weights and batch:
    the loss within ``TRAIN_LOSS_REL_TOL``, every leaf's gradient within
    ``TRAIN_GRAD_REL_L2_TOL`` relative L2.  Returns the largest errors."""
    from repro_torch.training.train import loss_and_grads, to_device
    cfg = rt.get_config(arch).replace(n_layers=2, dtype="float32")
    model = rt.build_model(cfg, moe_impl=moe_impl)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = train_batches(cfg, B, S, 1)[0]
    t0 = time.perf_counter()
    card_loss, card_g = loss_and_grads(model, to_f32(params, "cuda"),
                                       to_device(batch, "cuda"))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cpu_loss, cpu_g = loss_and_grads(model, params, to_device(batch, "cpu"))
    t2 = time.perf_counter()
    loss_rel = abs(card_loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    worst, worst_path = 0.0, ""
    for (path, _), g_card, g_cpu in zip(train_leaves(params), card_g,
                                        cpu_g):
        g_card = g_card.cpu()
        check(bool(torch.isfinite(g_card).all()),
              f"train {arch}: gradient of {path} not finite on the card")
        rel = ((g_card - g_cpu).norm() / g_cpu.norm().clamp(min=1e-30)).item()
        if rel > worst:
            worst, worst_path = rel, path
    tag = f"{arch}" + (f" moe_impl={moe_impl}" if cfg.n_experts else "")
    print(f"[train] card vs CPU, f32, 2 layers, {tag}, B={B} S={S}"
          f"{' + ' + str(cfg.n_image_tokens) + ' image tokens' if cfg.family == 'vlm' else ''}"
          f": loss {card_loss.item():.6f} vs {cpu_loss.item():.6f} (rel "
          f"{loss_rel:.3e}, tol {TRAIN_LOSS_REL_TOL}); {len(card_g)} "
          f"gradient leaves, largest rel L2 {worst:.3e} ({worst_path}; tol "
          f"{TRAIN_GRAD_REL_L2_TOL}); card {t1 - t0:.2f} s, CPU "
          f"{t2 - t1:.2f} s")
    check(loss_rel <= TRAIN_LOSS_REL_TOL,
          f"train {tag}: card loss differs from the CPU's by {loss_rel:.3e}")
    check(worst <= TRAIN_GRAD_REL_L2_TOL,
          f"train {tag}: gradient of {worst_path} differs from the CPU's "
          f"by {worst:.3e} relative L2")
    return loss_rel, worst


def train_run(torch, model, params, batches, opt):
    """The train step over ``batches`` (the step of ``train``), each step
    ending in a synchronise.  Returns the losses and step times (s)."""
    from repro_torch.training import make_train_step
    from repro_torch.training.train import to_device
    step_fn = make_train_step(model, opt)
    state = opt.init(params)
    losses, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state,
                                         to_device(batch, "cuda"))
        loss = metrics["loss"].item()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        check(np.isfinite(loss), f"train: loss {loss} at step "
              f"{len(losses) - 1} is not finite")
    del state
    return losses, times


def step_stats(times, tokens, n_params=None):
    """Median and p90 step time over steps 5.. (ms), tokens/s at the
    median, and the model-FLOPs share (6 * params * tokens / step time
    over the card's dense bf16 peak) where ``n_params`` is given."""
    t = np.asarray(times[5:]) * 1e3
    p50, p90 = float(np.median(t)), float(np.percentile(t, 90))
    out = (f"step p50 {p50:.2f} ms, p90 {p90:.2f} ms (steps 5-"
           f"{len(times) - 1}), {tokens / p50 * 1e3:.0f} tokens/s")
    if n_params:
        mfu = 6 * n_params * tokens / (p50 * 1e-3) / BF16_FLOP_PER_S
        out += (f", model-FLOPs share {mfu:.4f} (6 x {n_params:.4g} params "
                f"x {tokens} tokens over {BF16_FLOP_PER_S:.3g} flop/s)")
    return out


def phase_train(torch, rt, counters, timer, flash_ops, flash_ref, card):
    """Training on the card (ROADMAP A14, first half): card float32 against
    the CPU on one loss and its gradients; qwen3-0.6b trained at full
    width in bf16 (30 steps of 8 x 512, then one step's loss under
    ``remat``); B2 at a training shape (``attention_impl="pallas"`` under
    no_grad, and refused under autograd); granite-moe-1b-a400m trained at
    full width with the capacity dispatch; the launcher and its
    checkpoint.  Returns B2's launches in the no_grad forward."""
    import tempfile

    from repro_torch.launch import train as launch_train
    from repro_torch.models import moe
    from repro_torch.training import AdamW, checkpoint, cosine_schedule
    from repro_torch.training.train import loss_and_grads, to_device

    t_phase = time.perf_counter()
    print(f"[train] card {card}; float32 matmul TF32 "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "train: float32 matmuls would run in TF32")
    # 1. card float32 vs CPU float32, full width cut to 2 layers
    for arch, impl, B, S in (("qwen3-0.6b", "einsum", 2, 128),
                             ("granite-moe-1b-a400m", "einsum", 2, 128),
                             ("granite-moe-1b-a400m", "gather", 2, 128),
                             ("phi-3-vision-4.2b", "einsum", 1, 64)):
        train_card_vs_cpu(torch, rt, arch, impl, B, S)
        torch.cuda.empty_cache()
    print(f"[time] train: card vs CPU done, "
          f"{time.perf_counter() - t_phase:.1f} s into the phase")

    # 2. qwen3-0.6b at full width, bf16, 28 layers
    cfg = rt.get_config("qwen3-0.6b")
    model = rt.build_model(cfg)
    B, S, steps = 8, 512, 30
    t0 = time.perf_counter()
    batches = train_batches(cfg, B, S, steps)
    print(f"[train] qwen3-0.6b: {steps} batches of {B} x {S} drawn on the "
          f"host in {time.perf_counter() - t0:.1f} s")
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    opt = AdamW(learning_rate=cosine_schedule(1e-3, 5, steps))
    torch.cuda.reset_peak_memory_stats()
    losses, times = train_run(torch, model, params, batches, opt)
    peak = torch.cuda.max_memory_allocated()
    last5 = float(np.mean(losses[-5:]))
    print(f"[train] qwen3-0.6b full width bf16, {cfg.n_layers} layers, "
          f"B={B} S={S}, lr 1e-3 (warmup 5, cosine): losses "
          f"{' '.join(f'{x:.3f}' for x in losses)}")
    print(f"[train] qwen3-0.6b: first {losses[0]:.4f} (ln V = "
          f"{np.log(cfg.vocab_size):.4f}), mean of the last 5 {last5:.4f} "
          f"(drop {losses[0] - last5:.4f} nats); "
          f"{step_stats(times, B * S, QWEN3_PARAMS)}; "
          f"max_memory_allocated {peak} bytes ({peak / 2**30:.2f} GiB); "
          f"card {card}")
    check(last5 <= losses[0] - 1.0,
          f"train: qwen3-0.6b's loss fell {losses[0] - last5:.3f} nats, "
          f"less than 1.0")
    batch = to_device(batches[-1], "cuda")
    peaks = {}
    for remat in (False, True):
        m = rt.build_model(cfg, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(m, params, batch)
        torch.cuda.synchronize()
        peaks[remat] = (loss.item(), torch.cuda.max_memory_allocated(),
                        time.perf_counter() - t0)
        del grads
    (l0, m0, s0), (l1, m1, s1) = peaks[False], peaks[True]
    print(f"[train] qwen3-0.6b loss and gradients on the trained params "
          f"and the last batch: remat=False loss {l0:.5f}, peak {m0} bytes "
          f"({m0 / 2**30:.2f} GiB), {s0 * 1e3:.1f} ms; remat=True loss "
          f"{l1:.5f} (rel {abs(l1 - l0) / abs(l0):.3e}, tol 1e-2), peak {m1} "
          f"bytes ({m1 / 2**30:.2f} GiB), {s1 * 1e3:.1f} ms")
    check(abs(l1 - l0) <= 1e-2 * abs(l0),
          "train: the remat loss differs from the plain loss")

    # 5. B2 at a training shape: the forward under no_grad, B=2, S=512
    fb = to_device({"tokens": batches[0]["tokens"][:2]}, "cuda")
    flash_model = rt.build_model(cfg, attention_impl="pallas")
    with torch.no_grad():
        want = model.forward(params, fb)[0].float()
        counters["flash_attention_bhsd"].launches = 0
        got = flash_model.forward(params, fb)[0].float()
        torch.cuda.synchronize()
        b2 = counters["flash_attention_bhsd"].launches
    rel = ((got - want).norm() / want.norm()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"[train] B2 in the training forward (attention_impl='pallas', "
          f"no_grad, B=2, S=512, bf16): {b2} launches (one a layer), logits "
          f"rel L2 vs 'xla' {rel:.3e} (tol 2e-2), argmax agreement "
          f"{agree:.4f}")
    check(b2 == cfg.n_layers,
          f"train: B2 launched {b2} times in a {cfg.n_layers}-layer forward")
    check(rel <= 2e-2, "train: the B2 forward's logits differ from 'xla'")
    try:
        loss_and_grads(flash_model, params,
                       to_device({k: v[:2] for k, v in batches[0].items()},
                                 "cuda"))
        check(False, "train: B2 ran under autograd")
    except RuntimeError as e:
        check("flash_attention_bhsd" in str(e), f"train: {e}")
        print(f"[train] B2 under autograd refused: {str(e)[:72]}...")
    flash_rows(torch, timer, flash_ops, flash_ref, "train",
               2 * cfg.n_heads, cfg.head_dim_, 33, [(S, None, True)])
    del params, batches, batch, flash_model, model, got, want
    torch.cuda.empty_cache()
    print(f"[time] train: qwen3 done, {time.perf_counter() - t_phase:.1f} s "
          f"into the phase")

    # 3. granite-moe-1b-a400m at full width, capacity einsum dispatch
    cfg = rt.get_config("granite-moe-1b-a400m")
    model = rt.build_model(cfg, moe_impl="einsum")
    B, S, steps = 4, 512, 15
    batches = train_batches(cfg, B, S, steps)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    first = to_device(batches[0], "cuda")
    with torch.no_grad():
        aux0 = model.forward(params, first)[1].item()
    torch.cuda.reset_peak_memory_stats()
    losses, times = train_run(torch, model, params, batches,
                              AdamW(learning_rate=cosine_schedule(
                                  1e-3, 5, steps)))
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        aux1 = model.forward(params, first)[1].item()
    last3 = float(np.mean(losses[-3:]))
    print(f"[train] granite-moe-1b-a400m full width bf16, {cfg.n_layers} "
          f"layers, capacity dispatch 'einsum' (G = {min(2048, B * S)}, C = "
          f"{moe._capacity(min(2048, B * S), cfg)}), B={B} S={S}: losses "
          f"{' '.join(f'{x:.3f}' for x in losses)}; first {losses[0]:.4f}, "
          f"mean of the last 3 {last3:.4f}; aux loss {aux0:.4f} -> "
          f"{aux1:.4f} (batch 0); {step_stats(times, B * S)}; "
          f"max_memory_allocated {peak} bytes ({peak / 2**30:.2f} GiB); "
          f"card {card}")
    check(last3 < losses[0], "train: granite's loss did not fall")
    del params, batches, first, model
    torch.cuda.empty_cache()

    # 4. the launcher in process, and its checkpoint restored onto the card
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "qwen3.ckpt")
        t0 = time.perf_counter()
        trained = launch_train.main(["--arch", "qwen3-0.6b", "--steps", "4",
                                     "--batch", "4", "--seq", "256",
                                     "--log-every", "1", "--ckpt", path])
        t1 = time.perf_counter()
        with open(path, "rb") as f:
            magic = f.read(4)
        back = checkpoint.restore(path, trained, device="cuda")
        t2 = time.perf_counter()
        n = 0
        for (p, a), (_, b) in zip(train_leaves(trained), train_leaves(back)):
            check(a.dtype == b.dtype and b.is_cuda and torch.equal(a, b),
                  f"train: checkpoint leaf {p} differs after restore")
            n += 1
        print(f"[train] launcher: 4 steps and a {magic.decode()} checkpoint "
              f"of {Path(path).stat().st_size} bytes in {t1 - t0:.1f} s; "
              f"restored onto the card in {t2 - t1:.1f} s, {n} leaves equal "
              f"bit for bit")
    del trained, back
    torch.cuda.empty_cache()
    print(f"[time] train: phase {time.perf_counter() - t_phase:.1f} s")
    return b2


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
        phase_spec(torch, rt, cfg, model, params, counters)
        print(f"[time] spec done at {time.perf_counter() - t_start:.1f} s")
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
        print(f"[time] hybrid done at {time.perf_counter() - t_start:.1f} s")
        torch.cuda.empty_cache()
        phase_variants(torch, rt, counters, timer, paged_ops, paged_ref,
                       flash_ops, flash_ref)
        print(f"[time] variants done at {time.perf_counter() - t_start:.1f} s")
        torch.cuda.empty_cache()
        phase_train(torch, rt, counters, timer, flash_ops, flash_ref, card)
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
