"""Mamba2 (state-space duality / SSD), serving entry points.

The port of the JAX package's ``models/ssm.py`` for serving: block
in_proj -> (z | x | B | C | dt), causal depthwise conv over (x, B, C), SSD
mixing, gated RMSNorm, out_proj.  The full-sequence SSD runs the chunked
dual form through :func:`ssd_chunked`, which is the hand-written chunk-scan
kernel on a CUDA tensor (``kernels/ssd``) and its plain version on a CPU
tensor; decode keeps O(1) state per layer (a conv window and the SSM state
[H, P, N]) and updates it with the plain recurrence, as the reference's XLA
does.  Parameters keep the reference's tree with its leading layer
dimension L; each layer is a loop iteration over views of those stacked
tensors.  Every entry point returns a new cache (nothing is updated in
place).  ``forward`` and the loss are training (ROADMAP.md A14).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from ..kernels.ssd.ops import ssd_chunk_scan
from . import layers as L
from .transformer import _layer, _normal


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None) -> dict:
    """Random parameters with the tree, shapes, types and scales of the
    reference's ``ssm.init_params``; the draws come from ``generator``,
    which must live on ``device``."""
    dev = resolve_device(device)
    D, din, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H, K, NL = cfg.n_ssm_heads, cfg.ssm_conv, cfg.n_layers
    conv_dim = din + 2 * N
    dt = cfg.torch_dtype

    def s(a, b):
        return (2.0 / (a + b)) ** 0.5

    def n(shape, std):
        return _normal(shape, std, cfg, generator, dev)

    def f32(values):
        return values.to(device=dev, dtype=torch.float32).expand(NL, H) \
            .contiguous()

    return {
        "embed": {"tok": n((cfg.vocab_size, D), D ** -0.5)},
        "layers": {
            "norm": {"w": torch.ones((NL, D), dtype=dt, device=dev)},
            # order: [z (din) | x (din) | B (N) | C (N) | dt (H)]
            "in_proj": n((NL, D, 2 * din + 2 * N + H), s(D, din)),
            "conv_w": n((NL, K, conv_dim), 0.2),
            "conv_b": torch.zeros((NL, conv_dim), dtype=dt, device=dev),
            "A_log": f32(torch.log(torch.linspace(1.0, 16.0, H))),
            "D_skip": f32(torch.ones(H)),
            "dt_bias": f32(torch.zeros(H)),
            "gate_norm": torch.ones((NL, din), dtype=dt, device=dev),
            "out_proj": n((NL, din, D), s(din, D)),
        },
        "final_norm": {"w": torch.ones((D,), dtype=dt, device=dev)},
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, written as the reference writes it: K shifted
    products summed in order, then bias and silu.  x [B,S,C], w [K,C]."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + S, :] * w[i] for i in range(K))
    return F.silu(out + b)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD dual form: x [B,S,H,P], dt [B,S,H], A [H] (positive rates),
    Bm/Cm [B,S,N] -> (y [B,S,H,P], final state [B,H,P,N] float32).  The
    chunk-scan kernel on a CUDA tensor, its plain version on a CPU one.
    A pass-through, kept so the module's functions carry the reference
    ``ssm.py``'s names."""
    return ssd_chunk_scan(x, dt, A, Bm, Cm, chunk=chunk,
                          init_state=init_state)


def _block_inner(x: torch.Tensor, p: dict, cfg: ModelConfig,
                 conv_state: Optional[torch.Tensor] = None,
                 ssm_state: Optional[torch.Tensor] = None,
                 single_step: bool = False):
    """Shared by prefill (full sequence) and decode (single token).
    Returns (y, new_conv_state, new_ssm_state)."""
    Bsz, S, _ = x.shape
    din, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    P, K = cfg.ssm_head_dim, cfg.ssm_conv
    proj = x @ p["in_proj"]
    z, xbcd, dt_raw = torch.split(proj, [din, din + 2 * N, H], dim=-1)

    if single_step:
        # conv window: conv_state [B, K-1, din+2N] holds the previous inputs
        window = torch.cat([conv_state, xbcd], dim=1)            # [B,K,conv]
        conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) \
            + p["conv_b"]
        conv_out = F.silu(conv_out)[:, None, :]
        new_conv_state = window[:, 1:]
    else:
        conv_out = _causal_conv(xbcd, p["conv_w"], p["conv_b"])
        new_conv_state = F.pad(
            xbcd, (0, 0, max(0, K - 1 - S), 0))[:, -(K - 1):]

    xs, Bm, Cm = torch.split(conv_out, [din, N, N], dim=-1)
    xs = xs.reshape(Bsz, -1, H, P)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = torch.exp(p["A_log"])                                    # positive

    if single_step:
        # recurrent update: state' = exp(-dt A) state + dt * x B^T
        decay = torch.exp(-dt[:, 0, :] * A[None, :])             # [B,H]
        upd = torch.einsum("bh,bhp,bn->bhpn", dt[:, 0, :], xs[:, 0].float(),
                           Bm[:, 0].float())
        new_state = ssm_state * decay[:, :, None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(),
                         new_state)[:, None].to(x.dtype)         # [B,1,H,P]
    else:
        y, new_state = ssd_chunked(xs, dt, A, Bm, Cm, cfg.ssm_chunk,
                                   init_state=ssm_state)
    y = y + xs * p["D_skip"][None, None, :, None].to(x.dtype)
    y = y.reshape(Bsz, -1, din)
    y = L.rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"], new_conv_state, new_state


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Zeroed decode state: conv [L,batch,K-1,din+2N] in the model's type,
    ssm [L,batch,H,P,N] float32, pos [batch] (``max_seq`` sizes nothing:
    the state is O(1) in the sequence)."""
    dev = resolve_device(device)
    din, N = cfg.d_inner, cfg.ssm_state
    H, P, K = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_conv
    return {
        "conv": torch.zeros((cfg.n_layers, batch, K - 1, din + 2 * N),
                            dtype=cfg.torch_dtype, device=dev),
        "ssm": torch.zeros((cfg.n_layers, batch, H, P, N),
                           dtype=torch.float32, device=dev),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The full prompt ([B,S] int) through every layer, the SSD by the
    chunk-scan kernel (one launch per layer on the card).  Returns
    (last-token logits [B,V], cache) with pos [B] = S."""
    x = L.embed(tokens, params["embed"]).to(cfg.torch_dtype)
    B, S = tokens.shape
    convs, ssms = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = L.rms_norm(x, lp["norm"]["w"], cfg.norm_eps)
        y, conv_st, ssm_st = _block_inner(h, lp, cfg)
        x = x + y
        convs.append(conv_st)
        ssms.append(ssm_st)
    xl = L.rms_norm(x[:, -1:], params["final_norm"]["w"], cfg.norm_eps)
    logits = L.unembed(xl[:, 0], params["embed"], cfg)
    return logits, {"conv": torch.stack(convs), "ssm": torch.stack(ssms),
                    "pos": torch.full((B,), S, dtype=torch.int32,
                                      device=tokens.device)}


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                cache: dict) -> Tuple[torch.Tensor, dict]:
    """One token ([B] int) through the recurrence.  Returns (logits [B,V],
    a new cache with pos + 1)."""
    x = L.embed(token[:, None], params["embed"]).to(cfg.torch_dtype)
    convs, ssms = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = L.rms_norm(x, lp["norm"]["w"], cfg.norm_eps)
        y, conv_st, ssm_st = _block_inner(h, lp, cfg, cache["conv"][i],
                                          cache["ssm"][i], single_step=True)
        x = x + y
        convs.append(conv_st)
        ssms.append(ssm_st)
    x = L.rms_norm(x, params["final_norm"]["w"], cfg.norm_eps)
    logits = L.unembed(x[:, 0], params["embed"], cfg)
    return logits, {"conv": torch.stack(convs), "ssm": torch.stack(ssms),
                    "pos": cache["pos"] + 1}


def decode_chunk(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 valid_len: torch.Tensor, cache: dict
                 ) -> Tuple[torch.Tensor, dict]:
    """T tokens ([B,T]) as T masked single steps: token t advances
    sequence b iff ``t < valid_len[b]``; a masked-out step leaves that
    row's state and position untouched.  The recurrence is sequential, so
    unlike the attention families nothing fuses across the chunk; the
    engine's step is one call all the same.  Returns (logits [B,T,V],
    cache)."""
    valid_len = valid_len.to(tokens.device)
    logits = []
    for t in range(tokens.shape[1]):
        out, new = decode_step(params, cfg, tokens[:, t], cache)
        cache = L.mask_cache_rows(t < valid_len, new, cache)
        logits.append(out)
    return torch.stack(logits, dim=1), cache
