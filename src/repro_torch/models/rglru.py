"""RecurrentGemma / Griffin hybrid (arXiv:2402.19427), serving entry points.

The port of the JAX package's ``models/rglru.py`` for serving.  Layer
pattern (period 3): two recurrent blocks, then one local sliding-window
attention block.  A recurrent block is

    norm -> [branch A: linear -> causal conv(4) -> RG-LRU]
            [branch B: linear -> GeLU (tanh approximation)]
            A * B -> linear out, then the MLP sub-block

and the RG-LRU recurrence, per channel, with c = 8:

    r_t = sigmoid(W_a x_t + b_a),  i_t = sigmoid(W_x x_t + b_x)
    a_t = sigmoid(lam)^(c r_t)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

The gates run in float32 over the model's weights, as the reference's do.
A full sequence runs the recurrence through :func:`rglru_scan`, which is the
hand-written scan kernel on a CUDA tensor (``kernels/rglru_scan``) and its
plain version on a CPU tensor; the reference's associative scan computes
the same recurrence in another order.  Its attention goes through the
flash kernel (prefill) and the ring kernel (decode), as the dense family's
does.  Decode keeps O(1) state per recurrent layer (a conv window and h)
and a ring of the last ``sliding_window`` K/V per attention layer.

Parameters keep the reference's tree: ``rec_layers`` and ``att_layers``
stacked over their own layers; the layers run in model order, so the
cache's conv and h rows are the recurrent layers in order (the reference's
``g*rpg + j`` for group g, slot j, then the tail).  ``decode_step`` returns
a new cache, as the reference does (the engine's masked step keeps the old
rows of masked-out slots); ``decode_chunk`` updates the given K/V in place.
``forward`` and the loss are training (ROADMAP.md A14).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from ..kernels.rglru_scan.ops import rglru_scan as _scan_kernel
from . import layers as L
from .transformer import _layer, _normal

_C_RGLRU = 8.0


# ----------------------------------------------------------------- RG-LRU
def _rglru_gates(x: torch.Tensor, p: dict
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (log_a [B,S,W] <= 0, gated input [B,S,W]), float32."""
    xf = x.float()
    r = torch.sigmoid(xf @ p["w_a"].float() + p["b_a"].float())
    i = torch.sigmoid(xf @ p["w_x"].float() + p["b_x"].float())
    log_a = _C_RGLRU * r * F.logsigmoid(p["lam"])[None, None, :]
    a2 = torch.exp(2.0 * log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * xf)
    return log_a, gated


def rglru_scan(x: torch.Tensor, p: dict, h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence RG-LRU.  x [B,S,W]; h0 [B,W] float32 or None.  Returns
    (y [B,S,W] in x's type, the final state [B,W] float32)."""
    log_a, gated = _rglru_gates(x, p)
    h, h_last = _scan_kernel(torch.exp(log_a), gated, h0)
    return h.to(x.dtype), h_last


def rglru_step(x: torch.Tensor, p: dict, h: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token update.  x [B,1,W], h [B,W] float32."""
    log_a, gated = _rglru_gates(x, p)
    h_new = torch.exp(log_a[:, 0]) * h + gated[:, 0]
    return h_new.to(x.dtype)[:, None, :], h_new


# -------------------------------------------------------- recurrent block
def _conv_step(x: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token causal conv through the window state [B, K-1, W]."""
    window = torch.cat([conv_state, x], dim=1)
    out = torch.einsum("bkc,kc->bc", window, w) + b
    return out[:, None, :], window[:, 1:]


def recurrent_block(x: torch.Tensor, p: dict, cfg: ModelConfig,
                    conv_state: Optional[torch.Tensor] = None,
                    h_state: Optional[torch.Tensor] = None,
                    single_step: bool = False):
    """Returns (x_out, new_conv_state, new_h_state)."""
    h = L.rms_norm(x, p["norm"]["w"], cfg.norm_eps)
    rnn_in = h @ p["w_rnn_in"]
    gate = F.gelu(h @ p["w_gate_in"], approximate="tanh")
    if single_step:
        conv_out, new_conv = _conv_step(rnn_in, conv_state, p["conv_w"],
                                        p["conv_b"])
        y, new_h = rglru_step(conv_out, p["rglru"], h_state)
    else:
        K, S = p["conv_w"].shape[0], rnn_in.shape[1]
        xp = F.pad(rnn_in, (0, 0, K - 1, 0))
        conv_out = sum(xp[:, i:i + S, :] * p["conv_w"][i] for i in range(K))
        conv_out = conv_out + p["conv_b"]
        y, new_h = rglru_scan(conv_out, p["rglru"], h0=h_state)
        new_conv = F.pad(rnn_in, (0, 0, max(0, K - 1 - S), 0))[:, -(K - 1):]
    x = x + (y * gate) @ p["w_out"]
    h2 = L.rms_norm(x, p["mlp_norm"]["w"], cfg.norm_eps)
    return x + L.mlp_block(h2, p["mlp"], cfg), new_conv, new_h


# ------------------------------------------------------------ full model
def _layer_kinds(cfg: ModelConfig) -> List[str]:
    """'r' or 'a' per layer: every ``hybrid_period``-th layer (1-based) is
    attention."""
    period = cfg.hybrid_period
    return ["a" if (i + 1) % period == 0 else "r"
            for i in range(cfg.n_layers)]


def _group_layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(rec_per_group, n_groups, n_tail): the layers are n_groups x
    ((period - 1) rec + 1 attn), then n_tail trailing rec layers."""
    p = cfg.hybrid_period
    ng = cfg.n_layers // p
    return p - 1, ng, cfg.n_layers - ng * p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None) -> dict:
    """Random parameters with the tree, shapes, types and scales of the
    reference's ``rglru.init_params``; the draws come from ``generator``,
    which must live on ``device``.  ``lam`` is drawn as the paper (and the
    reference) draws it: logit(u), u uniform on (0.9, 0.999), so that
    a = sigmoid(lam) starts in that range."""
    dev = resolve_device(device)
    kinds = _layer_kinds(cfg)
    NR, NA = kinds.count("r"), kinds.count("a")
    D, Fd, V, K = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.ssm_conv
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    W = cfg.rglru_width or D
    dt = cfg.torch_dtype

    def s(a, b):
        return (2.0 / (a + b)) ** 0.5

    def n(shape, std):
        return _normal(shape, std, cfg, generator, dev)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def mlp(NL):
        s_in = s(D, Fd)
        return {"w_up": n((NL, D, Fd), s_in), "w_down": n((NL, Fd, D), s_in),
                "w_gate": n((NL, D, Fd), s_in)}

    u = torch.rand((NR, W), generator=generator, device=dev,
                   dtype=torch.float32) * (0.999 - 0.9) + 0.9
    attn = {"wq": n((NA, D, H, Dh), s(D, Dh)),
            "wk": n((NA, D, Hkv, Dh), s(D, Dh)),
            "wv": n((NA, D, Hkv, Dh), s(D, Dh)),
            "wo": n((NA, H, Dh, D), s(Dh, D))}
    if cfg.qk_norm:
        attn["q_norm"] = ones(NA, Dh)
        attn["k_norm"] = ones(NA, Dh)
    embed = {"tok": n((V, D), D ** -0.5)}
    if not cfg.tie_embeddings:
        embed["out"] = n((D, V), D ** -0.5)
    return {
        "embed": embed,
        "rec_layers": {
            "norm": {"w": ones(NR, D)},
            "w_rnn_in": n((NR, D, W), s(D, W)),
            "w_gate_in": n((NR, D, W), s(D, W)),
            "conv_w": n((NR, K, W), 0.2),
            "conv_b": zeros(NR, W),
            "rglru": {"w_a": n((NR, W, W), W ** -0.5), "b_a": zeros(NR, W),
                      "w_x": n((NR, W, W), W ** -0.5), "b_x": zeros(NR, W),
                      "lam": torch.log(u / (1 - u))},
            "w_out": n((NR, W, D), s(W, D)),
            "mlp_norm": {"w": ones(NR, D)},
            "mlp": mlp(NR),
        },
        "att_layers": {"attn_norm": {"w": ones(NA, D)}, "attn": attn,
                       "mlp_norm": {"w": ones(NA, D)}, "mlp": mlp(NA)},
        "final_norm": {"w": ones(D)},
    }


def forward(*args, **kwargs):
    raise NotImplementedError(
        "the hybrid family's forward and loss are training, not ported yet "
        "(ROADMAP.md A14)")


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Zeroed decode state: conv [n_rec,batch,K-1,W] in the model's type, h
    [n_rec,batch,W] float32, k/v [n_att,batch,C,Hkv,Dh] with C =
    min(window, max_seq) (a ring), pos [batch]."""
    dev = resolve_device(device)
    kinds = _layer_kinds(cfg)
    W = cfg.rglru_width or cfg.d_model
    C = min(cfg.sliding_window or max_seq, max_seq)
    dt = cfg.torch_dtype
    kv = (kinds.count("a"), batch, C, cfg.n_kv_heads, cfg.head_dim_)
    return {
        "conv": torch.zeros((kinds.count("r"), batch, cfg.ssm_conv - 1, W),
                            dtype=dt, device=dev),
        "h": torch.zeros((kinds.count("r"), batch, W), dtype=torch.float32,
                         device=dev),
        "k": torch.zeros(kv, dtype=dt, device=dev),
        "v": torch.zeros(kv, dtype=dt, device=dev),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def _stack(rows: List[torch.Tensor], empty: Tuple[int, ...],
           dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The layers' rows stacked; a [0, ...] tensor when there are none."""
    if rows:
        return torch.stack(rows)
    return torch.zeros((0,) + empty, dtype=dtype, device=device)


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            pad_cache_to: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The full prompt ([B,S] int) through every layer: the recurrence by
    the scan kernel, the local attention by the flash kernel (one launch of
    each per layer on the card).  Returns (last-token logits [B,V], cache)
    with pos [B] = S; the K/V rings hold the last C = min(S, window)
    positions, ring-aligned (slot = pos % C), grown to ``pad_cache_to``
    (never past the window)."""
    x = L.embed(tokens, params["embed"]).to(cfg.torch_dtype)
    B, S = tokens.shape
    dev = tokens.device
    positions = torch.arange(S, device=dev)[None, :]
    Wn = cfg.sliding_window
    C = min(S, Wn) if Wn else S
    n_rep = cfg.n_heads // cfg.n_kv_heads
    scale = cfg.head_dim_ ** -0.5
    convs, hs, ks, vs = [], [], [], []
    for kind in _layer_kinds(cfg):
        if kind == "r":
            rp = _layer(params["rec_layers"], len(convs))
            x, conv_st, h_st = recurrent_block(x, rp, cfg)
            convs.append(conv_st)
            hs.append(h_st)
            continue
        ap = _layer(params["att_layers"], len(ks))
        h = L.rms_norm(x, ap["attn_norm"]["w"], cfg.norm_eps)
        q, k, v = L.attention_qkv(h, ap["attn"], cfg, positions)
        o = L.full_attention(q, L.repeat_kv(k, n_rep), L.repeat_kv(v, n_rep),
                             causal=True, window=Wn, scale=scale)
        x = x + torch.einsum("bshk,hkd->bsd", o, ap["attn"]["wo"])
        h = L.rms_norm(x, ap["mlp_norm"]["w"], cfg.norm_eps)
        x = x + L.mlp_block(h, ap["mlp"], cfg)
        # keep the last C positions, ring-aligned so that slot = pos % C
        kc, vc = k[:, S - C:], v[:, S - C:]
        if Wn:
            kc = torch.roll(kc, S % C, dims=1)
            vc = torch.roll(vc, S % C, dims=1)
        ks.append(kc)
        vs.append(vc)
    x = L.rms_norm(x[:, -1:], params["final_norm"]["w"], cfg.norm_eps)
    logits = L.unembed(x[:, 0], params["embed"], cfg)
    W = cfg.rglru_width or cfg.d_model
    dt = cfg.torch_dtype
    kv_row = (B, C, cfg.n_kv_heads, cfg.head_dim_)
    k_all, v_all = L.pad_cache_seq(_stack(ks, kv_row, dt, dev),
                                   _stack(vs, kv_row, dt, dev), C, Wn,
                                   pad_cache_to)
    cache = {"conv": _stack(convs, (B, cfg.ssm_conv - 1, W), dt, dev),
             "h": _stack(hs, (B, W), torch.float32, dev),
             "k": k_all, "v": v_all,
             "pos": torch.full((B,), S, dtype=torch.int32, device=dev)}
    return logits, cache


def _step(params: dict, cfg: ModelConfig, token: torch.Tensor, cache: dict,
          keep: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, dict]:
    """One token ([B] int) through every layer; the attention layers write
    their K/V into the cache's rings in place and attend through
    :func:`layers.decode_attention` (the ring kernel on the card).  With
    ``keep`` [B] bool, a row where it is False gets its ring slot back
    after the attention: its logits are those of the full step, its K/V
    ring is as it was.  Returns (logits [B,V], {conv, h: new; k, v: the
    cache's; pos + 1})."""
    B = token.shape[0]
    dev = token.device
    pos = cache["pos"].to(device=dev, dtype=torch.int32).expand(B)
    x = L.embed(token[:, None], params["embed"]).to(cfg.torch_dtype)
    positions = pos[:, None]
    Wn = cfg.sliding_window
    rows = torch.arange(B, device=dev)
    convs, hs = [], []
    ai = 0
    for kind in _layer_kinds(cfg):
        if kind == "r":
            ri = len(convs)
            x, conv_st, h_st = recurrent_block(
                x, _layer(params["rec_layers"], ri), cfg,
                conv_state=cache["conv"][ri], h_state=cache["h"][ri],
                single_step=True)
            convs.append(conv_st)
            hs.append(h_st)
            continue
        ap = _layer(params["att_layers"], ai)
        h = L.rms_norm(x, ap["attn_norm"]["w"], cfg.norm_eps)
        q, k, v = L.attention_qkv(h, ap["attn"], cfg, positions)
        ck, cv = cache["k"][ai], cache["v"][ai]
        if keep is not None:
            slot = L._cache_slots(pos.long(), ck.shape[1], Wn)
            old_k, old_v = ck[rows, slot], cv[rows, slot]
        L.kv_cache_update(ck, cv, k, v, pos, Wn)
        o = L.decode_attention(q, ck, cv, pos, cfg, window=Wn)
        if keep is not None:
            m = keep[:, None, None]
            ck[rows, slot] = torch.where(m, ck[rows, slot], old_k)
            cv[rows, slot] = torch.where(m, cv[rows, slot], old_v)
        x = x + torch.einsum("bshk,hkd->bsd", o, ap["attn"]["wo"])
        h = L.rms_norm(x, ap["mlp_norm"]["w"], cfg.norm_eps)
        x = x + L.mlp_block(h, ap["mlp"], cfg)
        ai += 1
    x = L.rms_norm(x, params["final_norm"]["w"], cfg.norm_eps)
    logits = L.unembed(x[:, 0], params["embed"], cfg)
    W = cfg.rglru_width or cfg.d_model
    return logits, {
        "conv": _stack(convs, (B, cfg.ssm_conv - 1, W), cfg.torch_dtype, dev),
        "h": _stack(hs, (B, W), torch.float32, dev),
        "k": cache["k"], "v": cache["v"], "pos": pos + 1}


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                cache: dict) -> Tuple[torch.Tensor, dict]:
    """One token ([B] int) through the recurrence and the rings.  Returns
    (logits [B,V], a new cache with pos + 1); the given cache is left as it
    was."""
    cache = dict(cache, k=cache["k"].clone(), v=cache["v"].clone())
    return _step(params, cfg, token, cache)


def decode_chunk(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 valid_len: torch.Tensor, cache: dict
                 ) -> Tuple[torch.Tensor, dict]:
    """T tokens ([B,T]) as T masked single steps, as the reference runs
    them: token t advances sequence b iff ``t < valid_len[b]``; a
    masked-out step leaves that row's conv, h, K/V and position untouched.
    The cache's K/V are updated in place.  Returns (logits [B,T,V],
    cache)."""
    valid_len = valid_len.to(tokens.device)
    logits = []
    for t in range(tokens.shape[1]):
        keep = t < valid_len
        out, new = _step(params, cfg, tokens[:, t], cache, keep=keep)
        masked = L.mask_cache_rows(
            keep, {k: new[k] for k in ("conv", "h", "pos")}, cache)
        cache = dict(masked, k=new["k"], v=new["v"])
        logits.append(out)
    return torch.stack(logits, dim=1), cache
