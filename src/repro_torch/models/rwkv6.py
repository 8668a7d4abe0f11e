"""RWKV-6 "Finch", the serving path (the port of ``repro.models.rwkv6``):
time-mix with ddlerp token-shift LoRAs, data-dependent per-channel decay
``w_t``, a per-head WKV state, group norm and SiLU gate; channel-mix with
squared ReLU.

Per-layer weights are stacked on a leading ``layers`` axis and the
reference's ``lax.scan`` over layers is a Python loop over views of it. The
WKV recurrence of every prefill (S > 1) goes through
:func:`repro_torch.kernels.ops.wkv6`, the Hopper kernel on the card, on any
S; the reference takes its Pallas kernel only at S % 64 == 0, and its
chunked XLA form asserts the same (ROADMAP H4). Decode steps the recurrence
one token in plain PyTorch (:func:`wkv6_step`), as it is XLA in the
reference, and writes its states into the cache in place. LayerNorms are
plain PyTorch, as in the reference.

Training (:func:`rwkv_loss`) runs each block under ``cfg.remat``; the WKV
forward is still the kernel, and its gradient recomputes
:func:`wkv6_chunked`, the reference's chunked form, which takes S % 64 == 0
(or S < 64).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from torch.utils.checkpoint import checkpoint

from .common import ParamDef, cross_entropy, layer_norm, map_defs, torch_dtype
from .config import ArchConfig
from .transformer import _stack, embed_tokens, layer_params, remat_wrap, unembed

# ---------------------------------------------------------------------------
# WKV recurrence: the chunked form (the gradient's path) and one token (decode)
# ---------------------------------------------------------------------------


def _wkv6_chunk(s, rb, kb, vb, wb, uf):
    """One chunk of C tokens from state s (B, H, dk, dv): (y (B, H, C, dv),
    the state after the chunk), all in f32."""
    C = rb.shape[2]
    logw = torch.log(torch.clamp(wb, min=1e-38))  # w ∈ (0, 1)
    lc = torch.cumsum(logw, dim=2)  # inclusive log-cumsum (B, H, C, dk)
    lc_excl = lc - logw
    # in-chunk pairs: A[t, s] = Σ_i r_t,i k_s,i e^{lc_excl_t - lc_s}, s < t
    ratio = torch.exp(lc_excl[:, :, :, None, :] - lc[:, :, None, :, :])  # (B, H, C, C, dk)
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=rb.device), diagonal=-1)[None, None, :, :, None]
    ratio = torch.where(tri, ratio, 0.0)
    A = torch.einsum("bhti,bhtsi,bhsi->bhts", rb, ratio, kb)
    # the bonus diagonal: y_t += (r_t · u ⊙ k_t) v_t
    diag = torch.einsum("bhti,bhti->bht", rb * uf[None, :, None, :], kb)
    y = torch.einsum("bhts,bhsv->bhtv", A, vb) + diag[..., None] * vb
    # across chunks: y_t += (r_t ⊙ e^{lc_excl_t}) S
    y = y + torch.einsum("bhti,bhiv->bhtv", rb * torch.exp(lc_excl), s)
    # S' = e^{lc_C} ⊙ S + Σ_s (e^{lc_C - lc_s} ⊙ k_s) v_s
    k_scaled = kb * torch.exp(lc[:, :, -1:, :] - lc)
    s_new = torch.exp(lc[:, :, -1, :])[..., None] * s + torch.einsum("bhsi,bhsv->bhiv", k_scaled, vb)
    return y, s_new


def wkv6_chunked(r, k, v, w, u, s0, chunk: int = 64):
    """The reference's chunked WKV form, differentiable by autograd. r, k, w:
    (B, H, T, dk); v: (B, H, T, dv); u: (H, dk); s0: (B, H, dk, dv). T must be
    a multiple of min(chunk, T). Within a chunk of C tokens every pairwise
    decay ratio e^{lc_excl_t - lc_s} (s < t, at most 1) is a (C, C, dk)
    tensor; each chunk runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint(step)``), so the backward recomputes that tensor rather
    than keep one per chunk. Returns (y (B, H, T, dv) in r's dtype, S_final
    f32); every sum in f32."""
    B, H, T, dk = r.shape
    dv = v.shape[-1]
    C = min(chunk, T)
    if T % C:
        raise ValueError(f"wkv6_chunked: T = {T} is not a multiple of the chunk {C}")
    rc, kc, vc, wc = (x.float().reshape(B, H, T // C, C, x.shape[-1]) for x in (r, k, v, w))
    uf = u.float()
    s = s0.float()
    ys = []
    for i in range(T // C):
        y, s = checkpoint(_wkv6_chunk, s, rc[:, :, i], kc[:, :, i], vc[:, :, i], wc[:, :, i], uf,
                          use_reentrant=False)
        ys.append(y)
    return torch.stack(ys, dim=2).reshape(B, H, T, dv).to(r.dtype), s


def wkv6_step(r, k, v, w, u, s):
    """Single-token recurrence in f32. r, k, w: (B, H, dk); v: (B, H, dv);
    u: (H, dk); s: (B, H, dk, dv) f32. Returns (y (B, H, dv) f32, s_new)."""
    r, k, v, w = (x.float() for x in (r, k, v, w))
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhi,bhiv->bhv", r, s + u.float()[None, :, :, None] * kv)
    return y, w[..., None] * s + kv


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


def rwkv_layer_defs(cfg: ArchConfig, pdt) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    H = cfg.d_model // cfg.rwkv_head_size
    dk = cfg.rwkv_head_size
    r, dr = cfg.rwkv_lora_rank, cfg.rwkv_decay_lora
    return {
        "ln1_w": ParamDef((D,), (None,), pdt, "ones"),
        "ln1_b": ParamDef((D,), (None,), pdt, "zeros"),
        "ln2_w": ParamDef((D,), (None,), pdt, "ones"),
        "ln2_b": ParamDef((D,), (None,), pdt, "zeros"),
        "tm": {
            "mu_x": ParamDef((D,), (None,), pdt, "zeros"),
            "mu_rkvgw": ParamDef((5, D), (None, None), pdt, "zeros"),
            "maa_w1": ParamDef((D, 5 * r), ("embed", None), pdt, scale=0.1),
            "maa_w2": ParamDef((5, r, D), (None, None, "embed"), pdt, scale=0.1),
            "w0": ParamDef((D,), (None,), pdt, "constant", scale=-6.0),
            "ww1": ParamDef((D, dr), ("embed", None), pdt, scale=0.1),
            "ww2": ParamDef((dr, D), (None, "embed"), pdt, scale=0.1),
            "u": ParamDef((H, dk), ("heads", None), pdt, "zeros"),
            "wr": ParamDef((D, D), ("embed", "heads"), pdt),
            "wk": ParamDef((D, D), ("embed", "heads"), pdt),
            "wv": ParamDef((D, D), ("embed", "heads"), pdt),
            "wg": ParamDef((D, D), ("embed", "heads"), pdt),
            "wo": ParamDef((D, D), ("heads", "embed"), pdt),
            "gn_w": ParamDef((D,), (None,), pdt, "ones"),
            "gn_b": ParamDef((D,), (None,), pdt, "zeros"),
        },
        "cm": {
            "mu_k": ParamDef((D,), (None,), pdt, "zeros"),
            "mu_r": ParamDef((D,), (None,), pdt, "zeros"),
            "wk": ParamDef((D, F_), ("embed", "ff"), pdt),
            "wv": ParamDef((F_, D), ("ff", "embed"), pdt),
            "wr": ParamDef((D, D), ("embed", None), pdt),
        },
    }


def rwkv_param_defs(cfg: ArchConfig) -> dict:
    pdt = torch_dtype(cfg.param_dtype)
    V, D, L = cfg.vocab_size, cfg.d_model, cfg.n_layers
    return {
        "embed": ParamDef((V, D), ("vocab", "embed"), pdt),
        "ln0_w": ParamDef((D,), (None,), pdt, "ones"),
        "ln0_b": ParamDef((D,), (None,), pdt, "zeros"),
        "blocks": map_defs(lambda d: _stack(L, d), rwkv_layer_defs(cfg, pdt)),
        "final_ln_w": ParamDef((D,), (None,), pdt, "ones"),
        "final_ln_b": ParamDef((D,), (None,), pdt, "zeros"),
        "unembed": ParamDef((D, V), ("embed", "vocab"), pdt),
    }


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _shifted(x, shift_state):
    """The previous token's x for every position: ``shift_state`` (B, D), or
    zeros, before the first."""
    if shift_state is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([shift_state[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _ddlerp(p, x, sx):
    """Data-dependent token-shift interpolation → (xw, xk, xv, xr, xg)."""
    dt = x.dtype
    r5 = p["maa_w1"].shape[1] // 5
    base = x + sx * p["mu_x"].to(dt)
    lora = torch.tanh(torch.einsum("bsd,dr->bsr", base, p["maa_w1"].to(dt)))
    lora = lora.reshape(*lora.shape[:-1], 5, r5)
    delta = torch.einsum("bsir,ird->bsid", lora, p["maa_w2"].to(dt))  # (B,S,5,D)
    mixes = p["mu_rkvgw"].to(dt)[None, None] + delta
    return tuple(x + sx * mixes[:, :, i] for i in range(5))


def time_mix(p, x, cfg: ArchConfig, shift_state=None, wkv_state=None):
    """x: (B, S, D). Returns (y, new shift state x[:, -1], new WKV state)."""
    dt = x.dtype
    B, S, D = x.shape
    dk = cfg.rwkv_head_size
    H = D // dk
    sx = _shifted(x, shift_state) - x
    xw, xk, xv, xr, xg = _ddlerp(p, x, sx)
    r = torch.einsum("bsd,de->bse", xr, p["wr"].to(dt))
    k = torch.einsum("bsd,de->bse", xk, p["wk"].to(dt))
    v = torch.einsum("bsd,de->bse", xv, p["wv"].to(dt))
    g = F.silu(torch.einsum("bsd,de->bse", xg, p["wg"].to(dt)))
    # data-dependent decay w_t ∈ (0,1): exp(-exp(w0 + lora(xw)))
    dlora = torch.einsum(
        "bsr,rd->bsd", torch.tanh(torch.einsum("bsd,dr->bsr", xw, p["ww1"].to(dt))), p["ww2"].to(dt)
    )
    w = torch.exp(-torch.exp(p["w0"].float() + dlora.float()))

    def heads(t):  # (B,S,D) → (B,H,S,dk)
        return t.reshape(B, S, H, dk).transpose(1, 2).contiguous()

    # w is rounded to the activation dtype before the recurrence, as in the reference
    r_h, k_h, v_h, w_h = heads(r), heads(k), heads(v), heads(w.to(dt))
    if wkv_state is None:
        wkv_state = torch.zeros((B, H, dk, dk), dtype=torch.float32, device=x.device)
    if S == 1:
        y, s_new = wkv6_step(r_h[:, :, 0], k_h[:, :, 0], v_h[:, :, 0], w_h[:, :, 0], p["u"], wkv_state)
        y = y[:, :, None]  # f32, as in the reference's decode
    else:
        y, s_new = ops.wkv6(r_h, k_h, v_h, w_h, p["u"], wkv_state.float().contiguous())
    y = y.transpose(1, 2).reshape(B, S, D)
    # per-head group norm in f32 (eps 64e-5), then the SiLU gate
    yh = y.reshape(B, S, H, dk).float()
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, unbiased=False)
    yh = (yh - mu) * torch.rsqrt(var + 64e-5)
    y = yh.reshape(B, S, D) * p["gn_w"].float() + p["gn_b"].float()
    y = y.to(dt) * g
    return torch.einsum("bsd,de->bse", y, p["wo"].to(dt)), x[:, -1], s_new


def channel_mix(p, x, shift_state=None):
    """Channel-mix with squared ReLU. Returns (y, new shift state x[:, -1])."""
    dt = x.dtype
    sx = _shifted(x, shift_state) - x
    xk = x + sx * p["mu_k"].to(dt)
    xr = x + sx * p["mu_r"].to(dt)
    k = torch.square(F.relu(torch.einsum("bsd,df->bsf", xk, p["wk"].to(dt))))
    kv = torch.einsum("bsf,fd->bsd", k, p["wv"].to(dt))
    return torch.sigmoid(torch.einsum("bsd,de->bse", xr, p["wr"].to(dt))) * kv, x[:, -1]


def rwkv_block(p, x, cfg: ArchConfig, cache=None):
    new_cache = {}
    tm_shift = cache["tm_shift"] if cache else None
    wkv = cache["wkv"] if cache else None
    cm_shift = cache["cm_shift"] if cache else None
    y, new_cache["tm_shift"], new_cache["wkv"] = time_mix(
        p["tm"], layer_norm(x, p["ln1_w"], p["ln1_b"]), cfg, tm_shift, wkv
    )
    x = x + y
    y, new_cache["cm_shift"] = channel_mix(p["cm"], layer_norm(x, p["ln2_w"], p["ln2_b"]), cm_shift)
    return x + y, new_cache


# ---------------------------------------------------------------------------
# Model-level entry points
# ---------------------------------------------------------------------------


def _rwkv_body(params, cfg: ArchConfig, tokens):
    """Embedding and blocks, each block under ``cfg.remat`` when autograd
    records (the reference's ``remat_wrap`` over its scan body): (h (B, S, D)
    before the final LayerNorm, the per-layer states stacked as
    :func:`rwkv_cache_defs`)."""
    h = embed_tokens(params, cfg, tokens)
    h = layer_norm(h, params["ln0_w"], params["ln0_b"])
    body = remat_wrap(lambda p, x: rwkv_block(p, x, cfg), cfg)
    caches = []
    for i in range(cfg.n_layers):
        h, c = body(layer_params(params["blocks"], i), h)
        caches.append(c)
    return h, {name: torch.stack([c[name] for c in caches]) for name in caches[0]}


def rwkv_forward(params, cfg: ArchConfig, tokens):
    """tokens: (B, S) int → logits (B, S, V)."""
    h, _ = _rwkv_body(params, cfg, tokens)
    return unembed(params, cfg, layer_norm(h, params["final_ln_w"], params["final_ln_b"]))


def rwkv_loss(params, cfg: ArchConfig, batch):
    """batch: {"tokens", "labels"} (B, S) int → (mean loss, {"ce", "accuracy"})."""
    return cross_entropy(rwkv_forward(params, cfg, batch["tokens"]), batch["labels"], z_loss=cfg.z_loss)


def rwkv_prefill(params, cfg: ArchConfig, tokens):
    """The reference's ``_rwkv_prefill``: (last-position logits (B, 1, V),
    cache). Only the last position is unembedded; LayerNorm and the unembed
    work row by row, so the logits are the same."""
    h, cache = _rwkv_body(params, cfg, tokens)
    h = layer_norm(h[:, -1:], params["final_ln_w"], params["final_ln_b"])
    return unembed(params, cfg, h), cache


def rwkv_cache_defs(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """O(1) recurrent state on the ``meta`` device, independent of the
    sequence length."""
    del max_seq
    D, L = cfg.d_model, cfg.n_layers
    dk = cfg.rwkv_head_size
    H = D // dk
    dt = torch_dtype(cfg.dtype)
    return {
        "tm_shift": torch.empty((L, batch, D), dtype=dt, device="meta"),
        "cm_shift": torch.empty((L, batch, D), dtype=dt, device="meta"),
        "wkv": torch.empty((L, batch, H, dk, dk), dtype=torch.float32, device="meta"),
    }


def rwkv_decode_step(params, cfg: ArchConfig, cache, tokens, pos):
    """One decode step. tokens: (B, 1) int; ``pos`` is unused (the state is
    position-free). Writes the new states into ``cache`` in place and returns
    (logits (B, 1, V), cache)."""
    del pos
    h = embed_tokens(params, cfg, tokens)
    h = layer_norm(h, params["ln0_w"], params["ln0_b"])
    for i in range(cfg.n_layers):
        layer_cache = {name: cache[name][i] for name in cache}
        h, new = rwkv_block(layer_params(params["blocks"], i), h, cfg, layer_cache)
        for name, leaf in new.items():
            cache[name][i].copy_(leaf)
    h = layer_norm(h, params["final_ln_w"], params["final_ln_b"])
    return unembed(params, cfg, h), cache
