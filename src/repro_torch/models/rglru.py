"""Griffin / RecurrentGemma, the serving path (the port of
``repro.models.rglru``): RG-LRU recurrent blocks and local attention, 1:2.

Layout, as in the reference: repeating (recurrent, recurrent, local-attn)
residual pairs grouped into "super-layers" stacked on a leading ``layers``
axis (``super`` → ``rec1``/``rec2``/``attn``), and a stacked ``tail`` of
recurrent pairs for the remainder (26 = 3·8 + 2). The reference's
``lax.scan`` over super-layers is a Python loop over views of that axis.

The RG-LRU recurrence of every prefill goes through
:func:`repro_torch.kernels.ops.lru_scan` (the Hopper kernel on the card; on
any T, where the reference takes its Pallas kernel only at T % 128 == 0),
every local attention through :func:`repro_torch.kernels.ops.attention` with
``window=cfg.window``, and every RMSNorm through
:func:`repro_torch.kernels.ops.rmsnorm`. Decode keeps O(1) state per
recurrent layer and a ring buffer of ``window`` slots per attention layer;
its one-token recurrence and attention are plain PyTorch, as they are XLA in
the reference. Decode writes the cache in place and takes a scalar ``pos``.

Training (:func:`griffin_loss`) runs each super-layer and each tail pair
under ``cfg.remat``. The forward still goes through the kernels; the
recurrence's gradient recomputes the reference's associative scan
(:func:`repro_torch.kernels.ops.lru_assoc`) and the local attention's
recomputes ``attention_chunked`` at KV chunks of min(attn_chunk, window), as
the reference's ``local_attention``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from .common import (
    ParamDef,
    apply_rope,
    attention_single_shot,
    cross_entropy,
    geglu,
    map_defs,
    rms_norm,
    torch_dtype,
)
from .config import ArchConfig
from .transformer import (
    _stack,
    block_defs,
    embed_tokens,
    gqa_attention,
    layer_params,
    mlp_defs,
    remat_wrap,
    unembed,
)

# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


def rec_pair_defs(cfg: ArchConfig, pdt) -> dict:
    D = cfg.d_model
    W = cfg.lru_width or cfg.d_model
    K = cfg.conv_width
    return {
        "ln1": ParamDef((D,), (None,), pdt, "ones"),
        "rec": {
            "w_gate": ParamDef((D, W), ("embed", "lru"), pdt),
            "w_in": ParamDef((D, W), ("embed", "lru"), pdt),
            "conv_w": ParamDef((W, K), ("lru", None), pdt, scale=0.5),
            "conv_b": ParamDef((W,), ("lru",), pdt, "zeros"),
            "a_gate_w": ParamDef((W,), ("lru",), pdt, "zeros"),
            "a_gate_b": ParamDef((W,), ("lru",), pdt, "zeros"),
            "in_gate_w": ParamDef((W,), ("lru",), pdt, "zeros"),
            "in_gate_b": ParamDef((W,), ("lru",), pdt, "zeros"),
            "lam": ParamDef((W,), ("lru",), pdt, "constant", scale=0.7),
            "w_out": ParamDef((W, D), ("lru", "embed"), pdt),
        },
        "ln2": ParamDef((D,), (None,), pdt, "ones"),
        "mlp": mlp_defs(cfg, pdt),
    }


def attn_pair_defs(cfg: ArchConfig, pdt) -> dict:
    """The dense block's layout: the same attention and MLP weights."""
    return block_defs(cfg, pdt)


def griffin_layout(cfg: ArchConfig) -> tuple[int, int]:
    """(n_super, n_tail_rec) for the (rec, rec, attn) pattern."""
    n_super = cfg.n_layers // 3
    return n_super, cfg.n_layers - 3 * n_super


def griffin_param_defs(cfg: ArchConfig) -> dict:
    pdt = torch_dtype(cfg.param_dtype)
    V, D = cfg.vocab_size, cfg.d_model
    n_super, tail = griffin_layout(cfg)

    def stack(n, tree):
        return map_defs(lambda d: _stack(n, d), tree)

    defs = {
        "embed": ParamDef((V, D), ("vocab", "embed"), pdt),
        "super": {
            "rec1": stack(n_super, rec_pair_defs(cfg, pdt)),
            "rec2": stack(n_super, rec_pair_defs(cfg, pdt)),
            "attn": stack(n_super, attn_pair_defs(cfg, pdt)),
        },
        "final_ln": ParamDef((D,), (None,), pdt, "ones"),
    }
    if tail:
        defs["tail"] = stack(tail, rec_pair_defs(cfg, pdt))
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((D, V), ("embed", "vocab"), pdt)
    return defs


# ---------------------------------------------------------------------------
# RG-LRU + causal conv
# ---------------------------------------------------------------------------

_LRU_C = 8.0


def rglru_coeffs(p, xb):
    """(a, b) of the recurrence h_t = a_t ⊙ h_{t-1} + b_t, in f32."""
    x = xb.float()
    r = torch.sigmoid(x * p["a_gate_w"].float() + p["a_gate_b"].float())
    i = torch.sigmoid(x * p["in_gate_w"].float() + p["in_gate_b"].float())
    lam = p["lam"].float()
    log_a = -_LRU_C * torch.logaddexp(lam, torch.zeros_like(lam)) * r  # softplus, as jax's
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * x)
    return a, b


def rglru_scan(p, xb, h0=None):
    """xb: (B, S, W) conv output. Returns (h (B, S, W) in xb's dtype, h_last f32).
    The recurrence runs in :func:`ops.lru_scan` from h0, zeros when not given."""
    a, b = rglru_coeffs(p, xb)
    if h0 is None:
        h0 = torch.zeros(a[:, 0].shape, dtype=torch.float32, device=a.device)
    h, h_last = ops.lru_scan(a.contiguous(), b.contiguous(), h0.float().contiguous())
    return h.to(xb.dtype), h_last


def rglru_step(p, xb, h):
    """xb: (B, W) one token; h: (B, W) f32 state."""
    a, b = rglru_coeffs(p, xb[:, None])
    h_new = a[:, 0] * h + b[:, 0]
    return h_new.to(xb.dtype), h_new


def causal_conv(p, xb, state=None):
    """Depthwise causal conv of width K in the activation dtype. state:
    (B, K-1, W) trailing inputs. Returns (out, the last K-1 inputs, the zero
    pad included)."""
    K = p["conv_w"].shape[1]
    S = xb.shape[1]
    if state is None:
        x = F.pad(xb, (0, 0, K - 1, 0))
    else:
        x = torch.cat([state.to(xb.dtype), xb], dim=1)
    w = p["conv_w"].to(xb.dtype)
    out = 0
    for i in range(K):
        out = out + x[:, i : i + S] * w[:, i]
    return out + p["conv_b"].to(xb.dtype), x[:, -(K - 1) :]


def rec_temporal(p, x, cfg: ArchConfig, cache=None):
    """Griffin recurrent temporal block. Returns (y, {"conv", "h"})."""
    dt = x.dtype
    gate = F.gelu(torch.einsum("bsd,dw->bsw", x, p["w_gate"].to(dt)), approximate="tanh")
    xb = torch.einsum("bsd,dw->bsw", x, p["w_in"].to(dt))
    conv_state = cache["conv"] if cache else None
    h0 = cache["h"] if cache else None
    xb, conv_tail = causal_conv(p, xb, conv_state)
    if x.shape[1] == 1 and cache is not None:
        h_seq, h_last = rglru_step(p, xb[:, 0], h0)
        h_seq = h_seq[:, None]
    else:
        h_seq, h_last = rglru_scan(p, xb, h0)
    y = torch.einsum("bsw,wd->bsd", gate * h_seq, p["w_out"].to(dt))
    return y, {"conv": conv_tail, "h": h_last}


# ---------------------------------------------------------------------------
# Local attention with ring-buffer cache
# ---------------------------------------------------------------------------


def local_attention(p, x, cfg: ArchConfig, positions):
    """Windowed causal attention (``cfg.attention == "local"``): the dense
    block's attention, through :func:`ops.attention` with ``window=cfg.window``.
    Returns (y, k, v) with compact, roped (B, Hkv, S, hd) K/V."""
    y, kv = gqa_attention(p, x, cfg, positions, collect=True)
    return y, kv["k"], kv["v"]


def attn_ring_decode(p, cache, x, cfg: ArchConfig, pos):
    """One-token local attention over a ring buffer of ``window`` slots.
    Writes the new K/V and position into slot ``pos % window`` of ``cache``
    (k, v: (B, Hkv, W, hd); pos: (W,) int32) in place."""
    dt = x.dtype
    W = cfg.window
    q = torch.einsum("bsd,dhk->bhsk", x, p["wq"].to(dt))
    k_new = torch.einsum("bsd,dhk->bhsk", x, p["wk"].to(dt))
    v_new = torch.einsum("bsd,dhk->bhsk", x, p["wv"].to(dt))
    pos = torch.as_tensor(pos, device=x.device)
    positions = pos.reshape(1)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)  # roped at write time
    slot = (pos % W).reshape(1).long()
    k = cache["k"].index_copy_(2, slot, k_new.to(cache["k"].dtype))
    v = cache["v"].index_copy_(2, slot, v_new.to(cache["v"].dtype))
    pos_buf = cache["pos"].index_copy_(0, slot, positions.to(cache["pos"].dtype))
    valid = (pos_buf >= 0) & (pos_buf <= pos) & (pos_buf > pos - W)
    out = attention_single_shot(q, k, v, mask=valid[None, None, None, None, :], logit_cap=cfg.logit_cap)
    y = torch.einsum("bhsk,hkd->bsd", out, p["wo"].to(dt))
    return y, {"k": k, "v": v, "pos": pos_buf}


# ---------------------------------------------------------------------------
# Pairs
# ---------------------------------------------------------------------------


def _mlp(p, x):
    m = p["mlp"]
    return x + geglu(rms_norm(x, p["ln2"]), m["wg"], m["wi"], m["wo"], x.dtype)


def rec_pair(p, x, cfg: ArchConfig, cache=None):
    y, new_cache = rec_temporal(p["rec"], rms_norm(x, p["ln1"]), cfg, cache)
    return _mlp(p, x + y), new_cache


def attn_pair(p, x, cfg: ArchConfig, positions):
    y, k, v = local_attention(p["attn"], rms_norm(x, p["ln1"]), cfg, positions)
    return _mlp(p, x + y), (k, v)


def attn_pair_decode(p, x, cfg: ArchConfig, cache, pos):
    y, new_cache = attn_ring_decode(p["attn"], cache, rms_norm(x, p["ln1"]), cfg, pos)
    return _mlp(p, x + y), new_cache


# ---------------------------------------------------------------------------
# Model-level entry points
# ---------------------------------------------------------------------------


def _layers(params):
    """(super-layer params per index, tail pair params per index)."""
    n_super = params["super"]["rec1"]["ln1"].shape[0]
    supers = [layer_params(params["super"], i) for i in range(n_super)]
    tail = params.get("tail")
    tails = [layer_params(tail, i) for i in range(tail["ln1"].shape[0])] if tail else []
    return supers, tails


def _griffin_body(params, cfg: ArchConfig, tokens):
    """Embedding and all pairs, each super-layer and each tail pair under
    ``cfg.remat`` when autograd records (the reference's ``remat_wrap`` over
    its two scan bodies): (h (B, S, D) before the final norm, the recurrent
    states of rec1, rec2 and tail, and each attention layer's full-sequence
    K and V)."""
    h = embed_tokens(params, cfg, tokens)
    positions = torch.arange(h.shape[1], device=h.device)
    supers, tails = _layers(params)

    def super_body(p, h):
        h, c1 = rec_pair(p["rec1"], h, cfg)
        h, c2 = rec_pair(p["rec2"], h, cfg)
        h, kv = attn_pair(p["attn"], h, cfg, positions)
        return h, c1, c2, kv

    super_body = remat_wrap(super_body, cfg)
    tail_body = remat_wrap(lambda p, h: rec_pair(p, h, cfg), cfg)
    states = {"rec1": [], "rec2": [], "tail": []}
    ks, vs = [], []
    for p in supers:
        h, c1, c2, (k, v) = super_body(p, h)
        states["rec1"].append(c1)
        states["rec2"].append(c2)
        ks.append(k)
        vs.append(v)
    for p in tails:
        h, c = tail_body(p, h)
        states["tail"].append(c)
    return h, states, ks, vs


def griffin_forward(params, cfg: ArchConfig, tokens):
    """tokens: (B, S) int → logits (B, S, V)."""
    h, _, _, _ = _griffin_body(params, cfg, tokens)
    return unembed(params, cfg, rms_norm(h, params["final_ln"]))


def griffin_loss(params, cfg: ArchConfig, batch):
    """batch: {"tokens", "labels"} (B, S) int → (mean loss, {"ce", "accuracy"})."""
    return cross_entropy(griffin_forward(params, cfg, batch["tokens"]), batch["labels"], z_loss=cfg.z_loss)


def griffin_prefill(params, cfg: ArchConfig, tokens):
    """Prefill: full forward collecting recurrent states and local-attention
    ring buffers (the last ``window`` keys/values, ring-ordered). Returns
    (last-position logits (B, 1, V), cache as :func:`griffin_cache_defs`)."""
    h, states, ks, vs = _griffin_body(params, cfg, tokens)
    cache = {name: {leaf: torch.stack([c[leaf] for c in cs]) for leaf in ("conv", "h")}
             for name, cs in states.items() if cs}
    cache["attn"] = _ring_from_full(torch.stack(ks), torch.stack(vs), cfg, tokens.shape[1])
    h = rms_norm(h[:, -1:].contiguous(), params["final_ln"])
    return unembed(params, cfg, h), cache


def _ring_from_full(ks, vs, cfg: ArchConfig, S: int) -> dict:
    """(n_super, B, Hkv, S, hd) full-sequence K/V → ring buffers with position
    p at slot p % W; ``pos`` is -1 in the slots no position filled (S < W)."""
    W = cfg.window
    n_super = ks.shape[0]
    if S >= W:
        last_pos = np.arange(S - W, S)
        order = torch.from_numpy(np.argsort(last_pos % W)).to(ks.device)
        k_ring = ks[..., -W:, :].index_select(-2, order)
        v_ring = vs[..., -W:, :].index_select(-2, order)
        pos_buf = torch.from_numpy(last_pos).to(ks.device)[order]
    else:
        pad = W - S
        k_ring = F.pad(ks, (0, 0, 0, pad))
        v_ring = F.pad(vs, (0, 0, 0, pad))
        pos_buf = torch.cat([torch.arange(S), torch.full((pad,), -1)]).to(ks.device)
    return {
        "k": k_ring,
        "v": v_ring,
        "pos": pos_buf.to(torch.int32).expand(n_super, W).contiguous(),
    }


def griffin_cache_defs(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """O(window + lru_width) state on the ``meta`` device, independent of the
    sequence length."""
    del max_seq  # decode state does not grow with context
    n_super, tail = griffin_layout(cfg)
    W = cfg.lru_width or cfg.d_model
    K = cfg.conv_width
    hd = cfg.resolved_head_dim
    dt = torch_dtype(cfg.dtype)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def rec(n):
        return {"conv": meta((n, batch, K - 1, W), dt), "h": meta((n, batch, W), torch.float32)}

    kv = (n_super, batch, cfg.n_kv_heads, cfg.window, hd)
    out = {
        "rec1": rec(n_super),
        "rec2": rec(n_super),
        "attn": {"k": meta(kv, dt), "v": meta(kv, dt), "pos": meta((n_super, cfg.window), torch.int32)},
    }
    if tail:
        out["tail"] = rec(tail)
    return out


def _write_rec(cache: dict, i: int, new: dict) -> None:
    cache["conv"][i].copy_(new["conv"])
    cache["h"][i].copy_(new["h"])


def griffin_decode_step(params, cfg: ArchConfig, cache, tokens, pos):
    """One decode step. tokens: (B, 1) int; pos: scalar. Writes the step's
    states and K/V into ``cache`` in place and returns (logits (B, 1, V), cache)."""
    h = embed_tokens(params, cfg, tokens)
    pos = torch.as_tensor(pos, device=h.device).long()  # one host-to-device copy per step
    supers, tails = _layers(params)
    for i, p in enumerate(supers):
        for name in ("rec1", "rec2"):
            h, new = rec_pair(p[name], h, cfg, layer_params(cache[name], i))
            _write_rec(cache[name], i, new)
        h, _ = attn_pair_decode(p["attn"], h, cfg, layer_params(cache["attn"], i), pos)
    for i, p in enumerate(tails):
        h, new = rec_pair(p, h, cfg, layer_params(cache["tail"], i))
        _write_rec(cache["tail"], i, new)
    h = rms_norm(h, params["final_ln"])
    return unembed(params, cfg, h), cache
