"""Mixture-of-Experts family (the port of ``repro.models.moe``): DeepSeek-MoE
and Kimi-K2, with fine-grained routed experts, shared experts and leading
dense layers; serving and training.

GShard-style capacity routing as in the reference: tokens are grouped
(``moe_group_tokens`` per group, groups spanning the rows of the batch in
row-major order), routed top-k with a per-expert capacity
``C = max(4, ceil(k·N/E · capacity_factor))`` per group, and picks past an
expert's capacity are dropped. The routing decision (softmax, top-k, gates,
capacity slots) goes through :func:`repro_torch.kernels.ops.moe_gating`: the
Hopper kernel on the card, its plain version on the CPU, on detached logits.

Training gives the router its gradient as the reference's ``top_k_routing``
does: the gates are the softmax gathered at the kernel's picks and
renormalised (the reference's ``jax.lax.top_k(probs)``), recomputed under
autograd when the logits require grad; the load-balance loss
E · mean_g Σ_e f_e·p_e takes p, the mean router probability, with its
gradient, and f, each expert's kept picks over the group's tokens, without;
only :func:`moe_forward` asks for it, so serving's routings skip it. Under
``torch.no_grad`` the kernel's own gates combine, so serving is unchanged by
training.

The reference dispatches and combines with one-hot (G, N, E, C) einsums, which
it chose for the wire cost of expert parallelism across TPU chips. On one card
the port moves rows by index instead: the same function (a one-hot with one 1
selects exactly, an empty slot is 0 in both), without the einsums' O(N·E·C·D)
work. :func:`top_k_routing` builds the dense dispatch and combine tensors for
the tests.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from .common import ParamDef, cross_entropy, map_defs, rms_norm, swiglu, torch_dtype
from .config import ArchConfig
from .transformer import (
    _stack,
    attn_defs,
    block_defs,
    embed_tokens,
    gqa_attention,
    gqa_decode_attn,
    layer_params,
    remat_wrap,
    unembed,
)

# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


def moe_ffn_defs(cfg: ArchConfig, pdt) -> dict:
    D, E, Fm = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    defs = {
        "router": ParamDef((D, E), ("embed", None), pdt, scale=0.1),
        "wg": ParamDef((E, D, Fm), ("experts", "embed", None), pdt),
        "wi": ParamDef((E, D, Fm), ("experts", "embed", None), pdt),
        "wo": ParamDef((E, Fm, D), ("experts", None, "embed"), pdt),
    }
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * cfg.moe_d_ff
        defs["shared"] = {
            "wg": ParamDef((D, Fs), ("embed", "ff"), pdt),
            "wi": ParamDef((D, Fs), ("embed", "ff"), pdt),
            "wo": ParamDef((Fs, D), ("ff", "embed"), pdt),
        }
    return defs


def moe_block_defs(cfg: ArchConfig, pdt) -> dict:
    D = cfg.d_model
    return {
        "ln1": ParamDef((D,), (None,), pdt, "ones"),
        "attn": attn_defs(cfg, pdt),
        "ln2": ParamDef((D,), (None,), pdt, "ones"),
        "moe": moe_ffn_defs(cfg, pdt),
    }


def moe_param_defs(cfg: ArchConfig) -> dict:
    pdt = torch_dtype(cfg.param_dtype)
    V, D = cfg.vocab_size, cfg.d_model
    n_moe = cfg.n_layers - cfg.n_dense_layers
    defs = {
        "embed": ParamDef((V, D), ("vocab", "embed"), pdt),
        "moe_blocks": map_defs(lambda d: _stack(n_moe, d), moe_block_defs(cfg, pdt)),
        "final_ln": ParamDef((D,), (None,), pdt, "ones"),
        "unembed": ParamDef((D, V), ("embed", "vocab"), pdt),
    }
    if cfg.n_dense_layers:
        defs["dense_blocks"] = map_defs(lambda d: _stack(cfg.n_dense_layers, d), block_defs(cfg, pdt))
    return defs


# ---------------------------------------------------------------------------
# Routing + dispatch
# ---------------------------------------------------------------------------


def capacity(cfg: ArchConfig, tokens_per_group: int) -> int:
    c = math.ceil(cfg.top_k * tokens_per_group / cfg.n_experts * cfg.capacity_factor)
    return max(4, int(c))


def _aux_loss(logits, idx, kept):
    """The load-balance loss E · mean_g Σ_e f_e · p_e of one routing: f_e the
    fraction of the group's tokens whose pick of e was kept (no gradient), p_e
    the mean router probability of e (with its gradient). logits: (G, N, E)
    f32; idx, kept: (G, N, k)."""
    G, N, E = logits.shape
    f = torch.zeros((G, E), dtype=torch.float32, device=logits.device)
    f.scatter_add_(1, idx.reshape(G, -1).long(), kept.reshape(G, -1).float())
    p = torch.softmax(logits, dim=-1).mean(dim=1)
    return E * (f / N * p).sum(-1).mean()


def _routing(logits, cfg: ArchConfig, cap: int):
    """(idx, gate, pos) of one routing. The kernel decides on the detached
    logits; where they require grad the gates are recomputed from the softmax
    at its picks, renormalised by max(sum, 1e-9) (the reference's
    ``top_k(probs)`` and renormalisation; they differ from the kernel's by an
    f32 rounding)."""
    idx, gate, pos = ops.moe_gating(logits.detach(), top_k=cfg.top_k, capacity=cap)
    if torch.is_grad_enabled() and logits.requires_grad:
        gate = torch.softmax(logits, dim=-1).gather(-1, idx.long())
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return idx, gate, pos


def top_k_routing(logits, cfg: ArchConfig, cap: int):
    """GShard top-k with per-slot positions as the reference's dense tensors,
    from :func:`_routing`. logits: (G, N, E) f32.

    Returns dispatch (G, N, E, C) bool, combine (G, N, E, C) f32 and the
    load-balance auxiliary loss, as the reference.
    """
    G, N, E = logits.shape
    idx, gate, pos = _routing(logits, cfg, cap)
    g, n, j = (pos >= 0).nonzero(as_tuple=True)
    e, c = idx[g, n, j].long(), pos[g, n, j].long()
    dispatch = torch.zeros((G, N, E, cap), dtype=torch.bool, device=logits.device)
    combine = torch.zeros((G, N, E, cap), dtype=torch.float32, device=logits.device)
    dispatch[g, n, e, c] = True
    combine[g, n, e, c] = gate[g, n, j]  # a token picks an expert once: no slot is hit twice
    return dispatch, combine, _aux_loss(logits, idx, pos >= 0)


def _route(p, xg, cfg: ArchConfig, cap: int, aux: bool = False):
    """The routed experts over groups xg: (G, N, D) → ((G, N, D), the aux
    loss, or None unless ``aux`` asks for it: serving does not).

    Each kept pick (g, n, j) copies x[g, n] into slot pos of expert idx's
    buffer; the expert MLPs run as batched products over E; each token then
    sums gate_j · out[idx_j, g, pos_j] over its kept picks in f32 and rounds
    once to the activation dtype. Dropped picks write to one spare slot past
    the capacity, whose output the combine masks out, so that no step needs
    to know on the host how many picks were kept.
    """
    dt = torch_dtype(cfg.dtype)
    G, N, D = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = xg.float() @ p["router"].float()
    idx, gate, pos = _routing(logits, cfg, cap)
    idx, kept = idx.long(), pos >= 0
    slot = torch.where(kept, pos.long(), cap)
    groups = torch.arange(G, device=xg.device)[:, None, None]

    expert_in = xg.new_zeros((E, G, cap + 1, D))
    expert_in[idx, groups, slot] = xg[:, :, None, :]  # slots are unique per (g, e)
    rows = expert_in.reshape(E, G * (cap + 1), D)
    g = torch.bmm(rows, p["wg"].to(dt))
    h = torch.bmm(rows, p["wi"].to(dt))
    expert_out = torch.bmm(F.silu(g) * h, p["wo"].to(dt)).reshape(E, G, cap + 1, D)

    weight = gate.to(dt).float()  # the reference combines with gates in the activation dtype
    y = torch.zeros((G, N, D), dtype=torch.float32, device=xg.device)
    for j in range(k):
        picked = expert_out[idx[..., j], groups[..., 0], slot[..., j]].float()
        y += torch.where(kept[..., j, None], weight[..., j, None] * picked, 0.0)
    return y.to(dt), (_aux_loss(logits, idx, kept) if aux else None)


def _shared(p, x, cfg: ArchConfig):
    sh = p["shared"]
    return swiglu(x, sh["wg"], sh["wi"], sh["wo"], torch_dtype(cfg.dtype))


def moe_ffn(p, x, cfg: ArchConfig, aux: bool = False):
    """x: (B, S, D) → ((B, S, D), aux loss or None, as :func:`_route`). Groups of N =
    min(moe_group_tokens, B·S) tokens span the batch's rows in order, so a
    row's routing depends on its batch-mates (ROADMAP H6); B·S must be a
    multiple of N, as the reference asserts (H7)."""
    B, S, D = x.shape
    N = min(cfg.moe_group_tokens, B * S)
    if (B * S) % N:
        raise ValueError(f"moe_ffn: {B}x{S} tokens do not split into groups of {N}")
    y, layer_aux = _route(p, x.reshape((B * S) // N, N, D), cfg, capacity(cfg, N), aux)
    y = y.reshape(B, S, D)
    if cfg.n_shared_experts:
        y = y + _shared(p, x, cfg)
    return y, layer_aux


def moe_decode_ffn(p, x, cfg: ArchConfig):
    """Decode-time MoE: one group over the step's B·S tokens, capacity
    ``max(4, ceil(k·B·S/E·cf))``."""
    B, S, D = x.shape
    y = _route(p, x.reshape(1, B * S, D), cfg, capacity(cfg, B * S))[0].reshape(B, S, D)
    if cfg.n_shared_experts:
        y = y + _shared(p, x, cfg)
    return y


def _ffn(p, h, cfg: ArchConfig, decode: bool = False, aux: bool = False):
    """The feed-forward half of a layer on the normed residual: SwiGLU for a
    leading dense layer, the routed and shared experts for an MoE layer.
    Returns (y, the layer's aux loss where ``aux`` asks for it: 0 for a dense
    layer)."""
    x = rms_norm(h, p["ln2"])
    if "mlp" in p:
        m = p["mlp"]
        return swiglu(x, m["wg"], m["wi"], m["wo"], torch_dtype(cfg.dtype)), 0.0
    if decode:
        return moe_decode_ffn(p["moe"], x, cfg), None
    return moe_ffn(p["moe"], x, cfg, aux)


def moe_block(p, x, cfg: ArchConfig, positions):
    """One layer (a leading dense layer or an MoE layer): (x out, aux loss)."""
    x = x + gqa_attention(p["attn"], rms_norm(x, p["ln1"]), cfg, positions)
    y, aux = _ffn(p, x, cfg, aux=True)
    return x + y, aux


def _layers(params):
    """(cache key, index in its stack, layer params) in layer order: the
    leading dense layers, then the MoE layers."""
    for name in ("dense", "moe"):
        stack = params.get(f"{name}_blocks")
        if stack is not None:
            for i in range(stack["ln1"].shape[0]):
                yield name, i, layer_params(stack, i)


# ---------------------------------------------------------------------------
# Forward / loss / prefill / decode
# ---------------------------------------------------------------------------


def moe_forward(params, cfg: ArchConfig, tokens):
    """tokens: (B, S) int → (logits (B, S, V), the sum of the MoE layers' aux
    losses (f32)), as the reference. Each layer runs under ``cfg.remat``
    when autograd records (the reference's ``remat_wrap`` over its dense
    stack and its scan over MoE layers)."""
    h = embed_tokens(params, cfg, tokens)
    positions = torch.arange(h.shape[1], device=h.device)
    body = remat_wrap(lambda p, x: moe_block(p, x, cfg, positions), cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for _, _, p in _layers(params):
        h, layer_aux = body(p, h)
        aux = aux + layer_aux
    h = rms_norm(h, params["final_ln"])
    return unembed(params, cfg, h), aux


def moe_loss(params, cfg: ArchConfig, batch):
    """batch: {"tokens", "labels"} (B, S) int → (loss + router_aux_weight ·
    aux / n_moe, {"ce", "accuracy", "aux_loss"}), aux_loss the MoE layers'
    mean."""
    logits, aux = moe_forward(params, cfg, batch["tokens"])
    loss, metrics = cross_entropy(logits, batch["labels"], z_loss=cfg.z_loss)
    aux_mean = aux / max(1, cfg.n_layers - cfg.n_dense_layers)
    metrics["aux_loss"] = aux_mean.detach()
    return loss + cfg.router_aux_weight * aux_mean, metrics


def moe_prefill(params, cfg: ArchConfig, tokens):
    """Prefill with KV-cache collection (attention KV only; MoE is stateless).
    Returns (last-position logits (B, 1, V), {"dense": {k, v}, "moe": {k, v}}
    with leaves (layers of the stack, B, Hkv, S, hd))."""
    h = embed_tokens(params, cfg, tokens)
    positions = torch.arange(h.shape[1], device=h.device)
    kvs: dict = {}
    for name, _, p in _layers(params):
        y, kv = gqa_attention(p["attn"], rms_norm(h, p["ln1"]), cfg, positions, collect=True)
        h = h + y
        h = h + _ffn(p, h, cfg)[0]
        kvs.setdefault(name, []).append(kv)
    cache = {name: {t: torch.stack([kv[t] for kv in layers]) for t in ("k", "v")}
             for name, layers in kvs.items()}
    h = rms_norm(h[:, -1:].contiguous(), params["final_ln"])
    return unembed(params, cfg, h), cache


def moe_cache_defs(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """Abstract cache layout on the ``meta`` device."""
    dt = torch_dtype(cfg.dtype)

    def leaf(n):
        shape = (n, batch, cfg.n_kv_heads, max_seq, cfg.resolved_head_dim)
        return torch.empty(shape, dtype=dt, device="meta")

    out = {"moe": {"k": leaf(cfg.n_layers - cfg.n_dense_layers), "v": leaf(cfg.n_layers - cfg.n_dense_layers)}}
    if cfg.n_dense_layers:
        out["dense"] = {"k": leaf(cfg.n_dense_layers), "v": leaf(cfg.n_dense_layers)}
    return out


def moe_decode_step(params, cfg: ArchConfig, cache, tokens, pos):
    """One decode step. tokens: (B, 1) int; pos: scalar or (B,). Writes the
    step's K/V into ``cache`` in place and returns (logits (B, 1, V), cache)."""
    h = embed_tokens(params, cfg, tokens)
    pos = torch.as_tensor(pos, device=h.device).long()  # one host-to-device copy per step
    for name, i, p in _layers(params):
        layer_cache = {"k": cache[name]["k"][i], "v": cache[name]["v"][i]}
        y, _ = gqa_decode_attn(p["attn"], layer_cache, rms_norm(h, p["ln1"]), cfg, pos)
        h = h + y
        h = h + _ffn(p, h, cfg, decode=True)[0]
    h = rms_norm(h, params["final_ln"])
    return unembed(params, cfg, h), cache
