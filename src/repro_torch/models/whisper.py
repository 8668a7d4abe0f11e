"""Whisper-style encoder-decoder (the port of ``repro.models.whisper``):
training loss, prefill and decode.

The conv audio front end is a stub, as in the reference: the model takes
precomputed frame embeddings (B, enc_len, D), which the log-mel + 2×conv stem
would produce. The backbone is whole: a bidirectional encoder over the
frames, and a causal decoder whose every layer attends to itself and then to
the encoder's memory. Positions are sinusoidal, computed from the positions
(no table), on both sides.

Layouts as in the reference: per-layer weights stacked on a leading
``layers`` axis (``enc_blocks``, ``dec_blocks``), projections (D, H, hd) with
no biases, the MLP with biases, LayerNorms with weight and bias, the head
tied to ``embed``. The cache is ``self_k`` / ``self_v`` (L, B, H, S, hd) and
``cross_k`` / ``cross_v`` (L, B, H, enc_len, hd), the latter computed once at
prefill.

Every full-sequence attention (the encoder, the decoder's self-attention and
its cross-attention, in training and at prefill) goes through
:func:`repro_torch.kernels.ops.attention`, whose gradient recomputes
``attention_chunked`` at the reference's ``attn_chunk``. The reference runs
its XLA ``attention_chunked`` there, not Pallas. Decode attention, the
LayerNorms and the GELU are plain PyTorch, as they are XLA in the reference.

On a device mesh (:func:`repro_torch.parallel.sharding.use_rules`) the
reference's ``shard()`` sites pin q, k (and v with them) over ``heads``, the
MLP's hidden state over ``ff``, the stream to ``("batch", None, None)`` and
the logits over ``vocab``; the LayerNorms, the sinusoids and the MLP's
biases run on each rank's shards (:func:`.common.channelwise`), the output
bias after the ``ff`` product's partial sums are reduced. At decode the
self-attention is split-KV over the ``kv_seq``-split cache
(:func:`.common.attention_single_shot`) and the cross-attention runs on each
rank's heads of the head-split cross cache.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from .common import (
    ParamDef,
    attention_single_shot,
    channelwise,
    cross_entropy,
    layer_norm,
    map_defs,
    replicated_like,
    shard,
    torch_dtype,
)
from .config import ArchConfig
from .transformer import _pos_mask, _stack, embed_tokens, layer_params, remat_wrap, run_stack, scatter_seq, unembed

# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


def _attn_defs(cfg: ArchConfig, pdt) -> dict:
    D, H = cfg.d_model, cfg.n_heads
    hd = cfg.resolved_head_dim
    return {
        "wq": ParamDef((D, H, hd), ("embed", "heads", None), pdt),
        "wk": ParamDef((D, H, hd), ("embed", "heads", None), pdt),
        "wv": ParamDef((D, H, hd), ("embed", "heads", None), pdt),
        "wo": ParamDef((H, hd, D), ("heads", None, "embed"), pdt),
    }


def _mlp_defs(cfg: ArchConfig, pdt) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "wi": ParamDef((D, F_), ("embed", "ff"), pdt),
        "bi": ParamDef((F_,), ("ff",), pdt, "zeros"),
        "wo": ParamDef((F_, D), ("ff", "embed"), pdt),
        "bo": ParamDef((D,), (None,), pdt, "zeros"),
    }


def _ln_defs(name: str, D: int, pdt) -> dict:
    return {f"{name}_w": ParamDef((D,), (None,), pdt, "ones"), f"{name}_b": ParamDef((D,), (None,), pdt, "zeros")}


def enc_layer_defs(cfg: ArchConfig, pdt) -> dict:
    D = cfg.d_model
    return {**_ln_defs("ln1", D, pdt), "attn": _attn_defs(cfg, pdt), **_ln_defs("ln2", D, pdt),
            "mlp": _mlp_defs(cfg, pdt)}


def dec_layer_defs(cfg: ArchConfig, pdt) -> dict:
    D = cfg.d_model
    return {**_ln_defs("ln1", D, pdt), "self_attn": _attn_defs(cfg, pdt), **_ln_defs("ln2", D, pdt),
            "cross_attn": _attn_defs(cfg, pdt), **_ln_defs("ln3", D, pdt), "mlp": _mlp_defs(cfg, pdt)}


def whisper_param_defs(cfg: ArchConfig) -> dict:
    pdt = torch_dtype(cfg.param_dtype)
    V, D = cfg.vocab_size, cfg.d_model
    return {
        "enc_blocks": map_defs(lambda d: _stack(cfg.n_enc_layers, d), enc_layer_defs(cfg, pdt)),
        **_ln_defs("enc_ln", D, pdt),
        "embed": ParamDef((V, D), ("vocab", "embed"), pdt),
        "dec_blocks": map_defs(lambda d: _stack(cfg.n_layers, d), dec_layer_defs(cfg, pdt)),
        **_ln_defs("dec_ln", D, pdt),
    }


# ---------------------------------------------------------------------------
# Sinusoidal positions
# ---------------------------------------------------------------------------


def sinusoid(positions, dim: int, dtype):
    """positions: (S,) int → (S, dim): [sin, cos] of f32 angles at the
    frequencies exp(-ln(1e4)·i / max(1, dim/2 − 1)), cast to ``dtype``."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=positions.device)
                      / max(1, half - 1))
    ang = positions.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _add(x, v):
    return x + v.to(x.dtype)


def add_positions(h, positions):
    """``h`` (B, S, D) plus the sinusoids of ``positions`` (S,), pinned to
    ``("batch", None, None)`` (on a mesh on each rank's shards)."""
    table = sinusoid(positions, h.shape[-1], h.dtype)
    return shard(channelwise(_add, h, replicated_like(table, h)), "batch", None, None)


# ---------------------------------------------------------------------------
# Attention and MLP
# ---------------------------------------------------------------------------


def _mha(p, xq, xkv, cfg: ArchConfig, *, causal: bool, collect: bool = False):
    """Multi-head attention of queries from ``xq`` over keys and values from
    ``xkv`` (the same tensor for self-attention, the encoder's memory for
    cross-attention); with ``collect``, also the (B, H, Skv, hd) K and V."""
    dt = xq.dtype
    q = shard(torch.einsum("bsd,dhk->bhsk", xq, p["wq"].to(dt)).contiguous(), "batch", "heads", None, None)
    k = shard(torch.einsum("bsd,dhk->bhsk", xkv, p["wk"].to(dt)).contiguous(), "batch", "heads", None, None)
    v = shard(torch.einsum("bsd,dhk->bhsk", xkv, p["wv"].to(dt)).contiguous(), "batch", "heads", None, None)
    out = ops.attention(q, k, v, causal=causal, kv_chunk=cfg.attn_chunk)
    y = torch.einsum("bhsk,hkd->bsd", out, p["wo"].to(dt))
    if collect:
        return y, k, v
    return y


def _gelu_in(h, bi):
    return F.gelu(h + bi.to(h.dtype), approximate="tanh")


def _mlp(p, x):
    """GELU MLP with biases; the tanh approximation, as ``jax.nn.gelu``'s
    default. On a mesh ``bi`` meets the hidden state's ``ff`` shards, and
    ``bo`` is added once, to the all-reduced output (never to each rank's
    partial sum of the ``ff``-contracted product)."""
    dt = x.dtype
    h = channelwise(_gelu_in, torch.einsum("bsd,df->bsf", x, p["wi"].to(dt)), p["bi"])
    h = shard(h, "batch", None, "ff")
    y = shard(torch.einsum("bsf,fd->bsd", h, p["wo"].to(dt)), "batch", None, None)
    return channelwise(_add, y, p["bo"])


def _residual(h, y):
    """h + y on the stream, pinned to ("batch", None, None): the partial sums
    of an output contracted over split heads are all-reduced before the add."""
    return h + shard(y, "batch", None, None)


def _ln(p, name: str, x):
    return layer_norm(x, p[f"{name}_w"], p[f"{name}_b"])


# ---------------------------------------------------------------------------
# Encoder and decoder stacks
# ---------------------------------------------------------------------------


def _enc_block(p, h, cfg: ArchConfig):
    xn = _ln(p, "ln1", h)
    h = _residual(h, _mha(p["attn"], xn, xn, cfg, causal=False))
    return _residual(h, _mlp(p["mlp"], _ln(p, "ln2", h)))


def encode(params, cfg: ArchConfig, frames):
    """frames: (B, enc_len, D) stub front-end embeddings → the encoder's
    memory (B, enc_len, D) in the activations' dtype."""
    h = add_positions(frames.to(torch_dtype(cfg.dtype)), torch.arange(frames.shape[1], device=frames.device))
    h = run_stack(params["enc_blocks"], h, cfg, lambda p, h: _enc_block(p, h, cfg))
    return _ln(params, "enc_ln", h)


def _embed(params, cfg: ArchConfig, tokens):
    return add_positions(embed_tokens(params, cfg, tokens), torch.arange(tokens.shape[1], device=tokens.device))


def _dec_block(p, h, memory, cfg: ArchConfig, collect: bool = False):
    """One decoder layer; with ``collect``, also its cache leaves: the
    self-attention's K/V and the cross-attention's K/V of the memory."""
    xn = _ln(p, "ln1", h)
    y, k, v = _mha(p["self_attn"], xn, xn, cfg, causal=True, collect=True)
    h = _residual(h, y)
    y, kc, vc = _mha(p["cross_attn"], _ln(p, "ln2", h), memory, cfg, causal=False, collect=True)
    h = _residual(h, y)
    h = _residual(h, _mlp(p["mlp"], _ln(p, "ln3", h)))
    if collect:
        return h, {"self_k": k, "self_v": v, "cross_k": kc, "cross_v": vc}
    return h


def decode_train(params, cfg: ArchConfig, tokens, memory):
    """tokens: (B, S) int; memory: (B, enc_len, D) → logits (B, S, V)."""
    h = _embed(params, cfg, tokens)
    h = run_stack(params["dec_blocks"], h, cfg, lambda p, h: _dec_block(p, h, memory, cfg))
    return unembed(params, cfg, _ln(params, "dec_ln", h))  # tied head


def whisper_forward(params, cfg: ArchConfig, tokens, frames):
    """Logits of every position (B, S, V): the decoder over ``tokens``
    against the encoder's memory of ``frames``."""
    return decode_train(params, cfg, tokens, encode(params, cfg, frames))


def whisper_loss(params, cfg: ArchConfig, batch):
    """batch: {"frames" (B, enc_len, D), "tokens", "labels" (B, S) int} →
    (mean loss, {"ce", "accuracy"})."""
    logits = whisper_forward(params, cfg, batch["tokens"], batch["frames"])
    return cross_entropy(logits, batch["labels"], z_loss=cfg.z_loss)


def whisper_prefill(params, cfg: ArchConfig, frames, tokens):
    """Encode the audio memory, prefill the decoder over ``tokens``, and
    return (last-position logits (B, 1, V), cache: the self-attention K/V
    (L, B, H, S, hd) and the cross-attention K/V (L, B, H, enc_len, hd))."""
    memory = encode(params, cfg, frames)
    h = _embed(params, cfg, tokens)
    body = remat_wrap(lambda p, h: _dec_block(p, h, memory, cfg, collect=True), cfg)
    layers = []
    for i in range(cfg.n_layers):
        h, leaves = body(layer_params(params["dec_blocks"], i), h)
        layers.append(leaves)
    h = _ln(params, "dec_ln", h[:, -1:].contiguous())
    return unembed(params, cfg, h), {name: torch.stack([c[name] for c in layers]) for name in layers[0]}


# ---------------------------------------------------------------------------
# Serving: the cross-KV computed at prefill; the self-KV grows to max_seq
# ---------------------------------------------------------------------------


def whisper_cache_defs(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """Abstract cache layout: tensors on the ``meta`` device."""
    L, H, hd = cfg.n_layers, cfg.n_heads, cfg.resolved_head_dim
    dt = torch_dtype(cfg.dtype)
    self_kv, cross_kv = (L, batch, H, max_seq, hd), (L, batch, H, cfg.enc_len, hd)
    return {
        "self_k": torch.empty(self_kv, dtype=dt, device="meta"),
        "self_v": torch.empty(self_kv, dtype=dt, device="meta"),
        "cross_k": torch.empty(cross_kv, dtype=dt, device="meta"),
        "cross_v": torch.empty(cross_kv, dtype=dt, device="meta"),
    }


def whisper_cache_logical(cfg: ArchConfig) -> dict:
    """Logical axes of each cache leaf: the self-attention's sequence over
    ``model`` (split-KV), the cross-attention's heads."""
    kv = ("layers", "batch", None, "kv_seq", None)
    return {"self_k": kv, "self_v": kv,
            "cross_k": ("layers", "batch", "heads", None, None),
            "cross_v": ("layers", "batch", "heads", None, None)}


def whisper_decode_step(params, cfg: ArchConfig, cache, tokens, pos):
    """One decode step. tokens: (B, 1) int; pos: a scalar position.

    Writes the step's self-attention K/V into ``cache`` in place; the
    cross-attention reads the cached cross-K/V with no mask (on a mesh on
    each rank's heads: :func:`_cross_decode`). Returns (logits (B, 1, V),
    cache)."""
    dt = torch_dtype(cfg.dtype)
    B = tokens.shape[0]
    pos = torch.as_tensor(pos, device=tokens.device).long()  # one host-to-device copy per step
    h = add_positions(embed_tokens(params, cfg, tokens), pos.reshape(1))
    mask = _pos_mask(pos, B, cache["self_k"].shape[-2], h.device)
    for i in range(cfg.n_layers):
        p = layer_params(params["dec_blocks"], i)
        sa, ca = p["self_attn"], p["cross_attn"]
        xn = _ln(p, "ln1", h)
        q = torch.einsum("bsd,dhk->bhsk", xn, sa["wq"].to(dt))
        k = scatter_seq(cache["self_k"][i], torch.einsum("bsd,dhk->bhsk", xn, sa["wk"].to(dt)), pos)
        v = scatter_seq(cache["self_v"][i], torch.einsum("bsd,dhk->bhsk", xn, sa["wv"].to(dt)), pos)
        out = attention_single_shot(q, k, v, mask=mask)
        h = _residual(h, torch.einsum("bhsk,hkd->bsd", out, sa["wo"].to(dt)))
        q = torch.einsum("bsd,dhk->bhsk", _ln(p, "ln2", h), ca["wq"].to(dt))
        out = _cross_decode(q, cache["cross_k"][i], cache["cross_v"][i])
        h = _residual(h, torch.einsum("bhsk,hkd->bsd", out, ca["wo"].to(dt)))
        h = _residual(h, _mlp(p["mlp"], _ln(p, "ln3", h)))
    return unembed(params, cfg, _ln(params, "dec_ln", h)), cache


def _cross_decode(q, k, v):
    """The decode step's cross-attention of q (B, H, 1, hd) over the cached
    cross K/V (B, H, enc_len, hd), unmasked. On a mesh the cache is split
    over its rows and heads (never over ``enc_len``): q is brought to that
    split and each rank attends with its own heads."""
    if not ops.is_dtensor(k):
        return attention_single_shot(q, k, v)
    from repro_torch.parallel.sharding import redistribute

    q = redistribute(q, k.device_mesh, k.placements)
    return ops.on_local_shards("cross-attention decode", attention_single_shot, {"q": q, "k": k, "v": v},
                               {"q": (0, 1), "k": (0, 1), "v": (0, 1)}, "q")
