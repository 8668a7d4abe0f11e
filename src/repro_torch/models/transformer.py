"""Dense decoder-only transformer: training loss, prefill and decode (the
port of ``repro.models.transformer``). Covers GQA with standard or local
attention (codeqwen1.5-7b, starcoder2-7b, mistral-large-123b, nbi-100m), MLA
(minicpm3-4b: multi-head latent attention with a compressed latent cache and
the absorbed-matmul decode) and the visual prefix (llava-next-mistral-7b:
precomputed patch embeddings prepended to the text).

Layout conventions, as in the reference
---------------------------------------
* Per-layer weights are stacked on a leading ``layers`` axis; the reference's
  ``lax.scan`` over layers is a Python loop over views of that axis.
* Projection weights are shaped (D, H, hd).
* The KV cache is laid out (L, B, Hkv, S, hd); MLA's latent cache as ``ckv``
  (L, B, S, kv_lora_rank) and ``krope`` (L, B, S, qk_rope_dim).

Every full-sequence attention (training and prefill) goes through
:func:`repro_torch.kernels.ops.attention` with compact (B, Hkv, S, hd) K/V,
GQA resolved in the kernel's index (MLA's at (d, dv) = (96, 64) at full
width, where the reference runs its XLA ``attention_chunked``); every RMSNorm,
MLA's ``q_ln`` and ``kv_ln`` included, through
:func:`repro_torch.kernels.ops.rmsnorm`. Both take their gradient by
recomputing the plain path. Decode attention is plain PyTorch
(:func:`.common.attention_single_shot`, MLA's absorbed matmuls), as it is XLA
and not Pallas in the reference.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint, noop_context_fn

from repro_torch.kernels import ops

from .common import (
    ParamDef,
    apply_rope,
    attention_single_shot,
    cross_entropy,
    map_defs,
    rms_norm,
    swiglu,
    torch_dtype,
    tree_leaves,
)
from .config import ArchConfig

# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


def _stack(n, d: ParamDef) -> ParamDef:
    return ParamDef(
        shape=(n, *d.shape),
        logical=("layers", *d.logical),
        dtype=d.dtype,
        init=d.init,
        scale=d.scale,
    )


def attn_defs(cfg: ArchConfig, pdt) -> dict:
    D, H, K = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    if cfg.attention == "mla":
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        return {
            "wdq": ParamDef((D, cfg.q_lora_rank), ("embed", None), pdt),
            "q_ln": ParamDef((cfg.q_lora_rank,), (None,), pdt, "ones"),
            "wuq": ParamDef((cfg.q_lora_rank, H, qk), (None, "heads", None), pdt),
            "wdkv": ParamDef((D, cfg.kv_lora_rank), ("embed", None), pdt),
            "kv_ln": ParamDef((cfg.kv_lora_rank,), (None,), pdt, "ones"),
            "wukv": ParamDef((cfg.kv_lora_rank, H, cfg.qk_nope_dim + cfg.v_head_dim), (None, "heads", None), pdt),
            "wkr": ParamDef((D, cfg.qk_rope_dim), ("embed", None), pdt),
            "wo": ParamDef((H, cfg.v_head_dim, D), ("heads", None, "embed"), pdt),
        }
    return {
        "wq": ParamDef((D, H, hd), ("embed", "heads", None), pdt),
        "wk": ParamDef((D, K, hd), ("embed", "kv_heads", None), pdt),
        "wv": ParamDef((D, K, hd), ("embed", "kv_heads", None), pdt),
        "wo": ParamDef((H, hd, D), ("heads", None, "embed"), pdt),
    }


def mlp_defs(cfg: ArchConfig, pdt, d_ff=None) -> dict:
    D, F = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wg": ParamDef((D, F), ("embed", "ff"), pdt),
        "wi": ParamDef((D, F), ("embed", "ff"), pdt),
        "wo": ParamDef((F, D), ("ff", "embed"), pdt),
    }


def block_defs(cfg: ArchConfig, pdt) -> dict:
    D = cfg.d_model
    return {
        "ln1": ParamDef((D,), (None,), pdt, "ones"),
        "attn": attn_defs(cfg, pdt),
        "ln2": ParamDef((D,), (None,), pdt, "ones"),
        "mlp": mlp_defs(cfg, pdt),
    }


def dense_param_defs(cfg: ArchConfig) -> dict:
    pdt = torch_dtype(cfg.param_dtype)
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    defs = {
        "embed": ParamDef((V, D), ("vocab", "embed"), pdt),
        "blocks": map_defs(lambda d: _stack(L, d), block_defs(cfg, pdt)),
        "final_ln": ParamDef((D,), (None,), pdt, "ones"),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((D, V), ("embed", "vocab"), pdt)
    return defs


def layer_params(blocks: dict, i: int) -> dict:
    """Layer ``i`` of the stacked block params, as views."""
    return map_defs(lambda a: a[i], blocks)


# ---------------------------------------------------------------------------
# Attention (full-sequence path)
# ---------------------------------------------------------------------------


def gqa_attention(p, x, cfg: ArchConfig, positions, collect: bool = False):
    dt = torch_dtype(cfg.dtype)
    q = torch.einsum("bsd,dhk->bhsk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bhsk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bhsk", x, p["wv"].to(dt)).contiguous()
    q = apply_rope(q, positions, cfg.rope_theta).contiguous()
    k = apply_rope(k, positions, cfg.rope_theta).contiguous()
    # compact (B, Hkv, S, hd) K/V: the kernel maps query head h to h // G
    window = cfg.window if cfg.attention == "local" else 0
    # the backward's recompute chunks KV as the reference: Griffin's
    # local_attention at min(attn_chunk, window), the dense path at attn_chunk
    kv_chunk = min(cfg.attn_chunk, window) if window > 0 else cfg.attn_chunk
    out = ops.attention(q, k, v, causal=True, window=window, logit_cap=cfg.logit_cap, kv_chunk=kv_chunk)
    y = torch.einsum("bhsk,hkd->bsd", out, p["wo"].to(dt))
    if collect:
        return y, {"k": k, "v": v}
    return y


def mla_attention(p, x, cfg: ArchConfig, positions, collect: bool = False):
    """Full-sequence MLA: the latent projections expanded to per-head q, k
    (nope + rope) and v; every head shares the roped k part."""
    dt = torch_dtype(cfg.dtype)
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    cq = rms_norm(torch.einsum("bsd,dr->bsr", x, p["wdq"].to(dt)), p["q_ln"])
    q = torch.einsum("bsr,rhk->bhsk", cq, p["wuq"].to(dt))
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    ckv = rms_norm(torch.einsum("bsd,dr->bsr", x, p["wdkv"].to(dt)), p["kv_ln"])
    kv = torch.einsum("bsr,rhk->bhsk", ckv, p["wukv"].to(dt))
    k_nope, v = kv[..., :nope], kv[..., nope:].contiguous()  # the kernel takes contiguous v
    k_rope = torch.einsum("bsd,dk->bsk", x, p["wkr"].to(dt))[:, None]  # one head, shared
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:-1], rope)], -1)
    q = torch.cat([q_nope, q_rope], -1)
    out = ops.attention(q, k, v, causal=True, kv_chunk=cfg.attn_chunk)
    y = torch.einsum("bhsv,hvd->bsd", out, p["wo"].to(dt))
    if collect:
        # the compressed cache: the latent ckv and the shared roped k
        return y, {"ckv": ckv, "krope": k_rope[:, 0]}
    return y


def attention_fn(cfg: ArchConfig):
    return mla_attention if cfg.attention == "mla" else gqa_attention


def dense_block(p, x, cfg: ArchConfig, positions):
    x = x + attention_fn(cfg)(p["attn"], rms_norm(x, p["ln1"]), cfg, positions)
    m = p["mlp"]
    return x + swiglu(rms_norm(x, p["ln2"]), m["wg"], m["wi"], m["wo"], torch_dtype(cfg.dtype))


# ---------------------------------------------------------------------------
# Layer-stack execution
# ---------------------------------------------------------------------------

# what ``remat="selective"`` keeps from the forward: the matmuls' outputs
# (the reference's ``dots_with_no_batch_dims_saveable``); the rest is recomputed
_MATMULS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default]


def remat_wrap(fn, cfg: ArchConfig):
    """``fn`` under ``cfg.remat`` when autograd records: ``full`` recomputes
    the whole call in the backward, ``selective`` all but the matmuls."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "selective":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        def context_fn():
            return create_selective_checkpoint_contexts(_MATMULS)
    else:
        context_fn = noop_context_fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)


def run_stack(blocks, x, cfg: ArchConfig, apply_block):
    """Apply ``apply_block(layer params, x)`` over the layers stacked on the
    leading axis of ``blocks`` in order (the reference's ``lax.scan``), each
    call under ``cfg.remat``."""
    body = remat_wrap(apply_block, cfg)
    for i in range(tree_leaves(blocks)[0][1].shape[0]):
        x = body(layer_params(blocks, i), x)
    return x


# ---------------------------------------------------------------------------
# Forward, loss and prefill
# ---------------------------------------------------------------------------


def embed_tokens(params, cfg: ArchConfig, tokens):
    return params["embed"].to(torch_dtype(cfg.dtype))[tokens.long()]


def unembed(params, cfg: ArchConfig, h):
    dt = torch_dtype(cfg.dtype)
    table = params["embed"].to(dt).T if cfg.tie_embeddings else params["unembed"].to(dt)
    return torch.einsum("bsd,dv->bsv", h, table)


def embed_inputs(params, cfg: ArchConfig, tokens, patches=None):
    """Embedded tokens, after the visual prefix when ``patches`` (B, P, D) are
    given (cast to the activations' dtype)."""
    h = embed_tokens(params, cfg, tokens)
    if patches is not None:
        h = torch.cat([patches.to(h.dtype), h], dim=1)
    return h


def dense_forward(params, cfg: ArchConfig, tokens, patches=None):
    """tokens: (B, S_text) int; patches: (B, P, D) or None → logits (B, P + S_text, V)."""
    h = embed_inputs(params, cfg, tokens, patches)
    positions = torch.arange(h.shape[1], device=h.device)
    h = run_stack(params["blocks"], h, cfg, lambda p, y: dense_block(p, y, cfg, positions))
    h = rms_norm(h, params["final_ln"])
    return unembed(params, cfg, h)


def dense_loss(params, cfg: ArchConfig, batch):
    """batch: {"tokens", "labels"} (B, S) int, and "patches" (B, P, D) for a
    visual prefix, with labels then over P + S positions → (mean loss,
    {"ce", "accuracy"})."""
    logits = dense_forward(params, cfg, batch["tokens"], patches=batch.get("patches"))
    return cross_entropy(logits, batch["labels"], z_loss=cfg.z_loss)


def dense_prefill(params, cfg: ArchConfig, tokens, patches=None):
    """Inference prefill: full-sequence forward that also materialises the
    per-layer cache, each leaf the attention returns stacked over layers.
    Returns (last-position logits (B, 1, V), cache: "k" and "v" (L, B, Hkv,
    S, hd), or for MLA "ckv" (L, B, S, kv_lora_rank) and "krope" (L, B, S,
    qk_rope_dim)); S counts the visual prefix."""
    h = embed_inputs(params, cfg, tokens, patches)
    positions = torch.arange(h.shape[1], device=h.device)
    dt = torch_dtype(cfg.dtype)
    attn = attention_fn(cfg)
    layers = []
    for i in range(cfg.n_layers):
        p = layer_params(params["blocks"], i)
        y, leaves = attn(p["attn"], rms_norm(h, p["ln1"]), cfg, positions, collect=True)
        h = h + y
        m = p["mlp"]
        h = h + swiglu(rms_norm(h, p["ln2"]), m["wg"], m["wi"], m["wo"], dt)
        layers.append(leaves)
    h = rms_norm(h[:, -1:].contiguous(), params["final_ln"])
    return unembed(params, cfg, h), {name: torch.stack([c[name] for c in layers]) for name in layers[0]}


# ---------------------------------------------------------------------------
# Decoding (KV cache)
# ---------------------------------------------------------------------------


def dense_cache_defs(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """Abstract cache layout: tensors on the ``meta`` device (shape and dtype,
    no storage), the counterpart of the reference's ShapeDtypeStructs."""
    L = cfg.n_layers
    dt = torch_dtype(cfg.dtype)
    if cfg.attention == "mla":
        return {
            "ckv": torch.empty((L, batch, max_seq, cfg.kv_lora_rank), dtype=dt, device="meta"),
            "krope": torch.empty((L, batch, max_seq, cfg.qk_rope_dim), dtype=dt, device="meta"),
        }
    shape = (L, batch, cfg.n_kv_heads, max_seq, cfg.resolved_head_dim)
    return {
        "k": torch.empty(shape, dtype=dt, device="meta"),
        "v": torch.empty(shape, dtype=dt, device="meta"),
    }


def scatter_seq(buf, update, pos):
    """Write ``update`` (..., 1, d) into ``buf`` (..., S, d) at sequence index
    ``pos``, in place, and return ``buf``: (B, H, S, d) K/V or MLA's (B, S, r)
    latents.

    ``pos`` may be a scalar (whole batch at one position) or a (B,) vector
    (continuous batching: every row at its own depth; ``buf``'s leading dim
    is the batch). The reference builds a new buffer with a one-hot
    multiply-add so that GSPMD can shard S; on one card an in-place write
    saves reading and writing the whole cache per step.
    """
    pos = torch.as_tensor(pos, device=buf.device).long()
    update = update.to(buf.dtype)
    if pos.dim() == 0:
        buf.index_copy_(buf.dim() - 2, pos.reshape(1), update)
    else:
        rows = torch.arange(buf.shape[0], device=buf.device)
        buf[rows, ..., pos, :] = update[:, ..., 0, :]
    return buf


def _pos_rope(pos, batch: int, device):
    """Positions for RoPE at decode: scalar → (1,); vector → (B,1,1) so the
    angle tensor broadcasts against (B, H, 1, dh/2)."""
    pos = torch.as_tensor(pos, device=device)
    if pos.dim() == 0:
        return pos.reshape(1)
    return pos.expand(batch)[:, None, None]


def _pos_mask(pos, batch: int, skv: int, device):
    """(B,1,1,1,S) causal mask rows for scalar or per-row positions."""
    pos_b = torch.as_tensor(pos, device=device).expand(batch)
    return torch.arange(skv, device=device)[None, None, None, None, :] <= pos_b[:, None, None, None, None]


def gqa_decode_attn(p, layer_cache, x, cfg: ArchConfig, pos):
    """One-token attention against the cache; ``pos`` scalar or (B,). Writes
    the new K/V into ``layer_cache`` in place."""
    dt = torch_dtype(cfg.dtype)
    B = x.shape[0]
    q = torch.einsum("bsd,dhk->bhsk", x, p["wq"].to(dt))
    k_new = torch.einsum("bsd,dhk->bhsk", x, p["wk"].to(dt))
    v_new = torch.einsum("bsd,dhk->bhsk", x, p["wv"].to(dt))
    positions = _pos_rope(pos, B, x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)
    k = scatter_seq(layer_cache["k"], k_new, pos)
    v = scatter_seq(layer_cache["v"], v_new, pos)
    S = k.shape[-2]
    mask = _pos_mask(pos, B, S, x.device)
    if cfg.attention == "local" and cfg.window > 0:
        low = _pos_mask(torch.as_tensor(pos, device=x.device) - cfg.window, B, S, x.device)
        mask &= ~low  # k_pos > pos - window
    out = attention_single_shot(q, k, v, mask=mask, logit_cap=cfg.logit_cap)
    y = torch.einsum("bhsk,hkd->bsd", out, p["wo"].to(dt))
    return y, {"k": k, "v": v}


def mla_decode_attn(p, layer_cache, x, cfg: ArchConfig, pos):
    """Absorbed-matmul MLA decode over the compressed (ckv, krope) cache;
    ``pos`` scalar or (B,). Writes the new latents into ``layer_cache`` in
    place. Plain PyTorch, as the reference's XLA."""
    dt = torch_dtype(cfg.dtype)
    B = x.shape[0]
    nope, rope_d = cfg.qk_nope_dim, cfg.qk_rope_dim
    positions = _pos_rope(pos, B, x.device)
    cq = rms_norm(torch.einsum("bsd,dr->bsr", x, p["wdq"].to(dt)), p["q_ln"])
    q = torch.einsum("bsr,rhk->bhsk", cq, p["wuq"].to(dt))
    q_nope, q_rope = q[..., :nope], apply_rope(q[..., nope:], positions, cfg.rope_theta)
    ckv_new = rms_norm(torch.einsum("bsd,dr->bsr", x, p["wdkv"].to(dt)), p["kv_ln"])
    krope_new = apply_rope(torch.einsum("bsd,dk->bsk", x, p["wkr"].to(dt))[:, None], positions,
                           cfg.rope_theta)[:, 0]
    ckv = scatter_seq(layer_cache["ckv"], ckv_new, pos)
    krope = scatter_seq(layer_cache["krope"], krope_new, pos)
    wuk = p["wukv"][..., :nope].to(dt)  # (r, H, nope)
    wuv = p["wukv"][..., nope:].to(dt)  # (r, H, v)
    q_abs = torch.einsum("bhsk,rhk->bhsr", q_nope, wuk)
    s = torch.einsum("bhsr,btr->bhst", q_abs, ckv) + torch.einsum("bhsk,btk->bhst", q_rope, krope)
    s = s.float() * ((nope + rope_d) ** -0.5)
    s = torch.where(_pos_mask(pos, B, ckv.shape[1], x.device)[:, :, 0], s, -1e30)  # (B, 1, 1, S)
    w = torch.softmax(s, dim=-1).to(dt)
    ctx = torch.einsum("bhst,btr->bhsr", w, ckv)
    out_h = torch.einsum("bhsr,rhv->bhsv", ctx, wuv)
    y = torch.einsum("bhsv,hvd->bsd", out_h, p["wo"].to(dt))
    return y, {"ckv": ckv, "krope": krope}


def dense_decode_step(params, cfg: ArchConfig, cache, tokens, pos):
    """One decode step. tokens: (B, 1) int; pos: scalar or (B,).

    Writes the step's K/V (or MLA latents) into ``cache`` in place and
    returns (logits (B, 1, V), cache)."""
    h = embed_tokens(params, cfg, tokens)
    pos = torch.as_tensor(pos, device=h.device).long()  # one host-to-device copy per step
    dt = torch_dtype(cfg.dtype)
    decode_attn = mla_decode_attn if cfg.attention == "mla" else gqa_decode_attn
    for i in range(cfg.n_layers):
        p = layer_params(params["blocks"], i)
        layer_cache = {name: leaf[i] for name, leaf in cache.items()}
        y, _ = decode_attn(p["attn"], layer_cache, rms_norm(h, p["ln1"]), cfg, pos)
        h = h + y
        m = p["mlp"]
        h = h + swiglu(rms_norm(h, p["ln2"]), m["wg"], m["wi"], m["wo"], dt)
    h = rms_norm(h, params["final_ln"])
    return unembed(params, cfg, h), cache
