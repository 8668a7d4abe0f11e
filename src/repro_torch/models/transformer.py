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

On a device mesh (under :func:`repro_torch.parallel.sharding.use_rules`)
the reference's ``shard()`` sites pin q, k, v, the residual stream and the
logits; K and V are repeated to the query heads where ``heads`` shard and
``kv_heads`` do not (the reference's expansion), so that each rank's query
heads meet their own KV heads; MLA's shared roped key is expanded over each
rank's own heads (:func:`_with_shared_rope`); the visual prefix's stream is
pinned to ``("batch", None, None)``; the embedding lookup is
vocab-parallel; each layer's ZeRO-3 shards are gathered inside its remat
scope (:func:`.common.gather_fsdp`). Prefill and decode run under the same
rules (serving on a mesh): the cache laid out by :func:`cache_logical`, its
sequence split over ``model``, written by :func:`scatter_seq` on the rank
that holds each position and read by the split-KV route of
:func:`.common.attention_single_shot` (MLA's latents by that of
:func:`absorbed_attention`).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint, noop_context_fn

from repro_torch.kernels import ops

from .common import (
    NEG_INF,
    ParamDef,
    apply_rope,
    attention_single_shot,
    cross_entropy,
    gather_fsdp,
    logical_rules,
    map_defs,
    rms_norm,
    shard,
    split_kv_layout,
    split_softmax_context,
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
    q = shard(q, "batch", "heads", None, None)
    k = shard(k, "batch", "kv_heads", None, None)
    v = shard(v, "batch", "kv_heads", None, None)
    k_cache, v_cache = k, v  # the cache keeps the Hkv layout
    # compact (B, Hkv, S, hd) K/V: the kernel maps query head h to h // G
    k, v = _kv_for_query_shards(k, cfg), _kv_for_query_shards(v, cfg)
    window = cfg.window if cfg.attention == "local" else 0
    # the backward's recompute chunks KV as the reference: Griffin's
    # local_attention at min(attn_chunk, window), the dense path at attn_chunk
    kv_chunk = min(cfg.attn_chunk, window) if window > 0 else cfg.attn_chunk
    out = ops.attention(q, k, v, causal=True, window=window, logit_cap=cfg.logit_cap, kv_chunk=kv_chunk)
    y = torch.einsum("bhsk,hkd->bsd", out, p["wo"].to(dt))
    if collect:
        return y, {"k": k_cache, "v": v_cache}
    return y


def _kv_for_query_shards(t, cfg: ArchConfig):
    """GQA's K or V (B, Hkv, S, d) for the kernel. Under rules that shard
    ``heads`` but not ``kv_heads`` (few KV heads on a wide model axis), each
    KV head repeated G times and sharded as the query heads, as the
    reference expands them: a rank's query heads then meet their own KV
    heads (G = 1 in its local kernel call). Otherwise ``t`` itself (MLA's
    keys have a head per query head: :func:`_with_shared_rope`)."""
    rules, _ = logical_rules()
    if rules is None or rules.get("heads") == rules.get("kv_heads"):
        return t
    B, Hkv, S, d = t.shape
    G = cfg.n_heads // cfg.n_kv_heads
    return shard(t[:, :, None].expand(B, Hkv, G, S, d).reshape(B, Hkv * G, S, d), "batch", "heads", None, None)


def _cat_shared(k_nope, k_rope):
    return torch.cat([k_nope, k_rope.expand(*k_nope.shape[:-1], k_rope.shape[-1])], -1)


def _with_shared_rope(k_nope, k_rope):
    """MLA's keys (B, H, S, nope + rope): every head's ``k_nope`` followed by
    the one shared roped head ``k_rope`` (B, 1, S, rope). On a mesh the
    shared head (replicated over the heads' mesh dims) is expanded over each
    rank's own heads on its shards, its local gradient partial there;
    ``k_nope`` is never gathered."""
    if not ops.is_dtensor(k_nope):
        return _cat_shared(k_nope, k_rope)
    from repro_torch.parallel.sharding import redistribute

    k_rope = redistribute(k_rope, k_nope.device_mesh, ops.split_like(k_nope.placements, {0: 0, 2: 2, 3: 3}))
    return ops.on_local_shards("MLA keys", _cat_shared, {"k_nope": k_nope, "k_rope": k_rope},
                               {"k_nope": (0, 1, 2), "k_rope": (0, 2)}, "k_nope")


def mla_attention(p, x, cfg: ArchConfig, positions, collect: bool = False):
    """Full-sequence MLA: the latent projections expanded to per-head q, k
    (nope + rope) and v; every head shares the roped k part. On a mesh q, k
    and v are split over ``heads`` (the reference pins q and k; v goes with
    k, as the kernel's route takes them alike) and the latents' norms run on
    their rows through K2's route."""
    dt = torch_dtype(cfg.dtype)
    nope = cfg.qk_nope_dim
    cq = rms_norm(torch.einsum("bsd,dr->bsr", x, p["wdq"].to(dt)), p["q_ln"])
    q = torch.einsum("bsr,rhk->bhsk", cq, p["wuq"].to(dt))
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    ckv = rms_norm(torch.einsum("bsd,dr->bsr", x, p["wdkv"].to(dt)), p["kv_ln"])
    kv = shard(torch.einsum("bsr,rhk->bhsk", ckv, p["wukv"].to(dt)), "batch", "heads", None, None)
    k_nope, v = kv[..., :nope], kv[..., nope:].contiguous()  # the kernel takes contiguous v
    k_rope = torch.einsum("bsd,dk->bsk", x, p["wkr"].to(dt))[:, None]  # one head, shared
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    k = _with_shared_rope(k_nope, k_rope)
    q = torch.cat([q_nope, q_rope], -1)
    q = shard(q, "batch", "heads", None, None)
    k = shard(k, "batch", "heads", None, None)
    out = ops.attention(q, k, v, causal=True, kv_chunk=cfg.attn_chunk)
    y = torch.einsum("bhsv,hvd->bsd", out, p["wo"].to(dt))
    if collect:
        # the compressed cache: the latent ckv and the shared roped k
        return y, {"ckv": ckv, "krope": k_rope[:, 0]}
    return y


def attention_fn(cfg: ArchConfig):
    return mla_attention if cfg.attention == "mla" else gqa_attention


def residual(x, y):
    """x + y on the residual stream, pinned to ("batch", "seq", None) (the
    reference's constraint after each residual add): a tensor-parallel
    output's partial sums are all-reduced before the add."""
    return shard(x + shard(y, "batch", "seq", None), "batch", "seq", None)


def dense_block(p, x, cfg: ArchConfig, positions):
    x = residual(x, attention_fn(cfg)(p["attn"], rms_norm(x, p["ln1"]), cfg, positions))
    m = p["mlp"]
    return residual(x, swiglu(rms_norm(x, p["ln2"]), m["wg"], m["wi"], m["wo"], torch_dtype(cfg.dtype)))


# ---------------------------------------------------------------------------
# Layer-stack execution
# ---------------------------------------------------------------------------

# what ``remat="selective"`` keeps from the forward: the matmuls' outputs
# (the reference's ``dots_with_no_batch_dims_saveable``); the rest is recomputed
_MATMULS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default]


def remat_wrap(fn, cfg: ArchConfig):
    """``fn`` under ``cfg.remat`` when autograd records: ``full`` recomputes
    the whole call in the backward, ``selective`` all but the matmuls. No
    layer draws random numbers, so the recompute does not save and restore
    the generators' states (``preserve_rng_state=False``): a read of the CUDA
    generator's state is refused inside a CUDA graph's capture
    (:class:`repro_torch.training.TrainGraph`)."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "selective":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        def context_fn():
            return create_selective_checkpoint_contexts(_MATMULS)
    else:
        context_fn = noop_context_fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn, preserve_rng_state=False)


def run_stack(blocks, x, cfg: ArchConfig, apply_block):
    """Apply ``apply_block(layer params, x)`` over the layers stacked on the
    leading axis of ``blocks`` in order (the reference's ``lax.scan``), each
    call under ``cfg.remat``, with the layer's ZeRO-3 shards gathered inside
    it."""
    body = remat_wrap(lambda p, y: apply_block(gather_fsdp(p), y), cfg)
    for i in range(tree_leaves(blocks)[0][1].shape[0]):
        x = body(layer_params(blocks, i), x)
    return x


# ---------------------------------------------------------------------------
# Forward, loss and prefill
# ---------------------------------------------------------------------------


def embed_tokens(params, cfg: ArchConfig, tokens):
    table = params["embed"]
    if ops.is_dtensor(table):
        return shard(_embed_sharded(gather_fsdp(table), tokens, torch_dtype(cfg.dtype)), "batch", "seq", None)
    return table.to(torch_dtype(cfg.dtype))[tokens.long()]


def _embed_sharded(table, tokens, dt):
    """The lookup of DTensor ``tokens`` (B, S) in a DTensor ``table`` (V, D)
    on each rank's local shards: with the vocab sharded, a rank looks up the
    ids in its rows and zeroes the rest (a partial sum over the vocab's mesh
    dim, all-reduced by the caller's ``shard``). The table's local gradient
    is partial over the mesh dims that shard the tokens."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = table.device_mesh
    if any(p.is_shard(1) or p.is_partial() for p in table.placements):
        raise ValueError(f"embedding: table placements {table.placements}: gather its embed dim first")
    rows = [p.is_shard() for p in tokens.placements]
    vocab = [p.is_shard(0) for p in table.placements]
    if any(r and v for r, v in zip(rows, vocab)):
        raise ValueError(f"embedding: tokens {tokens.placements} and table {table.placements} share a mesh dim")
    t = table.to_local(grad_placements=[Partial() if r else p for r, p in zip(rows, table.placements)])
    ids = tokens.to_local().long()
    if any(vocab):
        i = vocab.index(True)
        local = ids - mesh.get_local_rank(i) * t.shape[0]
        inside = (local >= 0) & (local < t.shape[0])
        h = torch.where(inside[..., None], t.to(dt)[local.clamp(0, t.shape[0] - 1)], 0.0)
    else:
        h = t.to(dt)[ids]
    placements = [p if r else Partial() if v else Replicate() for r, v, p in zip(rows, vocab, tokens.placements)]
    return DTensor.from_local(h, mesh, placements, run_check=False)


def unembed(params, cfg: ArchConfig, h):
    dt = torch_dtype(cfg.dtype)
    if cfg.tie_embeddings:
        table = gather_fsdp(params["embed"]).to(dt).T
    else:
        table = gather_fsdp(params["unembed"]).to(dt)
    return shard(torch.einsum("bsd,dv->bsv", h, table), "batch", None, "vocab")


def embed_inputs(params, cfg: ArchConfig, tokens, patches=None):
    """Embedded tokens, after the visual prefix when ``patches`` (B, P, D) are
    given (cast to the activations' dtype). On a mesh the patches arrive
    split as ``("batch", None, None)``, are cast on each rank's shard, and
    the stream is pinned there after the concatenation, as the reference
    pins it; a sequence-split stream (``seq_shard``) is refused."""
    h = embed_tokens(params, cfg, tokens)
    if patches is None:
        return h
    if ops.is_dtensor(patches):
        rules, _ = logical_rules()
        if rules is not None and rules.get("seq") is not None:
            raise ValueError(f"{cfg.name}: the visual prefix takes no sequence-split stream (seq_shard)")
        patches = ops.on_local_shards("patches", lambda t: t.to(h.dtype), {"patches": patches},
                                      {"patches": (0, 1, 2)}, "patches")
    else:
        patches = patches.to(h.dtype)
    return shard(torch.cat([patches, h], dim=1), "batch", None, None)


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
        h = residual(h, y)
        m = p["mlp"]
        h = residual(h, swiglu(rms_norm(h, p["ln2"]), m["wg"], m["wi"], m["wo"], dt))
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


def cache_logical(cfg: ArchConfig) -> dict:
    """Logical axes of each cache leaf (the sequence sharded over ``model``)."""
    if cfg.attention == "mla":
        return {
            "ckv": ("layers", "batch", "kv_seq", None),
            "krope": ("layers", "batch", "kv_seq", None),
        }
    return {
        "k": ("layers", "batch", None, "kv_seq", None),
        "v": ("layers", "batch", None, "kv_seq", None),
    }


def scatter_seq(buf, update, pos):
    """Write ``update`` (..., 1, d) into ``buf`` (..., S, d) at sequence index
    ``pos``, in place, and return ``buf``: (B, H, S, d) K/V or MLA's (B, S, r)
    latents.

    ``pos`` may be a scalar (whole batch at one position) or a (B,) vector
    (continuous batching: every row at its own depth; ``buf``'s leading dim
    is the batch). The reference builds a new buffer with a one-hot
    multiply-add so that GSPMD can shard S; on one card an in-place write
    saves reading and writing the whole cache per step. A DTensor ``buf``
    split over its rows and its sequence (the ``kv_seq`` rule) is written on
    each rank's shard only where it holds ``pos`` (:func:`_scatter_local`).
    """
    if ops.is_dtensor(buf):
        return _scatter_local(buf, update, pos)
    pos = torch.as_tensor(pos, device=buf.device).long()
    update = update.to(buf.dtype)
    if pos.dim() == 0:
        buf.index_copy_(buf.dim() - 2, pos.reshape(1), update)
    else:
        rows = torch.arange(buf.shape[0], device=buf.device)
        buf[rows, ..., pos, :] = update[:, ..., 0, :]
    return buf


def _scatter_local(buf, update, pos):
    """:func:`scatter_seq` into the DTensor ``buf``: ``update`` is brought to
    ``buf``'s rows (every other dim whole), and each rank writes into its
    local shard the rows it holds whose position falls in its slice of the
    sequence, at ``pos - offset``: a scalar position on the ranks of one
    slice, per-row positions on whichever ranks hold them."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel.sharding import local_slices, redistribute

    mesh = buf.device_mesh
    seq = buf.dim() - 2
    if any(p.is_partial() or (p.is_shard() and p.dim not in (0, seq)) for p in buf.placements):
        raise ValueError(f"scatter_seq: buf {buf.placements} may be split over its rows and sequence only")
    rows = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in buf.placements)
    upd = redistribute(update, mesh, rows).to_local().to(buf.dtype)
    local = buf.to_local()
    index = local_slices(buf.shape, buf.placements, mesh)
    lo, hi = index[seq].start, index[seq].stop
    pos = torch.as_tensor(pos, device=local.device).long()
    # no host sync: a rank whose slice lacks the position writes back what it holds
    at, here = (pos - lo).clamp(0, hi - lo - 1), (pos >= lo) & (pos < hi)
    if pos.dim() == 0:
        at = at.reshape(1)
        local.index_copy_(seq, at, torch.where(here, upd, local.index_select(seq, at)))
        return buf
    at, here = at[index[0]], here[index[0]]
    r = torch.arange(local.shape[0], device=local.device)
    keep = here.reshape(-1, *(1,) * (local.dim() - 2))
    local[r, ..., at, :] = torch.where(keep, upd[:, ..., 0, :], local[r, ..., at, :])
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
    S = k.shape[-2]  # the global length: a split cache's mask covers every key
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
    place. Plain PyTorch, as the reference's XLA; on a mesh the latent
    cache's sequence is split over ``kv_seq`` (:func:`absorbed_attention`)."""
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
    mask = _pos_mask(pos, B, ckv.shape[1], x.device)[:, :, 0]  # (B, 1, 1, S) over the global keys
    ctx = absorbed_attention(q_abs, q_rope, ckv, krope, mask, (nope + rope_d) ** -0.5)
    out_h = torch.einsum("bhsr,rhv->bhsv", ctx, wuv)
    y = torch.einsum("bhsv,hvd->bsd", out_h, p["wo"].to(dt))
    return y, {"ckv": ckv, "krope": krope}


def absorbed_attention(q_abs, q_rope, ckv, krope, mask, scale: float):
    """MLA's absorbed attention of one query a head, q_abs (B, H, 1, r) and
    q_rope (B, H, 1, rope), over the latent cache ckv (B, S, r) and krope
    (B, S, rope) → the latent context (B, H, 1, r) in ckv's dtype. Scores
    and the softmax in f32; the weights cast to ckv's dtype before the
    context product, as the reference's; ``mask`` (B, 1, 1, S) over every
    key.

    DTensors take the split-KV route (what GSPMD makes of the reference's
    function on the ``kv_seq``-split cache): the cache may be split over its
    rows and its sequence; the queries, split over ``heads`` on the same
    mesh dim as the keys, are gathered to the cache's rows with every head
    (the one tensor a step moves besides the reductions); each rank scores
    its own keys, and the max, the sum of exponentials against that global
    max and the f32 partial contexts are all-reduced over the mesh dims that
    split the keys. A shard whose keys are all masked adds exactly 0; on one
    shard the route is the plain function, op for op. Forward only."""
    if ops.is_dtensor(ckv):
        return _absorbed_split(q_abs, q_rope, ckv, krope, mask, scale)
    return _absorbed(q_abs, q_rope, ckv, krope, mask, scale, None)


def _absorbed(q_abs, q_rope, ckv, krope, mask, scale: float, groups):
    """:func:`absorbed_attention`'s arithmetic on plain tensors; with
    ``groups`` (process groups of the mesh dims that split the keys) its
    three reductions over the keys are completed across them (the context's
    partial sums in f32), else the context product runs in ckv's dtype, as
    the reference's (:func:`.common.split_softmax_context`)."""
    s = torch.einsum("bhsr,btr->bhst", q_abs, ckv) + torch.einsum("bhsk,btk->bhst", q_rope, krope)
    s = torch.where(mask, s.float() * scale, NEG_INF)
    return split_softmax_context(s, ckv, "bhst,btr->bhsr", groups, f32=False).to(ckv.dtype)


def _absorbed_split(q_abs, q_rope, ckv, krope, mask, scale: float):
    """The split-KV route of :func:`absorbed_attention` (DTensor inputs)."""
    from repro_torch.parallel.sharding import from_local, redistribute

    rows, groups, mask = split_kv_layout("absorbed_attention", (q_abs, q_rope, ckv, krope), ckv, krope, mask, 1)
    mesh = ckv.device_mesh
    q_abs, q_rope = redistribute(q_abs, mesh, rows), redistribute(q_rope, mesh, rows)  # every head, the rows
    ctx = _absorbed(q_abs.to_local(), q_rope.to_local(), ckv.to_local(), krope.to_local(), mask, scale, groups)
    return from_local(ctx, mesh, rows, (*q_abs.shape[:3], ckv.shape[-1]))


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
        h = residual(h, y)
        m = p["mlp"]
        h = residual(h, swiglu(rms_norm(h, p["ln2"]), m["wg"], m["wi"], m["wo"], dt))
    h = rms_norm(h, params["final_ln"])
    return unembed(params, cfg, h), cache
