"""Shared model machinery of the port (``repro.models.common``): parameter
definitions, seeded init, nested-dict trees, RMSNorm, LayerNorm, RoPE,
chunked and decode attention, the causal mask, SwiGLU, GeGLU and the
cross-entropy loss.

Layouts follow the reference at every public function: projections
``(D, H, hd)``, per-layer weights stacked on a leading ``layers`` axis, the KV
cache ``(L, B, Hkv, S, hd)``. A model is a nested dict of :class:`ParamDef`
leaves; :func:`init_params` turns it into tensors. The reference draws its
weights from ``jax.random``, so the numbers differ; parity tests copy the
reference's weights across with :mod:`repro_torch.convert`.

Logical sharding constraints, as in the reference: :func:`shard` pins an
activation to the placements its logical axes resolve to under the rules
that :func:`repro_torch.parallel.sharding.use_rules` installs (a
``DTensor.redistribute``), and is a no-op without rules, so the one-device
path runs unchanged. Under rules every tensor of the step is a DTensor; the
kernels see only local shards (:mod:`repro_torch.kernels.ops`).

Left out: ``sinusoidal_positions``, which no model of the reference calls.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

NEG_INF = -1e30


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``cuda`` without a card raises: the
    CPU is used only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; "
            "pass device='cpu' to run its plain versions on the CPU"
        )
    return dev


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative parameter: shape + logical axes (+ init scale)."""

    shape: tuple
    logical: tuple  # logical axis name per dim (None = replicated dim)
    dtype: torch.dtype = torch.float32
    init: str = "normal"  # normal | zeros | ones | constant
    scale: float = 1.0  # stddev for normal / value for constant

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes {self.logical} differ in rank")


def map_defs(fn, tree, *rest):
    """Apply ``fn`` to every leaf of a nested dict (and to the matching leaves
    of ``rest``, dicts of the same keys), keys in sorted order (the order in
    which JAX flattens a dict)."""
    if isinstance(tree, dict):
        return {k: map_defs(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree, path: str = "") -> list:
    """(keypath, leaf) of every leaf of a nested dict in JAX's flattening
    order; keypaths as ``jax.tree_util.keystr`` prints them (``['a']['b']``)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in tree_leaves(tree[k], f"{path}[{k!r}]")]
    return [(path, tree)]


def tree_unflatten(tree, leaves) -> dict:
    """A nested dict of ``tree``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)
    out = map_defs(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def _fan_in(d: ParamDef) -> int:
    if len(d.shape) == 0:
        return 1
    if len(d.shape) == 1:
        return d.shape[0]
    # stacked-layer leading dim ("layers") is not a fan-in dim
    dims = d.shape[1:] if d.logical and d.logical[0] == "layers" else d.shape
    return int(math.prod(dims[:-1])) if len(dims) > 1 else dims[0]


def init_params(defs, generator: torch.Generator, device) -> dict:
    """Materialise a ParamDef tree: normal leaves get std ``scale / sqrt(fan_in)``
    (the reference's rule), drawn from ``generator`` on its own device."""
    device = torch.device(device)

    def make(d: ParamDef):
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=device)
        if d.init == "constant":
            return torch.full(d.shape, d.scale, dtype=d.dtype, device=device)
        std = d.scale / math.sqrt(max(1, _fan_in(d)))
        w = torch.randn(d.shape, generator=generator, device=generator.device).mul_(std)
        return w.to(device=device, dtype=d.dtype)

    return map_defs(make, defs)


# ---------------------------------------------------------------------------
# Logical sharding constraints
# ---------------------------------------------------------------------------

# Active logical→mesh rules, installed by repro_torch.parallel.sharding.use_rules()
_ACTIVE_RULES: dict | None = None
_ACTIVE_MESH = None


def set_logical_rules(rules: dict | None, mesh=None) -> None:
    global _ACTIVE_RULES, _ACTIVE_MESH
    _ACTIVE_RULES = rules
    _ACTIVE_MESH = mesh


def logical_rules() -> "tuple[dict | None, object]":
    """(the active rules, their mesh), or (None, None) outside ``use_rules``."""
    return _ACTIVE_RULES, _ACTIVE_MESH


def shard(x, *logical):
    """Redistribute the DTensor ``x`` to the placements of its logical axes
    (the reference's ``with_sharding_constraint``); a no-op without rules."""
    if _ACTIVE_RULES is None or _ACTIVE_MESH is None:
        return x
    from repro_torch.parallel.sharding import placements_for

    if not ops.is_dtensor(x):
        raise TypeError(f"shard{logical}: under sharding rules every activation is a DTensor, got {type(x).__name__}")
    want = placements_for(logical, _ACTIVE_RULES, _ACTIVE_MESH)
    return x if tuple(x.placements) == want else x.redistribute(_ACTIVE_MESH, want)


def gather_fsdp(tree):
    """ZeRO-3's gather at use: each DTensor leaf of ``tree`` with its data-axis
    shards (the ``embed`` rule under ``cfg.fsdp``) made whole, its model-axis
    shards kept. Its gradient flows back as a reduce-scatter. The tree
    itself without rules, or when no weight is sharded over the data axes."""
    if _ACTIVE_RULES is None or _ACTIVE_RULES.get("embed") is None:
        return tree
    from torch.distributed.tensor import Replicate

    from repro_torch.parallel.sharding import dp_axes

    mesh = _ACTIVE_MESH
    names = mesh.mesh_dim_names
    data = {names.index(a) for a in dp_axes(mesh)}

    def gather(t):
        want = tuple(Replicate() if i in data else p for i, p in enumerate(t.placements))
        return t if want == tuple(t.placements) else t.redistribute(mesh, want)

    return map_defs(gather, tree)


def channelwise(fn, x, *vectors):
    """``fn(x, *vectors)`` for an elementwise ``fn`` whose vectors (gains,
    biases, mixes: ``(..., C)``) run along x's trailing dims. On a DTensor x
    it runs on each rank's local shards (``ops.on_local_shards``): each
    vector split as the dims of x it meets (a replicated one is cut to them
    first), its local gradient partial over the mesh dims that split x's
    other dims. PyTorch 2.11's DTensor, the card's, reduces a broadcast
    operand's gradient into a malformed spec (and pads into one), so the
    models' vector broadcasts and their padding of the sequence dim never
    run as DTensor ops."""
    if not ops.is_dtensor(x):
        return fn(x, *vectors)
    from torch.distributed.tensor import Shard

    from repro_torch.parallel.sharding import redistribute

    def split_as_x(v):
        lead = x.ndim - v.ndim
        want = [Shard(p.dim - lead) if p.is_shard() and p.dim >= lead else q for p, q in zip(x.placements, v.placements)]
        return redistribute(v, x.device_mesh, want)

    vectors = [split_as_x(v) for v in vectors]
    inputs = {"x": x, **{f"v{i}": v for i, v in enumerate(vectors)}}
    free = {name: tuple(range(t.ndim)) for name, t in inputs.items()}
    return ops.on_local_shards("channelwise", fn, inputs, free, "x")


def replicated_like(t, ref):
    """``t`` (a tensor every rank computes alike) as a replicated DTensor on
    ``ref``'s mesh when ``ref`` is a DTensor, else ``t``: DTensor ops take no
    plain tensor beside a DTensor."""
    if not ops.is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, weight, eps: float = 1e-6):
    """The models' RMSNorm: the Hopper kernel on the card, its plain version
    on the CPU (:func:`repro_torch.kernels.ops.rmsnorm`)."""
    return ops.rmsnorm(x, weight, eps)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last axis with f32 moments, cast back to x's dtype.
    Plain PyTorch: in the reference this is XLA, not Pallas. On a mesh its
    rows run on each rank's shards (:func:`channelwise`)."""

    def norm(x, weight, bias):
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * weight.float() + bias.float()).to(x.dtype)

    return channelwise(norm, x, weight, bias)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponents)


def apply_rope(x, positions, theta: float = 1e4):
    """Split-half RoPE. x: (..., S, Dh); positions: (S,) or broadcastable (..., S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)  # (Dh/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, Dh/2)
    sin, cos = replicated_like(torch.sin(angles), x), replicated_like(torch.cos(angles), x)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention: chunked (the gradient of ops.attention) and single-shot (decode)
# ---------------------------------------------------------------------------


def _scale_in(x, head_dim: int):
    """x times ``head_dim**-0.5`` rounded to x's dtype, in x's dtype: the
    reference's weak-typed product (in bf16 at head dim 128 the scale is
    0.0883789)."""
    return x * torch.tensor(head_dim**-0.5, dtype=x.dtype).item()


def attention_chunked(q, k, v, *, causal: bool = True, window: int = 0, q_offset=0,
                      kv_chunk: int = 1024, logit_cap: float = 0.0):
    """Flash-style double-blocked attention (query blocks × KV chunks) with an
    online softmax, the reference's XLA path, differentiable by autograd.

    q: (B, Hq, Sq, Dh); k: (B, Hkv, Skv, Dh); v: (B, Hkv, Skv, Dv); GQA via
    Hq = G·Hkv. Ragged lengths are padded and masked. Causal self-attention
    (Sq == Skv after padding, ``q_offset`` 0) visits only the KV chunks at or
    below each query block's diagonal (and, with a window, not before it),
    the reference's triangular schedule; otherwise every chunk. Numerics as
    in the reference: q is multiplied by the scale rounded to its dtype, in
    its dtype; scores, the softmax carry and the PV sum are f32; ``p`` is
    cast to v's dtype before PV. Every tile's intermediates stay alive for
    the backward (the reference rematerialises per block): memory is
    O(Sq·Skv) under autograd.
    """
    B, Hq, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = Hq // Hkv
    chunk = min(kv_chunk, max(Skv, 1))
    valid_kv = Skv
    if Skv % chunk:  # pad ragged KV
        pad = chunk - Skv % chunk
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        Skv += pad
    n_kv = Skv // chunk
    valid_q = Sq
    qb = min(chunk, Sq)
    if Sq % qb:
        q = F.pad(q, (0, 0, 0, qb - Sq % qb))
        Sq = q.shape[2]
    n_q = Sq // qb

    qg = _scale_in(q.reshape(B, Hkv, G, n_q, qb, Dh), Dh)
    kc = k.reshape(B, Hkv, n_kv, chunk, Dh)
    vc = v.reshape(B, Hkv, n_kv, chunk, Dv)
    triangular = causal and Sq == Skv and not isinstance(q_offset, torch.Tensor) and q_offset == 0
    offset = 0 if triangular else q_offset
    outs = []
    for qi in range(n_q):
        lo, hi = 0, n_kv
        if triangular:
            hi = qi + 1
            if window > 0:
                lo = max(0, qi - (window + chunk - 1) // chunk)
        q_blk = qg[:, :, :, qi].float()
        q_pos = offset + qi * qb + torch.arange(qb, device=q.device)
        m = torch.full((B, Hkv, G, qb), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, Hkv, G, qb), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, Hkv, G, qb, Dv), dtype=torch.float32, device=q.device)
        for ci in range(lo, hi):
            k_pos = ci * chunk + torch.arange(chunk, device=q.device)
            s = torch.einsum("bhgqd,bhcd->bhgqc", q_blk, kc[:, :, ci].float())
            if logit_cap > 0:
                s = logit_cap * torch.tanh(s / logit_cap)
            mask = (k_pos[None, :] < valid_kv) & (q_pos[:, None] < valid_q + offset)
            if causal:
                mask &= k_pos[None, :] <= q_pos[:, None]
            if window > 0:
                mask &= q_pos[:, None] - k_pos[None, :] < window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            correction = torch.exp(m - m_new)
            l = l * correction + p.sum(dim=-1)
            pv = torch.einsum("bhgqc,bhcd->bhgqd", p.to(v.dtype).float(), vc[:, :, ci].float())
            acc = acc * correction[..., None] + pv
            m = m_new
        outs.append(acc / l.clamp_min(1e-30)[..., None])
    out = torch.stack(outs, dim=3)  # (B, Hkv, G, n_q, qb, Dv)
    return out.reshape(B, Hq, Sq, Dv)[:, :, :valid_q].to(q.dtype)


def attention_single_shot(q, k, v, *, mask=None, logit_cap: float = 0.0):
    """Naive attention for tiny Sq (decode): one (B,Hkv,G,Sq,Skv) score tensor.

    q: (B,Hq,Sq,Dh); k, v: (B,Hkv,Skv,Dh); mask broadcastable to the scores.
    q is scaled in its own dtype by ``Dh**-0.5`` rounded to that dtype, as
    the reference's weak-typed product does (in bf16 at Dh 128 the scale is
    0.0883789 and the product rounds to bf16). Scores and the PV sum in f32;
    p is cast to v's dtype first, as in the reference. Plain PyTorch: in the
    reference this is XLA, not Pallas.

    DTensors take the split-KV route (flash-decoding, what GSPMD makes of the
    reference's function when the cache's ``kv_seq`` dim is sharded): K and V
    may be split over their rows and their sequence, q is brought to K's rows
    (every head), and ``mask`` (a plain tensor over the global keys, or a
    DTensor) is cut to this rank's keys. Each rank scores its own keys; the
    max, then the sum of exponentials against that global max, then the f32
    PV partial sums are all-reduced over the mesh dims that split the keys.
    Forward only (decode runs without a gradient)."""
    if ops.is_dtensor(k):
        return _split_kv_attention(q, k, v, mask, logit_cap)
    return _single_shot(q, k, v, mask, logit_cap, None)


def _single_shot(q, k, v, mask, logit_cap: float, groups):
    """:func:`attention_single_shot`'s arithmetic on plain tensors; with
    ``groups`` (process groups of the mesh dims that split the keys) its
    three reductions over the keys are completed across them
    (:func:`split_softmax_context`)."""
    B, Hq, Sq, Dh = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qg = _scale_in(q.reshape(B, Hkv, G, Sq, Dh), Dh).float()
    s = torch.einsum("bhgqd,bhsd->bhgqs", qg, k.float())
    if logit_cap > 0:
        s = logit_cap * torch.tanh(s / logit_cap)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    out = split_softmax_context(s, v, "bhgqs,bhsd->bhgqd", groups)
    return out.reshape(B, Hq, Sq, v.shape[-1]).to(q.dtype)


def split_softmax_context(s, values, equation: str, groups, f32: bool = True):
    """``softmax(s)`` over its last dim (the keys; f32 scores, masked keys
    at ``NEG_INF``) applied to ``values`` by the einsum ``equation``, its
    three reductions over the keys completed across ``groups`` (process
    groups of the mesh dims that split the keys): the max, the sum of
    exponentials against the global max, the context. The weights are cast
    to ``values``' dtype before the product, as the reference does, so a
    key's weight is the same on every mesh, and a shard whose keys are all
    masked adds exactly 0 (its exponentials are exp(NEG_INF - max)). The
    product runs in f32 (its partial sums all-reduced in f32) when ``f32``
    or ``groups`` is not empty, else in ``values``' dtype; the caller casts
    the result."""
    import torch.distributed as dist

    groups = groups or ()
    m = s.amax(dim=-1, keepdim=True)
    for g in groups:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    for g in groups:
        dist.all_reduce(l, group=g)
    w = (p / l.clamp_min(1e-30)).to(values.dtype)
    if not (f32 or groups):
        return torch.einsum(equation, w, values)
    out = torch.einsum(equation, w.float(), values.float())
    for g in groups:
        dist.all_reduce(out, group=g)
    return out


def split_kv_layout(what: str, inputs: tuple, k, v, mask, seq: int):
    """The layout of a split-KV reduction over the keys (dim ``seq``) of the
    DTensors ``k`` and ``v``, which must be split alike, over their rows and
    keys only: (the placements of K's rows, every other dim whole; the
    process groups of the mesh dims that split the keys; ``mask``, a plain
    tensor or a DTensor over the global keys in its last dim, cut to this
    rank's rows, unless broadcast over them, and keys). Forward only: raises
    when any of ``inputs`` requires a gradient."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel.sharding import distribute, redistribute

    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise NotImplementedError(f"{what}: the split-KV route is forward only")
    mesh = k.device_mesh
    if tuple(v.placements) != tuple(k.placements) or any(
            p.is_partial() or (p.is_shard() and p.dim not in (0, seq)) for p in k.placements):
        raise ValueError(f"{what}: {k.placements} and {v.placements} must be split alike, over their rows and "
                         "keys only")
    rows = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in k.placements)
    groups = [mesh.get_group(i) for i, p in enumerate(k.placements) if p.is_shard(seq) and mesh.size(i) > 1]
    if mask is not None:
        want = tuple(Shard(mask.ndim - 1) if p.is_shard(seq) else Shard(0) if p.is_shard(0) and mask.shape[0] > 1
                     else Replicate() for p in k.placements)
        mask = (redistribute(mask, mesh, want) if ops.is_dtensor(mask) else distribute(mask, mesh, want)).to_local()
    return rows, groups, mask


def _split_kv_attention(q, k, v, mask, logit_cap: float):
    """The split-KV route of :func:`attention_single_shot` (DTensor q, k, v)."""
    from repro_torch.parallel.sharding import from_local, redistribute

    rows, groups, mask = split_kv_layout("attention_single_shot", (q, k, v), k, v, mask, 2)
    q = redistribute(q, k.device_mesh, rows)  # every head, K's rows
    out = _single_shot(q.to_local(), k.to_local(), v.to_local(), mask, logit_cap, groups)
    return from_local(out, k.device_mesh, rows, (*q.shape[:3], v.shape[-1]))


def causal_mask(sq: int, skv: int, q_offset=0, device=None):
    q_pos = q_offset + torch.arange(sq, device=device)
    k_pos = torch.arange(skv, device=device)
    return (k_pos[None, :] <= q_pos[:, None])[None, None, None]


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def swiglu(x, wg, wi, wo, dtype):
    g = torch.einsum("bsd,df->bsf", x, wg.to(dtype))
    h = torch.einsum("bsd,df->bsf", x, wi.to(dtype))
    h = shard(F.silu(g) * h, "batch", None, "ff")
    return torch.einsum("bsf,fd->bsd", h, wo.to(dtype))


def geglu(x, wg, wi, wo, dtype):
    """GeGLU MLP. ``jax.nn.gelu`` defaults to the tanh approximation, and so
    does this."""
    g = torch.einsum("bsd,df->bsf", x, wg.to(dtype))
    h = torch.einsum("bsd,df->bsf", x, wi.to(dtype))
    h = shard(F.gelu(g, approximate="tanh") * h, "batch", None, "ff")
    return torch.einsum("bsf,fd->bsd", h, wo.to(dtype))


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy(logits, labels, *, z_loss: float = 1e-4):
    """Token-level cross-entropy with z-loss over every logit given (the
    padded vocab included). labels == -100 (any negative label) are masked
    out. Returns (mean loss, {"ce", "accuracy"}), each a 0-dim f32 tensor
    (replicated DTensors when ``logits`` is a DTensor: see
    :func:`_cross_entropy_sharded`)."""
    if ops.is_dtensor(logits):
        return _cross_entropy_sharded(logits, labels, z_loss)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    valid = labels >= 0
    gold = logits.gather(-1, labels.long().clamp_min(0)[..., None])[..., 0]
    gold = torch.where(valid, gold, 0.0)
    mask = valid.float()
    ce = (lse - gold) * mask
    zl = z_loss * lse.square() * mask
    denom = mask.sum().clamp_min(1.0)
    loss = (ce + zl).sum() / denom
    acc = ((logits.argmax(dim=-1) == labels) * mask).sum() / denom
    return loss, {"ce": ce.sum() / denom, "accuracy": acc}


class _VocabParallelLSE(torch.autograd.Function):
    """Per-row logsumexp, gold logit and argmax of f32 logits whose vocab dim
    is sharded over ``group`` (Megatron's vocab-parallel cross-entropy): x
    (..., V_loc) is this rank's columns, from vocab id ``v0``. The forward
    all-reduces three row vectors (max, sum of exponentials, gold logit) and
    one for the argmax; the backward is local: softmax · g_lse + onehot ·
    g_gold on this rank's columns. No rank holds another's logits."""

    @staticmethod
    def forward(ctx, x, labels, group, v0):
        import torch.distributed as dist

        v_loc = x.shape[-1]
        local_max, local_arg = x.max(dim=-1)
        m = local_max.clone()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(x - m[..., None])
        total = e.sum(dim=-1)
        dist.all_reduce(total, group=group)
        lse = torch.log(total) + m
        local = labels.long() - v0
        inside = (local >= 0) & (local < v_loc)
        local = local.clamp(0, v_loc - 1)
        gold = torch.where(inside, x.gather(-1, local[..., None])[..., 0], 0.0)
        dist.all_reduce(gold, group=group)
        # the first index of the row's largest logit, as argmax gives it
        pred = torch.where(local_max == m, local_arg + v0, torch.iinfo(torch.int64).max)
        dist.all_reduce(pred, op=dist.ReduceOp.MIN, group=group)
        ctx.save_for_backward(e / total[..., None], local, inside)
        ctx.mark_non_differentiable(pred)
        return lse, gold, pred

    @staticmethod
    def backward(ctx, g_lse, g_gold, _):
        p, local, inside = ctx.saved_tensors
        dx = p * g_lse[..., None]
        dx.scatter_add_(-1, local[..., None], torch.where(inside, g_gold, 0.0)[..., None])
        return dx, None, None, None


def _cross_entropy_sharded(logits, labels, z_loss: float):
    """:func:`cross_entropy` of DTensor logits (B, S, V): each rank computes
    its rows' terms from its local shard, with the vocab dim through
    :class:`_VocabParallelLSE` where it is sharded, and the sums over rows
    are all-reduced over the batch's mesh dims before the division. On a mesh
    of one rank it is the plain function's arithmetic, op for op."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = logits.device_mesh
    last = logits.ndim - 1
    if any(p.is_partial() for p in logits.placements):
        raise ValueError(f"cross_entropy: logits placements {logits.placements} hold partial sums")
    vocab = [i for i, p in enumerate(logits.placements) if p.is_shard(last)]
    rows = [Replicate() if p.is_shard(last) else p for p in logits.placements]
    if tuple(labels.placements) != tuple(rows):
        labels = labels.redistribute(mesh, rows)
    x, y = logits.to_local().float(), labels.to_local()
    if vocab:
        if len(vocab) > 1:
            raise ValueError(f"cross_entropy: the vocab dim is sharded over {len(vocab)} mesh dims")
        lse, gold, pred = _VocabParallelLSE.apply(x, y, mesh.get_group(vocab[0]),
                                                  mesh.get_local_rank(vocab[0]) * x.shape[-1])
    else:
        lse = torch.logsumexp(x, dim=-1)
        gold = x.gather(-1, y.long().clamp_min(0)[..., None])[..., 0]
        pred = x.argmax(dim=-1)
    valid = y >= 0
    gold = torch.where(valid, gold, 0.0)
    mask = valid.float()
    ce = (lse - gold) * mask
    zl = z_loss * lse.square() * mask
    summed = [Partial() if p.is_shard() else Replicate() for p in rows]
    everywhere = [Replicate()] * mesh.ndim

    def total(t):
        return DTensor.from_local(t, mesh, summed, run_check=False).redistribute(mesh, everywhere)

    denom = total(mask.sum()).clamp_min(1.0)
    loss = total((ce + zl).sum()) / denom
    acc = total(((pred == y) * mask).sum()) / denom
    return loss, {"ce": total(ce.sum()) / denom, "accuracy": acc}
