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

Left out: the logical sharding constraints (one card has no mesh) and
``sinusoidal_positions``, which no model of the reference calls.
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
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, weight, eps: float = 1e-6):
    """The models' RMSNorm: the Hopper kernel on the card, its plain version
    on the CPU (:func:`repro_torch.kernels.ops.rmsnorm`)."""
    return ops.rmsnorm(x, weight, eps)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last axis with f32 moments, cast back to x's dtype.
    Plain PyTorch: in the reference this is XLA, not Pallas."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


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
    sin, cos = torch.sin(angles), torch.cos(angles)
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
    """
    B, Hq, Sq, Dh = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qg = _scale_in(q.reshape(B, Hkv, G, Sq, Dh), Dh).float()
    s = torch.einsum("bhgqd,bhsd->bhgqs", qg, k.float())
    if logit_cap > 0:
        s = logit_cap * torch.tanh(s / logit_cap)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    w = (p / l.clamp_min(1e-30)).to(v.dtype)
    out = torch.einsum("bhgqs,bhsd->bhgqd", w.float(), v.float())
    return out.reshape(B, Hq, Sq, Dh).to(q.dtype)


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
    return torch.einsum("bsf,fd->bsd", F.silu(g) * h, wo.to(dtype))


def geglu(x, wg, wi, wo, dtype):
    """GeGLU MLP. ``jax.nn.gelu`` defaults to the tanh approximation, and so
    does this."""
    g = torch.einsum("bsd,df->bsf", x, wg.to(dtype))
    h = torch.einsum("bsd,df->bsf", x, wi.to(dtype))
    return torch.einsum("bsf,fd->bsd", F.gelu(g, approximate="tanh") * h, wo.to(dtype))


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy(logits, labels, *, z_loss: float = 1e-4):
    """Token-level cross-entropy with z-loss over every logit given (the
    padded vocab included). labels == -100 (any negative label) are masked
    out. Returns (mean loss, {"ce", "accuracy"}), each a 0-dim f32 tensor."""
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
