"""Shared model machinery of the port, the serving subset of
``repro.models.common``: parameter definitions, seeded init, RMSNorm,
LayerNorm, RoPE, decode attention, the causal mask, SwiGLU and GeGLU.

Layouts follow the reference at every public function: projections
``(D, H, hd)``, per-layer weights stacked on a leading ``layers`` axis, the KV
cache ``(L, B, Hkv, S, hd)``. A model is a nested dict of :class:`ParamDef`
leaves; :func:`init_params` turns it into tensors. The reference draws its
weights from ``jax.random``, so the numbers differ; parity tests copy the
reference's weights across with :mod:`repro_torch.convert`.

Left out until the training slice: ``cross_entropy``,
``sinusoidal_positions`` and ``attention_chunked``.
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


def map_defs(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict, keys in sorted order (the
    order in which JAX flattens a dict)."""
    if isinstance(tree, dict):
        return {k: map_defs(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


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
# Attention (decode path; prefill attention is ops.attention)
# ---------------------------------------------------------------------------


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
    scale = torch.tensor(Dh**-0.5, dtype=q.dtype).item()
    qg = (q.reshape(B, Hkv, G, Sq, Dh) * scale).float()
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
