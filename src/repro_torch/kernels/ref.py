"""Plain PyTorch versions of the port's kernels.

Each function is the semantic definition its kernel must match: the CPU path
of :mod:`repro_torch.kernels.ops` runs it, the CPU tests hold it against the
JAX package, and ``chip_smoke.py`` holds each kernel against it on the card.
They are deliberately naive (attention materialises the full score matrix).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0, logit_cap: float = 0.0):
    """q: (B,Hq,Sq,d); k: (B,Hkv,Skv,d); v: (B,Hkv,Skv,dv); GQA via Hq = G·Hkv.

    Returns (B,Hq,Sq,dv) in q's dtype. O(Sq·Skv) memory.
    """
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (d**-0.5)
    if logit_cap > 0:
        s = logit_cap * torch.tanh(s / logit_cap)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= q_pos - k_pos < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def rmsnorm_ref(x, weight, eps: float = 1e-6):
    """Row-wise RMSNorm over the last axis in f32, cast back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * weight.float()
    return y.to(x.dtype)
