"""Dispatch over the port's kernels, forward only.

A CPU tensor goes to the plain version in :mod:`repro_torch.kernels.ref`; a
CUDA tensor launches the Hopper kernel, or the kernel's wrapper raises on a
device, dtype, shape or contiguity it does not take. There is no fallback from
the kernel to the plain version, and ``ArchConfig.use_pallas`` switches nothing
here. The ``autograd.Function``s with backward kernels come with training.
"""

from __future__ import annotations

from . import flash_attention as _fa
from . import moe_gating as _gating
from . import ref
from . import rglru_scan as _lru
from . import rmsnorm as _rn
from . import rwkv6_scan as _wkv


def attention(q, k, v, *, causal: bool = True, window: int = 0, logit_cap: float = 0.0):
    """(B,Hq,Sq,d) × (B,Hkv,Skv,d), (B,Hkv,Skv,dv) → (B,Hq,Sq,dv); GQA by head ratio."""
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window, logit_cap=logit_cap)
    return _fa.flash_attention(q, k, v, causal=causal, window=window, logit_cap=logit_cap)


def rmsnorm(x, w, eps: float = 1e-6):
    """Row-wise RMSNorm over the last axis; f32 moments, x's dtype out."""
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, w, eps)
    return _rn.rmsnorm(x, w, eps)


def lru_scan(a, b, h0):
    """h_t = a_t ⊙ h_{t-1} + b_t over (B, T, W) from h0 (B, W) f32; returns
    (h_seq in a's dtype, h_final f32). Any T."""
    if a.device.type == "cpu":
        return ref.lru_ref(a, b, h0)
    return _lru.lru_scan(a, b, h0)


def wkv6(r, k, v, w, u, s0):
    """RWKV-6 WKV recurrence. r, k, w: (B, H, T, dk); v: (B, H, T, dv); u:
    (H, dk); s0: (B, H, dk, dv) f32. Returns (y in r's dtype, S_final f32).
    Any T."""
    if r.device.type == "cpu":
        return ref.wkv6_ref(r, k, v, w, u, s0)
    return _wkv.wkv6(r, k, v, w, u, s0)


def moe_gating(logits, *, top_k: int, capacity: int, renormalise: bool = True):
    """MoE routing decision per group. logits: (G, N, E) f32 → (idx (G, N, k)
    int32, gate (G, N, k) f32, pos (G, N, k) int32, -1 where dropped)."""
    if logits.device.type == "cpu":
        return ref.moe_gating_ref(logits, top_k=top_k, capacity=capacity, renormalise=renormalise)
    return _gating.moe_gating(logits, top_k=top_k, capacity=capacity, renormalise=renormalise)
