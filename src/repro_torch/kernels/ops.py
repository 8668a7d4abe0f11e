"""Dispatch over the port's kernels, forward only.

A CPU tensor goes to the plain version in :mod:`repro_torch.kernels.ref`; a
CUDA tensor launches the Hopper kernel, or the kernel's wrapper raises on a
device, dtype, shape or contiguity it does not take. There is no fallback from
the kernel to the plain version, and ``ArchConfig.use_pallas`` switches nothing
here. The ``autograd.Function``s with backward kernels come with training.
"""

from __future__ import annotations

from . import flash_attention as _fa
from . import ref
from . import rmsnorm as _rn


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
