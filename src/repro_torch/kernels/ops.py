"""Dispatch over the port's kernels.

A CPU tensor goes to the plain version in :mod:`repro_torch.kernels.ref`; a
CUDA tensor launches the Hopper kernel, or the kernel's wrapper raises on a
device, dtype, shape or contiguity it does not take. There is no fallback from
the kernel to the plain version, and ``ArchConfig.use_pallas`` switches nothing
here.

Gradients, as in the reference's ``custom_vjp``s (``repro/kernels/ops.py``):
``attention`` and ``rmsnorm`` are ``torch.autograd.Function``s whose forward
is the kernel (or, on the CPU, the plain version) and whose backward takes
the gradient of the plain PyTorch path under autograd, recomputed from the
saved inputs: :func:`repro_torch.models.common.attention_chunked` for
attention, :func:`.ref.rmsnorm_ref` (the reference's ``rms_norm``) for the
norm. The backward launches no kernel. ``lru_scan``, ``wkv6`` and
``moe_gating`` have no backward yet: on a tensor off the CPU that requires
grad they raise, and never return a result cut from the graph.
"""

from __future__ import annotations

import torch

from . import flash_attention as _fa
from . import moe_gating as _gating
from . import ref
from . import rglru_scan as _lru
from . import rmsnorm as _rn
from . import rwkv6_scan as _wkv


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _no_grad_on_card(name: str, *tensors) -> None:
    if _wants_grad(*tensors):
        raise NotImplementedError(
            f"ops.{name}: the kernel has no backward yet; on {tensors[0].device} it runs "
            "only where no gradient is required (torch.no_grad / inference_mode)"
        )


def _grad_of(fn, inputs, grad_out):
    """Gradients of ``fn(*inputs)`` against ``grad_out``, by autograd through
    ``fn`` recomputed from detached copies of the inputs."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        return torch.autograd.grad(fn(*leaves), leaves, grad_out)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _attention_fwd(q, k, v, causal, window, logit_cap):
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window, logit_cap=logit_cap)
    return _fa.flash_attention(q, k, v, causal=causal, window=window, logit_cap=logit_cap)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_cap, kv_chunk):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, logit_cap=logit_cap, kv_chunk=kv_chunk)
        return _attention_fwd(q, k, v, causal, window, logit_cap)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.models.common import attention_chunked  # common imports this module

        dq, dk, dv = _grad_of(lambda q, k, v: attention_chunked(q, k, v, **ctx.opts), ctx.saved_tensors, g)
        return dq, dk, dv, None, None, None, None


def attention(q, k, v, *, causal: bool = True, window: int = 0, logit_cap: float = 0.0, kv_chunk: int = 1024):
    """(B,Hq,Sq,d) × (B,Hkv,Skv,d), (B,Hkv,Skv,dv) → (B,Hq,Sq,dv); GQA by head
    ratio. ``kv_chunk`` is the KV chunk of the backward's recompute."""
    if _wants_grad(q, k, v):
        return _Attention.apply(q, k, v, causal, window, logit_cap, kv_chunk)
    return _attention_fwd(q, k, v, causal, window, logit_cap)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def _rmsnorm_fwd(x, w, eps):
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, w, eps)
    return _rn.rmsnorm(x, w, eps)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rmsnorm_fwd(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        dx, dw = _grad_of(lambda x, w: ref.rmsnorm_ref(x, w, ctx.eps), ctx.saved_tensors, g)
        return dx, dw, None


def rmsnorm(x, w, eps: float = 1e-6):
    """Row-wise RMSNorm over the last axis; f32 moments, x's dtype out."""
    if _wants_grad(x, w):
        return _RMSNorm.apply(x, w, eps)
    return _rmsnorm_fwd(x, w, eps)


# ---------------------------------------------------------------------------
# Forward-only kernels
# ---------------------------------------------------------------------------


def lru_scan(a, b, h0):
    """h_t = a_t ⊙ h_{t-1} + b_t over (B, T, W) from h0 (B, W) f32; returns
    (h_seq in a's dtype, h_final f32). Any T."""
    if a.device.type == "cpu":
        return ref.lru_ref(a, b, h0)
    _no_grad_on_card("lru_scan", a, b, h0)
    return _lru.lru_scan(a, b, h0)


def wkv6(r, k, v, w, u, s0):
    """RWKV-6 WKV recurrence. r, k, w: (B, H, T, dk); v: (B, H, T, dv); u:
    (H, dk); s0: (B, H, dk, dv) f32. Returns (y in r's dtype, S_final f32).
    Any T."""
    if r.device.type == "cpu":
        return ref.wkv6_ref(r, k, v, w, u, s0)
    _no_grad_on_card("wkv6", r, k, v, w, u, s0)
    return _wkv.wkv6(r, k, v, w, u, s0)


def moe_gating(logits, *, top_k: int, capacity: int, renormalise: bool = True):
    """MoE routing decision per group. logits: (G, N, E) f32 → (idx (G, N, k)
    int32, gate (G, N, k) f32, pos (G, N, k) int32, -1 where dropped)."""
    if logits.device.type == "cpu":
        return ref.moe_gating_ref(logits, top_k=top_k, capacity=capacity, renormalise=renormalise)
    _no_grad_on_card("moe_gating", logits)
    return _gating.moe_gating(logits, top_k=top_k, capacity=capacity, renormalise=renormalise)
