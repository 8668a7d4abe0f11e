"""Dispatch over the port's kernels.

A CPU tensor goes to the plain version in :mod:`repro_torch.kernels.ref`; a
CUDA tensor launches the Hopper kernel, or the kernel's wrapper raises on a
device, dtype, shape or contiguity it does not take. There is no fallback from
the kernel to the plain version, and ``ArchConfig.use_pallas`` switches nothing
here.

Gradients, as in the reference's ``custom_vjp``s (``repro/kernels/ops.py``):
``attention``, ``rmsnorm``, ``lru_scan`` and ``wkv6`` are
``torch.autograd.Function``s whose forward is the kernel (or, on the CPU, the
plain version) and whose backward takes the gradient of the reference's XLA
path under autograd, recomputed from the saved inputs:

* ``attention``: :func:`repro_torch.models.common.attention_chunked`;
* ``rmsnorm``: :func:`.ref.rmsnorm_ref` (the reference's ``rms_norm``);
* ``lru_scan``: :func:`lru_assoc`, the log-depth associative scan in f32 with
  h0 folded into the first step (the reference's ``_lru_xla``), for a, b and
  h0;
* ``wkv6``: :func:`repro_torch.models.rwkv6.wkv6_chunked`, the chunked form
  (the reference's ``_wkv6_bwd``), for r, k, v, w, u and s0. It needs
  T % min(64, T) == 0, so ``wkv6`` refuses another T up front when a
  gradient is required.

No backward launches a kernel. ``moe_gating`` has no backward, as the
reference's gating kernel has none: on a tensor off the CPU that requires grad
it raises, and never returns a result cut from the graph (the MoE layer routes
on detached logits and recomputes its gates differentiably).
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
# RG-LRU linear recurrence
# ---------------------------------------------------------------------------


def lru_assoc(a, b, h0):
    """The reference's ``_lru_xla``: h_t = a_t ⊙ h_{t-1} + b_t in f32 with h0
    folded into the first step (b_0 + a_0·h0), as a log-depth scan of
    (a2, b2) ∘ (a1, b1) = (a1·a2, a2·b1 + b2): ceil(log2 T) doubling steps,
    each combining every position with the one ``shift`` before it. Returns
    (h_seq in a's dtype, h_final f32)."""
    A, Bc = a.float(), b.float()
    Bc = torch.cat([Bc[:, :1] + A[:, :1] * h0.float()[:, None], Bc[:, 1:]], dim=1)
    shift = 1
    while shift < a.shape[1]:
        Bc = torch.cat([Bc[:, :shift], Bc[:, :-shift] * A[:, shift:] + Bc[:, shift:]], dim=1)
        A = torch.cat([A[:, :shift], A[:, :-shift] * A[:, shift:]], dim=1)
        shift *= 2
    return Bc.to(a.dtype), Bc[:, -1]


def _lru_fwd(a, b, h0):
    if a.device.type == "cpu":
        return ref.lru_ref(a, b, h0)
    return _lru.lru_scan(a, b, h0)


class _LRUScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, h0):
        ctx.save_for_backward(a, b, h0)
        return _lru_fwd(a, b, h0)

    @staticmethod
    def backward(ctx, g_seq, g_final):
        return _grad_of(lru_assoc, ctx.saved_tensors, (g_seq, g_final))


def lru_scan(a, b, h0):
    """h_t = a_t ⊙ h_{t-1} + b_t over (B, T, W) from h0 (B, W) f32; returns
    (h_seq in a's dtype, h_final f32). Any T."""
    if _wants_grad(a, b, h0):
        return _LRUScan.apply(a, b, h0)
    return _lru_fwd(a, b, h0)


# ---------------------------------------------------------------------------
# RWKV-6 WKV
# ---------------------------------------------------------------------------

WKV_CHUNK = 64  # the chunk of the backward's recompute, the reference's default


def _wkv6_fwd(r, k, v, w, u, s0):
    if r.device.type == "cpu":
        return ref.wkv6_ref(r, k, v, w, u, s0)
    return _wkv.wkv6(r, k, v, w, u, s0)


class _WKV6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.save_for_backward(r, k, v, w, u, s0)
        return _wkv6_fwd(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, g_y, g_s):
        from repro_torch.models.rwkv6 import wkv6_chunked  # rwkv6 imports this module

        return _grad_of(lambda *x: wkv6_chunked(*x, chunk=WKV_CHUNK), ctx.saved_tensors, (g_y, g_s))


def wkv6(r, k, v, w, u, s0):
    """RWKV-6 WKV recurrence. r, k, w: (B, H, T, dk); v: (B, H, T, dv); u:
    (H, dk); s0: (B, H, dk, dv) f32. Returns (y in r's dtype, S_final f32).
    Any T without a gradient; with one, T % min(64, T) == 0, the chunked
    form's rule (ROADMAP H4)."""
    if _wants_grad(r, k, v, w, u, s0):
        T = r.shape[2]
        if T % min(WKV_CHUNK, T):
            raise ValueError(f"ops.wkv6: the gradient's chunked form takes T % min({WKV_CHUNK}, T) == 0, "
                             f"not T = {T}")
        return _WKV6.apply(r, k, v, w, u, s0)
    return _wkv6_fwd(r, k, v, w, u, s0)


# ---------------------------------------------------------------------------
# MoE gating (forward only)
# ---------------------------------------------------------------------------


def moe_gating(logits, *, top_k: int, capacity: int, renormalise: bool = True):
    """MoE routing decision per group. logits: (G, N, E) f32 → (idx (G, N, k)
    int32, gate (G, N, k) f32, pos (G, N, k) int32, -1 where dropped)."""
    if logits.device.type == "cpu":
        return ref.moe_gating_ref(logits, top_k=top_k, capacity=capacity, renormalise=renormalise)
    if _wants_grad(logits):
        raise NotImplementedError(
            f"ops.moe_gating: the kernel has no backward; on {logits.device} it runs only where "
            "no gradient is required (route on detached logits, or under torch.no_grad)"
        )
    return _gating.moe_gating(logits, top_k=top_k, capacity=capacity, renormalise=renormalise)
