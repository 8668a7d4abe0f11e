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

A ``meta`` tensor (a step counted without running it,
:mod:`repro_torch.analysis.opstats`) takes the meta route: the op makes the
wrapper's device-independent checks (it refuses what the card's wrapper
refuses, but for the 16-byte alignment a meta tensor has not), allocates
what the wrapper allocates (empty meta outputs of the kernel's shapes and
dtypes, and its scratch) and reports the call to the active count: the
launch counts the wrapper adds one to (by the wrapper's own rule, under the
names ``chip_smoke.py`` reads) and the kernel's work
(:mod:`repro_torch.analysis.roofline`). It runs neither the kernel nor the
plain version. Under a gradient the backward is the same plain recompute as
on the card, so the count sees its ops as the card runs them.

No backward launches a kernel. ``moe_gating`` has no backward, as the
reference's gating kernel has none: on a tensor off the CPU that requires grad
it raises, and never returns a result cut from the graph (the MoE layer routes
on detached logits and recomputes its gates differentiably).

DTensors (a step on a device mesh, :mod:`repro_torch.parallel.sharding`): the
kernels are bound through ctypes with raw pointers, so a DTensor never reaches
them. ``attention``, ``rmsnorm`` and ``moe_gating`` take the local-shard route:
each DTensor input is replaced by its local shard, the op runs on the shards
as above, and its outputs are wrapped back with the inputs' placements. That
is exact only over dims the kernel treats independently (attention: batch and
heads; RMSNorm: its rows; K5: the groups), so a placement on a dim the kernel
reduces over, or a partial sum, raises; nothing is gathered quietly.
``lru_scan`` (batch and the ``lru`` channels) and ``wkv6`` (batch and heads;
``u`` split with its heads) take the same route; their T dim is never split
(the ``seq`` rule is off unless ``seq_shard``), and a split T raises. Every
input of a route must be split as its first is, dim for dim. Autograd runs
through the route (``to_local`` / ``from_local``): the backward recomputes
the plain path on the shards, as on one device.
"""

from __future__ import annotations

import sys

import torch

from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from repro_torch.analysis.roofline import attention_work, lru_work, moe_gating_work, rmsnorm_work, wkv6_work

from . import flash_attention as _fa
from . import moe_gating as _gating
from . import ref
from . import rglru_scan as _lru
from . import rmsnorm as _rn
from . import rwkv6_scan as _wkv


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed.tensor.DTensor`` (without
    importing that module: no DTensor exists before it is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def on_local_shards(what: str, fn, inputs, free: dict, out_from: str, out_placements=None):
    """``fn`` on the local shards of the DTensor ``inputs`` (name → tensor),
    its outputs wrapped back as DTensors with the placements of
    ``inputs[out_from]`` (or ``out_placements``, one tuple an output).
    ``free`` names each input's dims that the op treats independently (None:
    the input must be replicated); a shard on any other dim, or a partial
    sum, raises."""
    from torch.distributed.tensor import DTensor, Partial

    mesh = inputs[out_from].device_mesh
    for name, t in inputs.items():
        if not is_dtensor(t) or t.device_mesh != mesh:
            raise TypeError(f"ops.{what}: {name} is not a DTensor on the mesh of {out_from}")
        for p in t.placements:
            if p.is_partial():
                raise ValueError(f"ops.{what}: {name} holds partial sums ({t.placements}); redistribute it first")
            if p.is_shard() and p.dim % t.ndim not in (free[name] or ()):
                raise ValueError(f"ops.{what}: {name} {tuple(t.shape)} is sharded on dim {p.dim} "
                                 f"({t.placements}), which the kernel does not treat independently")
    placements = inputs[out_from].placements
    # an input replicated over a mesh dim that splits the output has a partial
    # local gradient there (a norm's weight sees only this rank's rows)
    out = fn(*(t.to_local(grad_placements=[Partial() if o.is_shard() and p.is_replicate() else p
                                           for o, p in zip(placements, t.placements)])
               for t in inputs.values()))
    if out_placements is not None:
        return tuple(DTensor.from_local(o, mesh, pl, run_check=False) for o, pl in zip(out, out_placements))
    wrap = lambda o: DTensor.from_local(o, mesh, placements, run_check=False)  # noqa: E731
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def split_like(placements, dims: dict) -> tuple:
    """The placements of a tensor whose dim ``dims[d]`` is the first input's
    dim d (a dim missing from ``dims``: not in this tensor, so replicated)."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(dims[p.dim]) if p.is_shard() and p.dim in dims else
                 Replicate() if p.is_shard() else p for p in placements)


def _check_split(what: str, first: str, inputs: dict, dims: dict) -> None:
    """Every input split as ``inputs[first]`` is, dim for dim (``dims``: name →
    {first's dim: this input's dim}), or a ValueError naming the op."""
    want = inputs[first].placements
    for name, t in inputs.items():
        if is_dtensor(t) and tuple(t.placements) != split_like(want, dims[name]):
            raise ValueError(f"ops.{what}: {name} {tuple(t.placements)} is not split as {first} "
                             f"{tuple(want)}")


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _grad_of(fn, inputs, grad_out):
    """Gradients of ``fn(*inputs)`` against ``grad_out``, by autograd through
    ``fn`` recomputed from detached copies of the inputs."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        return torch.autograd.grad(fn(*leaves), leaves, grad_out)


# the launch counts' names as chip_smoke.py reads them: a module's
# ``launches`` under its kernel's name, ``<x>_launches`` as ``<kernel>_<x>``
_KERNEL_NAMES = {_fa: "flash_attention", _rn: "rmsnorm", _lru: "lru_scan", _wkv: "wkv6", _gating: "moe_gating"}


def launch_counts() -> dict:
    """Every wrapper's launch counts now, keyed (wrapper module, count name).
    A CUDA graph's capture runs no kernel: what a capture adds to these is
    what each replay launches (:class:`repro_torch.training.graph.Captured`)."""
    return {(module, name): n for module in _KERNEL_NAMES for name, n in vars(module).items()
            if name.endswith("launches") and type(n) is int}


def add_launch_counts(counts: dict, times: int = 1) -> None:
    """Add ``times`` times each of ``counts`` (keyed as :func:`launch_counts`
    keys them) to the wrappers' counts."""
    for (module, name), n in counts.items():
        setattr(module, name, getattr(module, name) + times * n)


def _record(module, counts: tuple, work: tuple, scratch_bytes: int = 0) -> None:
    """Report one meta call of ``module``'s kernel to the innermost active
    dispatch mode that takes records (:func:`repro_torch.analysis.opstats.count`'s),
    if any: the launch counts ``counts`` that the wrapper adds one to, the
    kernel's ``work`` (FLOPs, bytes, unit) and the HBM traffic of its
    scratch."""
    kernel = _KERNEL_NAMES[module]
    names = tuple(kernel if c == "launches" else f"{kernel}_{c.removesuffix('_launches')}" for c in counts)
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if hasattr(mode, "record_kernel"):
            mode.record_kernel(names, work, scratch_bytes)
            return


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _attention_meta(q, k, v, causal, window):
    """The meta route of K1: the output, and the f32 split pass's scratch
    allocated and freed as the wrapper does (its bytes written once and read
    once)."""
    _fa.check_inputs(q, k, v)
    B, Hq, Sq, d = q.shape
    Hkv, Skv, dv = v.shape[1], v.shape[2], v.shape[3]
    out = torch.empty((B, Hq, Sq, dv), dtype=q.dtype, device=q.device)
    n_ws = _fa.workspace_floats(q.dtype, B, Hkv, Skv, d, dv)
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device) if n_ws else None
    _record(_fa, (_fa.launch_count(q.dtype, d, dv),),
            attention_work(B, Hq, Hkv, Sq, Skv, d, dv, q.dtype, causal, window), 2 * 4 * n_ws)
    del ws
    return out


def _attention_fwd(q, k, v, causal, window, logit_cap):
    if q.device.type == "meta":
        return _attention_meta(q, k, v, causal, window)
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
    ratio. ``kv_chunk`` is the KV chunk of the backward's recompute.
    DTensors take the local-shard route over batch and heads; q, k and v
    must be sharded alike (a query-head shard maps to the KV heads of the
    same shard only when both are split the same way)."""
    if is_dtensor(q):
        if not (tuple(q.placements) == tuple(k.placements) == tuple(v.placements)):
            raise ValueError(f"ops.attention: q {q.placements}, k {k.placements} and v {v.placements} are not "
                             "sharded alike; repeat K and V to the query heads before sharding them")
        return on_local_shards(
            "attention", lambda q, k, v: attention(q, k, v, causal=causal, window=window, logit_cap=logit_cap,
                                                   kv_chunk=kv_chunk),
            {"q": q, "k": k, "v": v}, {"q": (0, 1), "k": (0, 1), "v": (0, 1)}, "q")
    if _wants_grad(q, k, v):
        return _Attention.apply(q, k, v, causal, window, logit_cap, kv_chunk)
    return _attention_fwd(q, k, v, causal, window, logit_cap)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def _rmsnorm_meta(x, w):
    """The meta route of K2: the output, and the weight's f32 copy where the
    wrapper makes one."""
    _rn.check_inputs(x, w)
    D = x.shape[-1]
    out = torch.empty_like(x)
    if out.numel() == 0:  # the wrapper launches nothing
        return out
    wf = w.float()
    _record(_rn, _rn.launch_counts(D, x.dtype, x.data_ptr() | out.data_ptr()),
            rmsnorm_work(x.numel() // D, D, x.dtype))
    del wf
    return out


def _rmsnorm_fwd(x, w, eps):
    if x.device.type == "meta":
        return _rmsnorm_meta(x, w)
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
    """Row-wise RMSNorm over the last axis; f32 moments, x's dtype out.
    DTensors take the local-shard route over the rows; the weight must be
    replicated."""
    if is_dtensor(x):
        return on_local_shards("rmsnorm", lambda x, w: rmsnorm(x, w, eps), {"x": x, "w": w},
                                {"x": tuple(range(x.ndim - 1)), "w": None}, "x")
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
    if a.device.type == "meta":
        _lru.check_inputs(a, b, h0)
        h_seq, h_out = torch.empty_like(a), torch.empty_like(h0)
        _record(_lru, ("launches",), lru_work(*a.shape, a.dtype))
        return h_seq, h_out
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
    (h_seq in a's dtype, h_final f32). Any T. DTensors take the local-shard
    route over batch and the channels (``h0`` split as a's dims 0 and 2)."""
    if is_dtensor(a):
        inputs = {"a": a, "b": b, "h0": h0}
        _check_split("lru_scan", "a", inputs, {"a": {0: 0, 1: 1, 2: 2}, "b": {0: 0, 1: 1, 2: 2}, "h0": {0: 0, 2: 1}})
        return on_local_shards("lru_scan", lru_scan, inputs, {"a": (0, 2), "b": (0, 2), "h0": (0, 1)}, "a",
                                (a.placements, split_like(a.placements, {0: 0, 2: 1})))
    if _wants_grad(a, b, h0):
        return _LRUScan.apply(a, b, h0)
    return _lru_fwd(a, b, h0)


# ---------------------------------------------------------------------------
# RWKV-6 WKV
# ---------------------------------------------------------------------------

WKV_CHUNK = 64  # the chunk of the backward's recompute, the reference's default


def _wkv6_fwd(r, k, v, w, u, s0):
    if r.device.type == "meta":
        _wkv.check_inputs(r, k, v, w, u, s0)
        y, s_out, uf = torch.empty_like(r), torch.empty_like(s0), u.float()
        _record(_wkv, ("launches",), wkv6_work(*r.shape, r.dtype))
        del uf
        return y, s_out
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
    form's rule (ROADMAP H4). DTensors take the local-shard route over batch
    and heads (``u`` split with its heads, a replicated ``u`` beside split
    rows getting a partial gradient)."""
    if is_dtensor(r):
        same = {0: 0, 1: 1, 2: 2, 3: 3}
        inputs = {"r": r, "k": k, "v": v, "w": w, "u": u, "s0": s0}
        _check_split("wkv6", "r", inputs, {"r": same, "k": same, "v": same, "w": same, "u": {1: 0},
                                           "s0": {0: 0, 1: 1}})
        return on_local_shards("wkv6", wkv6, inputs, {n: (0,) if n == "u" else (0, 1) for n in inputs}, "r")
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
    int32, gate (G, N, k) f32, pos (G, N, k) int32, -1 where dropped).
    A DTensor takes the local-shard route over the groups (a group's
    capacity slots depend on all its tokens, its softmax on all experts)."""
    if is_dtensor(logits):
        return on_local_shards(
            "moe_gating", lambda x: moe_gating(x, top_k=top_k, capacity=capacity, renormalise=renormalise),
            {"logits": logits}, {"logits": (0,)}, "logits")
    if logits.device.type == "cpu":
        return ref.moe_gating_ref(logits, top_k=top_k, capacity=capacity, renormalise=renormalise)
    if _wants_grad(logits):
        raise NotImplementedError(
            f"ops.moe_gating: the kernel has no backward; on {logits.device} it runs only where "
            "no gradient is required (route on detached logits, or under torch.no_grad)"
        )
    if logits.device.type == "meta":
        return _moe_gating_meta(logits, top_k, capacity)
    return _gating.moe_gating(logits, top_k=top_k, capacity=capacity, renormalise=renormalise)


def _moe_gating_meta(logits, top_k: int, capacity: int):
    """The meta route of K5: idx, gate and pos (G, N, k), and the slots
    kernel's histogram where a group spans more than one tile."""
    _gating.check_inputs(logits, top_k, capacity)
    G, N, E = logits.shape
    idx, gate, pos, hist = _gating.outputs(logits, top_k)
    _record(_gating, _gating.launch_counts(N), moe_gating_work(G, N, E, top_k))
    del hist
    return idx, gate, pos
