"""Plain PyTorch versions of the port's kernels.

Each function is the semantic definition its kernel must match: the CPU path
of :mod:`repro_torch.kernels.ops` runs it, the CPU tests hold it against the
JAX package, and ``chip_smoke.py`` holds each kernel against it on the card.
They are deliberately naive (attention materialises the full score matrix,
the recurrences step token by token in f32) and take any sequence length.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def lru_ref(a, b, h0):
    """Linear recurrence h_t = a_t ⊙ h_{t-1} + b_t, token by token in f32.

    a, b: (B, T, W); h0: (B, W). Returns (h_seq (B, T, W) in a's dtype,
    h_final (B, W) f32).
    """
    af, bf = a.float(), b.float()
    h = h0.float()
    hs = torch.empty_like(af)
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs[:, t] = h
    return hs.to(a.dtype), h


def wkv6_ref(r, k, v, w, u, s0):
    """The RWKV-6 WKV recurrence, token by token in f32.

    r, k, w: (B, H, T, dk); v: (B, H, T, dv); u: (H, dk); s0: (B, H, dk, dv).
        y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
        S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
    Returns (y (B, H, T, dv) in r's dtype, S_final (B, H, dk, dv) f32).
    """
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    s = s0.float()
    ys = torch.empty_like(vf)
    for t in range(r.shape[2]):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        ys[:, :, t] = torch.einsum("bhi,bhiv->bhv", rf[:, :, t], s + uf * kv)
        s = wf[:, :, t, :, None] * s + kv
    return ys.to(r.dtype), s


def lane_sum(x):
    """Sum over the last axis in the order of the gating kernel's warp, so
    that the two agree to the bit: entry i belongs to lane i % 32, each lane
    adds its entries in index order, then the 32 lane sums combine by halves
    (16, 8, 4, 2, 1). Returns the sums with the last axis kept as 1."""
    E = x.shape[-1]
    chunks = -(-E // 32)
    lanes = F.pad(x, (0, 32 * chunks - E)).unflatten(-1, (chunks, 32))
    s = lanes[..., 0, :]
    for c in range(1, chunks):
        s = s + lanes[..., c, :]
    width = 16
    while width:
        s = s[..., :width] + s[..., width : 2 * width]
        width //= 2
    return s


def moe_gating_ref(logits, *, top_k: int, capacity: int, renormalise: bool = True):
    """MoE routing decision per dispatch group: softmax, top-k, capacity slots.

    logits: (G, N, E) → (idx (G, N, k) int32, gate (G, N, k) f32, pos (G, N, k)
    int32).
      * softmax in f32 as exp(x - max) / sum, the sum in :func:`lane_sum`'s
        order;
      * k rounds of argmax over the remaining probabilities (the first
        maximum wins, so ties go to the lower expert), each pick's
        probability is its gate;
      * gates renormalised by max(sum of the k gates, 1e-9), summed in pick
        order;
      * capacity slots j-major: every rank-0 pick of the group claims a slot
        before any rank-1 pick, tokens in group order within a rank; a pick
        past ``capacity`` gets -1 (dropped) and still counts against its
        expert.
    Vectorised over tokens with one-hot cumulative sums.
    """
    x = logits.float()
    G, N, E = x.shape
    p = torch.exp(x - x.amax(dim=-1, keepdim=True))
    remaining = p / lane_sum(p)
    idx = torch.empty((G, N, top_k), dtype=torch.long, device=x.device)
    gate = torch.empty((G, N, top_k), dtype=torch.float32, device=x.device)
    for j in range(top_k):
        e = remaining.argmax(dim=-1, keepdim=True)
        idx[..., j : j + 1] = e
        gate[..., j : j + 1] = remaining.gather(-1, e)
        remaining = remaining.scatter(-1, e, float("-inf"))
    if renormalise:
        total = gate[..., 0]
        for j in range(1, top_k):
            total = total + gate[..., j]
        gate = gate / total.clamp_min(1e-9)[..., None]
    counts = torch.zeros((G, 1, E), dtype=torch.long, device=x.device)
    pos = torch.empty_like(idx)
    for j in range(top_k):
        onehot = F.one_hot(idx[..., j], E)  # (G, N, E)
        slot = (counts + onehot.cumsum(dim=1) - onehot).gather(-1, idx[..., j : j + 1])[..., 0]
        pos[..., j] = torch.where(slot < capacity, slot, -1)
        counts = counts + onehot.sum(dim=1, keepdim=True)
    return idx.int(), gate, pos.int()
