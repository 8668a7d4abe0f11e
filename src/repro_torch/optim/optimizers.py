"""Functional optimizers: AdamW, 8-bit AdamW, Lion (the port of
``repro.optim.optimizers``).

Each optimizer is a pair of functions over nested dicts of tensors:

  init(params)                 → opt state
  update(grads, state, params) → (new_params, new_state)

The state has the reference's tree and dtypes (``m``, ``v``, ``count``
int32; 8-bit moments as ``{"q": int8, "scale": f32}`` per leaf), so a state
crosses between the packages leaf by leaf. The numerics follow the reference
(H3 in ROADMAP.md): grads go to f32 and are clipped to a global norm inside
``update``; b2 is 0.95; weight decay 0.1 applies to every leaf, norms
included; the schedule is read at the 1-based ``count``; 8-bit moments round
half to even, as ``jnp.round``. ``update`` returns new tensors and leaves its
arguments untouched.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models.common import map_defs, tree_leaves

from .schedules import constant


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable  # (grads, state, params) -> (new_params, new_state)


def _schedule(lr) -> Callable:
    return lr if callable(lr) else constant(lr)


def _prepare(grads, state, clip_norm, sched):
    """f32 clipped grads, the new count, the learning rate at it."""
    grads = _clip_by_global_norm(map_defs(lambda g: g.float(), grads), clip_norm)
    count = state["count"] + 1
    return grads, count, sched(count)


def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


# ---------------------------------------------------------------------------
# AdamW (fp32 moments)
# ---------------------------------------------------------------------------


def adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0):
    sched = _schedule(lr)

    def init(params):
        device = tree_leaves(params)[0][1].device
        return {"m": map_defs(_zeros_f32, params), "v": map_defs(_zeros_f32, params),
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads, state, params):
        grads, count, lr_t = _prepare(grads, state, clip_norm, sched)
        c1 = 1 - b1 ** count.float()
        c2 = 1 - b2 ** count.float()
        m = map_defs(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
        v = map_defs(lambda v, g: b2 * v + (1 - b2) * g * g, state["v"], grads)

        def step(p, m_, v_):
            upd = (m_ / c1) / (torch.sqrt(v_ / c2) + eps) + weight_decay * p.float()
            return (p.float() - lr_t * upd).to(p.dtype)

        return map_defs(step, params, m, v), {"m": m, "v": v, "count": count}

    return Optimizer("adamw", init, update)


# ---------------------------------------------------------------------------
# 8-bit AdamW (block-quantized moments)
# ---------------------------------------------------------------------------


def _quant(x):
    """Per-row int8 absmax quantisation. x: f32 (..., N) → (int8, f32 scales)."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def _dequant(q, scale):
    return q.float() * scale[..., None]


def adamw8bit(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0):
    sched = _schedule(lr)

    def init(params):
        def zq(p):
            return {"q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                    "scale": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)}

        device = tree_leaves(params)[0][1].device
        return {"m": map_defs(zq, params), "v": map_defs(zq, params),
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads, state, params):
        grads, count, lr_t = _prepare(grads, state, clip_norm, sched)
        c1 = 1 - b1 ** count.float()
        c2 = 1 - b2 ** count.float()

        def leaf(p, g, mq, vq):
            m = b1 * _dequant(mq["q"], mq["scale"]) + (1 - b1) * g
            v = b2 * _dequant(vq["q"], vq["scale"]) + (1 - b2) * g * g
            upd = (m / c1) / (torch.sqrt(v.clamp_min(0.0) / c2) + eps)
            upd = upd + weight_decay * p.float()
            qm, sm = _quant(m)
            qv, sv = _quant(v)
            return (p.float() - lr_t * upd).to(p.dtype), {"q": qm, "scale": sm}, {"q": qv, "scale": sv}

        # params lead: each leaf's 8-bit moment, a {"q", "scale"} dict, comes whole
        out = map_defs(leaf, params, grads, state["m"], state["v"])
        part = lambda i: map_defs(lambda o: o[i], out)  # noqa: E731
        return part(0), {"m": part(1), "v": part(2), "count": count}

    return Optimizer("adamw8bit", init, update)


# ---------------------------------------------------------------------------
# Lion (single moment)
# ---------------------------------------------------------------------------


def lion(lr=1e-4, b1=0.9, b2=0.99, weight_decay=0.1, clip_norm=1.0):
    sched = _schedule(lr)

    def init(params):
        device = tree_leaves(params)[0][1].device
        return {"m": map_defs(_zeros_f32, params), "count": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads, state, params):
        grads, count, lr_t = _prepare(grads, state, clip_norm, sched)

        def step(p, m, g):
            upd = torch.sign(b1 * m + (1 - b1) * g) + weight_decay * p.float()
            return (p.float() - lr_t * upd).to(p.dtype)

        new_params = map_defs(step, params, state["m"], grads)
        m = map_defs(lambda m, g: b2 * m + (1 - b2) * g, state["m"], grads)
        return new_params, {"m": m, "count": count}

    return Optimizer("lion", init, update)


def make_optimizer(name: str, **kw) -> Optimizer:
    return {"adamw": adamw, "adamw8bit": adamw8bit, "lion": lion}[name](**kw)


# ---------------------------------------------------------------------------


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, summed leaf by leaf in
    flattening order as the reference does."""
    return torch.sqrt(sum(g.square().sum() for _, g in tree_leaves(grads)))


def _clip_by_global_norm(grads, max_norm: float):
    if not max_norm or max_norm <= 0:
        return grads
    norm = global_norm(grads).clamp_min(1e-12)
    # a true division, as the reference's (``max_norm / t`` is a reciprocal and a product in torch)
    scale = torch.clamp(torch.full_like(norm, max_norm) / norm, max=1.0)
    return map_defs(lambda g: g * scale, grads)
