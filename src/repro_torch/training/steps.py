"""Train state and the train step (the port of ``repro.training.steps``).

``make_train_step`` assembles: loss → gradient by autograd (optionally over
microbatches, summed in f32) → the optimizer's update, which clips. On one
card there are no sharding rules; the reference's sharding builders
(``abstract_train_state``, ``train_state_logical``) come with the mesh
(ROADMAP M17/M18). Prefill and decode steps are the model's ``prefill_fn`` /
``decode_fn`` themselves (:mod:`repro_torch.models.registry`).

Gradient accumulation reshapes the global batch (B, ...) into
(MB, B/MB, ...) row-major and runs the microbatches in order: peak
activation memory drops by about MB× while the arithmetic is the same.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import map_defs, tree_leaves, tree_unflatten
from repro_torch.models.registry import Model
from repro_torch.optim import Optimizer
from repro_torch.optim.optimizers import global_norm


def init_train_state(model: Model, optimizer: Optimizer, generator: torch.Generator, device="cuda") -> dict:
    """``{"params", "opt", "step"}``: seeded weights on ``device`` (drawn by
    ``generator`` on its own device), the optimizer's fresh state, step 0
    (int32)."""
    params = model.init(generator, device)
    return {
        "params": params,
        "opt": optimizer.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=torch.device(device)),
    }


def make_train_step(model: Model, optimizer: Optimizer):
    """``train_step(state, batch) → (new_state, metrics)``; batch is a dict of
    (B, ...) tensors on the state's device. Metrics are 0-dim tensors (no
    host sync): the loss function's, ``loss`` and ``grad_norm``, the norm of
    the unclipped f32 gradients."""
    mb = max(1, model.cfg.microbatch)

    def value_and_grad(params, batch):
        leaves = map_defs(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = model.loss_fn(leaves, batch)
        flat = [p for _, p in tree_leaves(leaves)]
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_unflatten(params, grads)

    def train_step(state, batch):
        params = state["params"]
        if mb == 1:
            loss, metrics, grads = value_and_grad(params, batch)
            grads = map_defs(lambda g: g.float(), grads)
        else:
            micro = {k: x.reshape(mb, x.shape[0] // mb, *x.shape[1:]) for k, x in batch.items()}
            gsum = map_defs(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0][1].device)
            ms = []
            for i in range(mb):
                l, m, g = value_and_grad(params, {k: x[i] for k, x in micro.items()})
                gsum = map_defs(lambda a, b: a + b.float(), gsum, g)
                lsum = lsum + l
                ms.append(m)
            grads = map_defs(lambda g: g / mb, gsum)
            loss = lsum / mb
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}

        new_params, new_opt = optimizer.update(grads, state["opt"], params)
        metrics = dict(metrics)
        metrics.update({"loss": loss, "grad_norm": global_norm(grads)})
        return {"params": new_params, "opt": new_opt, "step": state["step"] + 1}, metrics

    return train_step
