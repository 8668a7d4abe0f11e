"""Data-parallel train step with explicit collectives and optional
error-feedback int8 compression on the inter-node gradient leg (the port of
``repro.training.dp_step``).

Every rank holds the whole model and steps on its own shard of the global
batch; the step averages the gradients over the ranks and makes the same
update on every rank:

    per-rank f32 gradients                    (this rank's rows)
    → exact mean over "data"                  (the GPUs of a node)
    → ef_compressed_psum or exact mean, "pod" (across nodes)
    → the optimizer's update, identical on every rank

The groups come from :func:`repro_torch.launch.distributed.dp_groups`. The
error-feedback carry ``ef`` rides in the train state and is checkpointed like
the optimizer's moments. With ``compress=False`` the pod leg is an exact f32
mean, the average the reference's GSPMD step computes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.common import map_defs
from repro_torch.models.registry import Model
from repro_torch.optim import Optimizer
from repro_torch.optim.optimizers import global_norm
from repro_torch.parallel.compression import ef_compressed_psum, init_ef_state, true_div

from .steps import init_train_state, make_grad_fn


def init_dp_state(model: Model, optimizer: Optimizer, generator: torch.Generator, device="cuda", *,
                  compress: bool) -> dict:
    """:func:`~repro_torch.training.init_train_state`'s state, plus the zero
    error-feedback carry ``ef`` when ``compress``."""
    state = init_train_state(model, optimizer, generator, device)
    if compress:
        state["ef"] = init_ef_state(state["params"])
    return state


def _mean(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """Mean of ``t`` over ``group``, in ``t``'s layout: a gradient that
    autograd left transposed stays so, and the global norm then sums it in
    the plain step's order (a collective needs a contiguous buffer)."""
    buf = t if t.is_contiguous() else t.contiguous()
    dist.all_reduce(buf, group=group)
    if buf is not t:
        t.copy_(buf)
    return true_div(t, n)


def make_dp_train_step(model: Model, optimizer: Optimizer, groups: dict, *, compress: bool = True):
    """``train_step(state, batch) → (new_state, metrics)`` on this rank's
    shard of the batch. ``groups`` maps "data" (and optionally "pod") to a
    process group; without "pod" there is no compressed leg. Every rank of
    the groups calls the step together. ``loss`` and the loss function's
    metrics are averaged over the ranks; ``grad_norm`` is that of the synced
    gradients."""
    grads_fn = make_grad_fn(model)
    data, pod = groups["data"], groups.get("pod")
    n_data = dist.get_world_size(data)
    n_pod = dist.get_world_size(pod) if pod is not None else 1

    def train_step(state, batch):
        loss, metrics, grads = grads_fn(state["params"], batch)
        keys = sorted(metrics)
        scalars = torch.stack([loss.float(), *(metrics[k].float() for k in keys)])
        # fast leg: exact mean within the node
        grads = map_defs(lambda g: _mean(g, data, n_data), grads)
        scalars = _mean(scalars, data, n_data)
        new_state = dict(state)
        if pod is not None:
            scalars = _mean(scalars, pod, n_pod)
            if compress:
                grads, new_state["ef"] = ef_compressed_psum(grads, state["ef"], pod, n_pod)
            else:
                grads = map_defs(lambda g: _mean(g, pod, n_pod), grads)
        new_params, new_opt = optimizer.update(grads, state["opt"], state["params"])
        metrics = dict(zip(keys, scalars[1:]))
        metrics.update({"loss": scalars[0], "grad_norm": global_norm(grads)})
        new_state.update(params=new_params, opt=new_opt, step=state["step"] + 1)
        return new_state, metrics

    return train_step
