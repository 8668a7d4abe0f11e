"""Train state and the train step (the port of ``repro.training.steps``).

``make_train_step`` assembles: loss → gradient by autograd (optionally over
microbatches, summed in f32) → the optimizer's update, which clips. The
prefill and decode steps (``make_prefill_step``, ``make_serve_step``) are the
model's ``prefill_fn`` / ``decode_fn`` (:mod:`repro_torch.models.registry`),
run under the rules on a mesh, as the reference's.

Gradient accumulation reshapes the global batch (B, ...) into
(MB, B/MB, ...) row-major and runs the microbatches in order: peak
activation memory drops by about MB× while the arithmetic is the same.

On a device mesh (``make_train_step(model, optimizer, rules, mesh)``, every
family) the state is a tree of DTensors laid out by
``resolve_tree(mesh, train_state_logical(...), rules)``: data parallelism
over the batch's axes, tensor and expert parallelism over ``model``, ZeRO-3
over the data axes with ``cfg.fsdp``. The step runs under ``use_rules``: the
model's ``shard()`` sites pin its activations, each gradient is reduced to
its parameter's placements (an all-reduce, or ZeRO-3's reduce-scatter), and
the update runs shard by shard. On a mesh the microbatches are the local
rows' (rank r's microbatch i is its own rows' i-th slice).
"""

from __future__ import annotations

import math
import zlib

import torch

from repro_torch.kernels.ops import is_dtensor
from repro_torch.models.common import _fan_in, map_defs, tree_leaves, tree_unflatten
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


def train_state_logical(model: Model, optimizer: Optimizer) -> dict:
    """The train state's logical axes (tuples as leaves)."""
    plog = model.param_logical()
    return {"params": plog, "opt": optimizer.state_logical(plog), "step": ()}


def abstract_train_state(model: Model, optimizer: Optimizer) -> dict:
    """The train state as tensors on the ``meta`` device (shapes and dtypes,
    no storage): the counterpart of the reference's ShapeDtypeStruct state."""
    params = model.abstract_params()
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def init_sharded_params(model: Model, seed: int, mesh, placements, device="cuda") -> dict:
    """Seeded weights laid out by ``placements`` (a tree from
    ``resolve_tree`` of ``model.param_logical()``) without any rank holding a
    whole model.

    A normal-init weight is drawn on ``device`` one layer at a time where it
    is stacked over ``layers``, else whole, from a generator seeded by
    (seed, leaf, layer), with the reference's std, and each rank keeps its
    own part. So the weights are the same on every mesh, the peak is one
    layer of a leaf (or the largest unstacked leaf, the embedding) in f32
    beside the shards, and they differ from ``model.init``'s for one seed
    (which draws each leaf in one call)."""
    from repro_torch.parallel.sharding import from_local, local_shape, local_slices

    device = torch.device(device)
    defs = [d for _, d in tree_leaves(model.param_defs)]
    leaves = []
    for li, (d, pl) in enumerate(zip(defs, [p for _, p in tree_leaves(placements)])):
        if d.init != "normal":
            fill = {"zeros": 0.0, "ones": 1.0, "constant": d.scale}[d.init]
            local = torch.full(local_shape(d.shape, pl, mesh), fill, dtype=d.dtype, device=device)
        else:
            std = d.scale / math.sqrt(max(1, _fan_in(d)))
            index = local_slices(d.shape, pl, mesh)
            sliced = d.logical[:1] == ("layers",)  # a stacked leaf; never sharded on that dim

            def draw(shape, *key):
                gen = torch.Generator(device=device).manual_seed(zlib.crc32(repr((seed, li, *key)).encode()))
                return torch.randn(shape, generator=gen, device=device).mul_(std)

            if sliced:
                local = torch.stack([draw(d.shape[1:], i)[index[1:]].to(d.dtype)
                                     for i in range(d.shape[0])[index[0]]])
            else:
                local = draw(d.shape)[index].to(d.dtype)
        leaves.append(from_local(local.contiguous(), mesh, pl, d.shape))
    return tree_unflatten(model.param_defs, leaves)


def init_sharded_train_state(model: Model, optimizer: Optimizer, seed: int, mesh, placements: dict,
                             device="cuda") -> dict:
    """A fresh train state laid out by ``placements`` (a tree from
    ``resolve_tree``) without any rank holding a whole model: the weights of
    :func:`init_sharded_params`; every optimizer's fresh state is zeros, made
    in local shapes; step is 0."""
    from repro_torch.parallel.sharding import from_local, local_shape

    device = torch.device(device)
    abstract = abstract_train_state(model, optimizer)

    def zeros(t, pl):
        return from_local(torch.zeros(local_shape(t.shape, pl, mesh), dtype=t.dtype, device=device), mesh, pl,
                          t.shape)

    return {"params": init_sharded_params(model, seed, mesh, placements["params"], device),
            "opt": map_defs(zeros, abstract["opt"], placements["opt"]),
            "step": zeros(abstract["step"], placements["step"])}


def _microbatches(batch: dict, mb: int) -> list:
    """The batch's ``mb`` microbatches: row-major slices of the rows, of each
    rank's local rows for DTensors."""
    def part(x, i):
        if is_dtensor(x):
            from repro_torch.parallel.sharding import from_local

            local = x.to_local()
            n = local.shape[0] // mb
            return from_local(local[i * n:(i + 1) * n], x.device_mesh, x.placements, (x.shape[0] // mb, *x.shape[1:]))
        n = x.shape[0] // mb
        return x[i * n:(i + 1) * n]

    return [{k: part(x, i) for k, x in batch.items()} for i in range(mb)]


def make_grad_fn(model: Model, param_placements=None, mesh=None):
    """``grads(params, batch) → (loss, metrics, f32 grads)``: the loss and its
    gradient by autograd, over ``cfg.microbatch`` microbatches (summed in
    f32, then divided) when it is above 1. Shared by :func:`make_train_step`
    and the data-parallel step. With ``param_placements`` (DTensor params on
    ``mesh``) each gradient is reduced to its parameter's placements."""
    mb = max(1, model.cfg.microbatch)

    def value_and_grad(params, batch):
        leaves = map_defs(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = model.loss_fn(leaves, batch)
        flat = [p for _, p in tree_leaves(leaves)]
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        grads = tree_unflatten(params, grads)
        if param_placements is not None:
            from repro_torch.parallel.sharding import redistribute_tree

            grads = redistribute_tree(grads, mesh, param_placements)
        return loss.detach(), metrics, grads

    def grads_fn(params, batch):
        if mb == 1:
            loss, metrics, grads = value_and_grad(params, batch)
            return loss, metrics, map_defs(lambda g: g.float(), grads)
        gsum = map_defs(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        lsum = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0][1].device)
        ms = []
        for micro in _microbatches(batch, mb):
            l, m, g = value_and_grad(params, micro)
            gsum = map_defs(lambda a, b: a + b.float(), gsum, g)
            lsum = lsum + l
            ms.append(m)
        metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        return lsum / mb, metrics, map_defs(lambda g: g / mb, gsum)

    return grads_fn


def make_train_step(model: Model, optimizer: Optimizer, rules: "dict | None" = None, mesh=None):
    """``train_step(state, batch) → (new_state, metrics)``; batch is a dict of
    (B, ...) tensors on the state's device. Metrics are 0-dim tensors (no
    host sync): the loss function's, ``loss`` and ``grad_norm``, the norm of
    the unclipped f32 gradients.

    With ``rules`` and ``mesh`` the state and batch are DTensors laid out by
    the rules (:func:`train_state_logical`, ``model.train_input_logical()``)
    and the step runs under them (module docstring); its metrics are the
    local values of replicated scalars. Without them it is the one-device
    step."""
    if rules is None:
        return _make_plain_step(model, optimizer)
    from repro_torch.parallel.sharding import redistribute_tree, resolve_tree, with_rules

    placements = resolve_tree(mesh, train_state_logical(model, optimizer), rules)
    grads_fn = make_grad_fn(model, placements["params"], mesh)

    def train_step(state, batch):
        params = state["params"]
        loss, metrics, grads = grads_fn(params, batch)
        new_params, new_opt = optimizer.update(grads, state["opt"], params)
        metrics = dict(metrics)
        metrics.update({"loss": loss, "grad_norm": global_norm(grads)})
        metrics = {k: v.full_tensor() for k, v in metrics.items()}
        return {"params": redistribute_tree(new_params, mesh, placements["params"]),
                "opt": redistribute_tree(new_opt, mesh, placements["opt"]),
                "step": state["step"] + 1}, metrics

    return with_rules(train_step, rules, mesh)


def make_prefill_step(model: Model, rules: "dict | None" = None, mesh=None):
    """``prefill(params, batch) → (last logits, cache)``: ``model.prefill_fn``,
    under ``rules`` on ``mesh`` when given (DTensor params and batch; the
    cache comes back as DTensors of the forward's placements)."""
    if rules is None:
        return model.prefill_fn
    from repro_torch.parallel.sharding import with_rules

    return with_rules(model.prefill_fn, rules, mesh)


def make_serve_step(model: Model, rules: "dict | None" = None, mesh=None):
    """One decode step, ``(params, cache, tokens, pos) → (logits, cache)``:
    ``model.decode_fn``, under ``rules`` on ``mesh`` when given (the cache
    laid out by ``model.cache_logical_fn()``, its ``kv_seq`` dim split over
    ``model``: split-KV decode)."""
    if rules is None:
        return model.decode_fn
    from repro_torch.parallel.sharding import with_rules

    return with_rules(model.decode_fn, rules, mesh)


def _make_plain_step(model: Model, optimizer: Optimizer):
    grads_fn = make_grad_fn(model)

    def train_step(state, batch):
        params = state["params"]
        loss, metrics, grads = grads_fn(params, batch)
        new_params, new_opt = optimizer.update(grads, state["opt"], params)
        metrics = dict(metrics)
        metrics.update({"loss": loss, "grad_norm": global_norm(grads)})
        return {"params": new_params, "opt": new_opt, "step": state["step"] + 1}, metrics

    return train_step
