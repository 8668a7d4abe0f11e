"""Logical-axis sharding rules (the port of ``repro.parallel.sharding``).

One model definition carries *logical* axis names on every parameter,
activation constraint and optimizer leaf; this module resolves them to mesh
axes for a concrete (arch, mesh, batch) combination, exactly as the
reference does:

  batch    → ("pod", "data")   data parallelism (both axes)
  heads    → "model"           tensor parallelism over attention heads
  kv_heads → "model"
  ff       → "model"           tensor parallelism over the MLP hidden
  vocab    → "model"           embedding / unembedding sharding
  experts  → "model"           expert parallelism
  lru      → "model"           RG-LRU width sharding
  kv_seq   → "model"           decode-time KV sequence sharding
  embed    → the data axes     with ``cfg.fsdp`` (ZeRO-3), else replicated
  layers   → replicated

Every rule self-disables when a dimension it names is not divisible by its
mesh axis: the table is derived per (cfg, mesh, shapes).

Where the reference hands a ``PartitionSpec`` to GSPMD, the port hands
DTensor placements to ``torch.distributed.tensor``: :func:`spec_for` gives
the mesh axis (or axes) of each tensor dim, :func:`placements_for` turns that
into one ``Shard(dim)`` or ``Replicate()`` per mesh dim, and
:func:`resolve_tree` does so for a whole logical tree. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` or anything with its
``mesh_dim_names`` and ``shape`` (:class:`repro_torch.launch.mesh.MeshShape`
sizes a job without a process group), or a duck-typed mesh with the
reference's ``axis_names`` and ``devices.shape``.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.common import ParamDef, map_defs, set_logical_rules, tree_leaves, tree_unflatten

_MODEL_RULES = ("vocab", "heads", "kv_heads", "ff", "experts", "lru", "kv_seq", "seq")


def _names_and_shape(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return tuple(names), tuple(mesh.shape)
    return tuple(mesh.axis_names), tuple(mesh.devices.shape)


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(*_names_and_shape(mesh)))


def dp_axes(mesh) -> tuple:
    names = _names_and_shape(mesh)[0]
    return tuple(a for a in ("pod", "data") if a in names)


def rules_for(cfg, mesh, *, param_defs=None, batch_size: int | None = None, extra_dims: dict | None = None,
              fsdp: "bool | None" = None) -> dict:
    """Derive the logical→mesh table, disabling non-divisible rules.

    ``param_defs``: the model's ParamDef tree — every (dim, logical) pair is
    checked. ``extra_dims``: activation/cache dims not visible in params,
    e.g. {"kv_seq": 32768, "batch": 256, "heads": n_heads}.
    """
    sizes = mesh_axis_sizes(mesh)
    model = sizes.get("model", 1)
    dp = dp_axes(mesh)
    dp_total = 1
    for a in dp:
        dp_total *= sizes[a]

    dims: dict[str, set] = {}

    def note(name, size):
        if name is not None:
            dims.setdefault(name, set()).add(int(size))

    if param_defs is not None:
        for _, d in tree_leaves(param_defs):
            if isinstance(d, ParamDef):
                for size, name in zip(d.shape, d.logical):
                    note(name, size)
    note("heads", cfg.n_heads)
    note("kv_heads", cfg.n_kv_heads)
    for name, size in (extra_dims or {}).items():
        note(name, size)

    rules: dict[str, object] = {"layers": None, "embed": None}
    for name in _MODEL_RULES:
        seen = dims.get(name, set())
        ok = model > 1 and seen and all(s % model == 0 for s in seen)
        if name == "seq" and not getattr(cfg, "seq_shard", False):
            ok = False  # sequence parallelism is an explicit perf lever
        rules[name] = "model" if ok else None
    if batch_size is not None and dp and batch_size % dp_total == 0:
        rules["batch"] = dp if len(dp) > 1 else dp[0]
    else:
        rules["batch"] = None

    # FSDP / ZeRO-3: the weights' (and optimizer moments') "embed" dim
    # sharded over the data axes on top of the model axis. Each layer's
    # shards are all-gathered at use (common.gather_fsdp) and its gradient
    # reduce-scattered back. Training only.
    use_fsdp = getattr(cfg, "fsdp", False) if fsdp is None else fsdp
    if use_fsdp and dp:
        emb = dims.get("embed", set())
        if emb and all(s % dp_total == 0 for s in emb):
            rules["embed"] = dp if len(dp) > 1 else dp[0]
    return rules


def serve_rules(model, mesh, batch: int, max_seq: int) -> dict:
    """The rules of serving ``batch`` requests of up to ``max_seq`` tokens on
    ``mesh``: the reference's engines' (``batch_size=batch``,
    ``extra_dims={"kv_seq": max_seq, "heads": n_heads}``), with the cache's
    own dims checked too, so that a rule also self-disables where a cache
    leaf does not split (Griffin's ring of ``window`` slots over ``kv_seq``).
    A batch of one is never split, also where the data axes are of size 1
    (DTensor cannot view a dim of size 1 split over a mesh dim of size 1)."""
    cache = map_defs(lambda t, lg: ParamDef(tuple(t.shape), lg), model.cache_defs_fn(batch, max_seq),
                     model.cache_logical_fn())
    rules = rules_for(model.cfg, mesh, param_defs={"params": model.param_defs, "cache": cache}, batch_size=batch,
                      extra_dims={"kv_seq": max_seq, "heads": model.cfg.n_heads})
    return {**rules, "batch": None} if batch == 1 else rules


def spec_for(logical: tuple, rules: dict) -> tuple:
    """The mesh axis (a name, a tuple of names, or None) of each dim: the
    reference's ``PartitionSpec`` as a tuple."""
    return tuple(rules.get(name) if name is not None else None for name in logical)


def placements_for(logical: tuple, rules: dict, mesh) -> tuple:
    """DTensor placements of a tensor with logical axes ``logical``: for each
    mesh dim, ``Shard(d)`` when the rules map tensor dim d to it, else
    ``Replicate()``. A dim mapped to several axes (batch over ("pod",
    "data")) is sharded over each in mesh order, the outer axis first, as a
    PartitionSpec's tuple entry is."""
    names = _names_and_shape(mesh)[0]
    out: list = [Replicate()] * len(names)
    for dim, axes in enumerate(spec_for(tuple(logical), rules)):
        for axis in (axes if isinstance(axes, tuple) else (axes,)) if axes is not None else ():
            if axis not in names:
                raise ValueError(f"rule maps {logical[dim]!r} to {axis!r}, which mesh {names} lacks")
            i = names.index(axis)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{logical}: two dims map to mesh axis {axis!r}")
            out[i] = Shard(dim)
    return tuple(out)


def resolve_tree(mesh, logical_tree, rules: dict):
    """Logical tree (tuples as leaves) → a tree of placements."""
    return map_defs(lambda lg: placements_for(lg, rules, mesh), logical_tree)


def local_shape(shape, placements, mesh) -> tuple:
    """The shape of one rank's shard of a tensor of ``shape`` under
    ``placements`` (each sharded dim divides evenly, as the rules ensure)."""
    shape = list(shape)
    for size, p in zip(_names_and_shape(mesh)[1], placements):
        if isinstance(p, Shard):
            if shape[p.dim] % size:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not split over {size}")
            shape[p.dim] //= size
    return tuple(shape)


def local_slices(shape, placements, mesh) -> tuple:
    """This rank's index (a slice per dim) into a tensor of ``shape``: each
    Shard narrows its dim in mesh order, the outer mesh dim first."""
    bounds = [[0, n] for n in shape]
    for size, coord, p in zip(_names_and_shape(mesh)[1], mesh.get_coordinate(), placements):
        if isinstance(p, Shard):
            lo, hi = bounds[p.dim]
            if (hi - lo) % size:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not split over {size}")
            step = (hi - lo) // size
            bounds[p.dim] = [lo + coord * step, lo + (coord + 1) * step]
    return tuple(slice(lo, hi) for lo, hi in bounds)


def from_local(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    """The DTensor of global ``shape`` (contiguous) whose shard on this rank
    is ``local`` (no communication)."""
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, tuple(placements), run_check=False, shape=torch.Size(shape),
                              stride=stride)


def distribute(t: torch.Tensor, mesh, placements) -> DTensor:
    """A DTensor from a whole tensor that every rank holds alike: each rank
    keeps its own slice (no communication)."""
    return from_local(t[local_slices(t.shape, placements, mesh)].contiguous(), mesh, placements, t.shape)


def distribute_tree(tree, mesh, placements_tree):
    return map_defs(lambda t, p: distribute(t, mesh, p), tree, placements_tree)


def redistribute(t: DTensor, mesh, placements) -> DTensor:
    """``t`` moved to ``placements`` (itself where they agree); partial sums
    over several mesh dims are reduced one mesh dim at a time, in mesh
    order, as DTensor would, without its warning."""
    placements = tuple(placements)
    current = list(t.placements)
    while tuple(current) != placements:
        partial = [i for i, p in enumerate(current) if p.is_partial() and not placements[i].is_partial()]
        if len(partial) > 1:
            current[partial[0]] = placements[partial[0]]
        else:
            current = list(placements)
        t = t.redistribute(mesh, current)
    return t


def redistribute_tree(tree, mesh, placements_tree):
    """Each DTensor leaf moved to its placements (a no-op where they agree)."""
    return map_defs(lambda t, p: redistribute(t, mesh, p), tree, placements_tree)


def full_tree(tree):
    """Whole tensors on every rank (an all-gather a sharded leaf)."""
    return tree_unflatten(tree, [t.full_tensor() if isinstance(t, DTensor) else t for _, t in tree_leaves(tree)])


@contextlib.contextmanager
def use_rules(rules: dict, mesh):
    set_logical_rules(rules, mesh)
    try:
        yield
    finally:
        set_logical_rules(None, None)


def with_rules(fn, rules: dict, mesh):
    """Wrap a step function so that logical ``shard()`` constraints and the
    kernels' local-shard routes resolve against ``rules`` while it runs."""

    def wrapped(*args, **kwargs):
        with use_rules(rules, mesh):
            return fn(*args, **kwargs)

    return wrapped
