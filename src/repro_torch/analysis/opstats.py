"""Per-device count of one step (the port of ``repro.analysis.hlo``).

The reference parses the optimized, partitioned HLO of a compiled step and
multiplies each ``while`` body by its trip count, because XLA's own cost
analysis visits a scanned layer stack once. Eager PyTorch has no HLO and no
loop to recover: every op of every layer is dispatched, so :func:`count`
runs the step (on ``meta`` tensors, which hold no storage) under a
``TorchDispatchMode`` and counts each op as it runs. ``while_trip_counts``
has no counterpart.

What it counts, per device:

* FLOPs: ``torch.utils.flop_counter``'s formulas (the matrix products) at
  the shapes each op runs at, by the unit of its operands' dtype (bf16 on
  the tensor cores, f32 outside them); elementwise FLOPs are not counted,
  as the reference's. On a device mesh DTensor's op is not counted: the
  local op it runs on this rank's shards is (DTensor's own metadata pass at
  global shapes runs with the count switched off).
* HBM bytes: operand plus result bytes of each op. A view (a result sharing
  an operand's storage) and an allocation are free, as ``_FREE_OPS`` are in
  the reference. A gather (embedding, ``index_select``, indexing) reads the
  rows it returns, an indexed write writes the rows it is given, and other
  in-place ops read their operands and write what they change.
* Collectives: the ``_c10d_functional`` ops (those DTensor issues while it
  redistributes inside an op too), wire bytes a participant by the
  reference's ring formulas over the group's size, all-reduce 2·s·(N−1)/N,
  all-gather r·(N−1)/N, reduce-scatter r·(N−1), all-to-all s·(N−1)/N,
  broadcast s; each on the link its group spans (``link``: NVLink, its
  ranks in one node of ``hw.node_gpus``; ``net`` otherwise).
* Memory: the bytes of the arguments' and the outputs' storages, and the
  peak of the arguments plus every storage the step makes while it lives
  (no allocator rounding and no library workspace).
* The port's kernels: :mod:`repro_torch.kernels.ops`' meta route reports
  each call to the count's ``record_kernel`` by the launch counts the
  card's wrapper adds one to (those ``chip_smoke.py`` reads), with the
  kernel's work from :mod:`repro_torch.analysis.roofline`, and allocates the
  outputs and scratch the wrapper allocates.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

from .roofline import H100, HW, unit_of

_RING = {  # wire bytes a participant of a group of n, from the result's bytes
    "all_reduce": lambda size, n: 2.0 * size * (n - 1) / n,
    "all_gather_into_tensor": lambda size, n: size * (n - 1) / n,
    "reduce_scatter_tensor": lambda size, n: size * (n - 1),
    "all_to_all_single": lambda size, n: size * (n - 1) / n,
    "broadcast": lambda size, n: size,
}
_TYPE = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all", "broadcast": "broadcast"}
# ops that move no data: allocations and the collectives' bookkeeping
_ALLOCATIONS = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided", "wait_tensor",
                "_wrap_tensor_autograd"}
# reads of the rows they return (and their indices), not of the whole source
_GATHERS = {"embedding", "index_select", "index", "gather"}
# writes of the rows they are given into the first operand, in place
_INDEXED_WRITES = {"index_put_", "_index_put_impl_", "index_copy_", "index_add_", "scatter_", "scatter_add_",
                   "scatter_reduce_", "index_fill_", "masked_fill_"}
_OVERWRITES = {"copy_", "fill_", "zero_"}  # write the first operand without reading it


@dataclasses.dataclass
class OpStats:
    """The count of one step on one device (bytes, FLOPs and wire bytes as
    floats, as the reference's ``HloStats``)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_wire_bytes: float = 0.0
    collective_by_type: dict = dataclasses.field(default_factory=dict)
    collective_count: float = 0.0
    notes: list = dataclasses.field(default_factory=list)
    bytes_by_op: dict = dataclasses.field(default_factory=dict)
    flops_by_op: dict = dataclasses.field(default_factory=dict)
    flops_by_unit: dict = dataclasses.field(default_factory=dict)
    wire_bytes_by_link: dict = dataclasses.field(default_factory=dict)
    kernel_calls: dict = dataclasses.field(default_factory=dict)
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_bytes: int = 0

    def add_flops(self, what: str, unit: str, flops: float) -> None:
        self.flops += flops
        self.flops_by_op[what] = self.flops_by_op.get(what, 0.0) + flops
        self.flops_by_unit[unit] = self.flops_by_unit.get(unit, 0.0) + flops

    def add_bytes(self, what: str, nbytes: float) -> None:
        self.hbm_bytes += nbytes
        self.bytes_by_op[what] = self.bytes_by_op.get(what, 0.0) + nbytes


def _tensors(tree, out=None) -> list:
    """The plain tensors of a tree of tuples, lists and dicts: a DTensor's
    local shard in its place. (A plain recursion: a nested function calling
    itself would be a reference cycle holding the tensors until a garbage
    collection, and the count of live bytes would see them live.)"""
    dtensor = sys.modules.get("torch.distributed.tensor")
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree.to_local() if dtensor is not None and isinstance(tree, dtensor.DTensor) else tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages behind a tree's tensors (a DTensor's
    local shard): what they hold on the device, views counted once."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _group(group, hw: HW) -> tuple:
    """(size, link) of the process group a collective names: a
    functional collective's group name, or a c10d op's boxed group."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    pg = _resolve_process_group(group) if isinstance(group, str) else dist.ProcessGroup.unbox(group)
    ranks = dist.get_process_group_ranks(pg)
    return pg.size(), "link" if len({r // hw.node_gpus for r in ranks}) == 1 else "net"


class _Counter(TorchDispatchMode):
    """Counts every op dispatched while it is active into ``stats``."""

    def __init__(self, stats: OpStats, hw: HW, arguments: set):
        super().__init__()
        self.stats, self.hw = stats, hw
        self.live = {}  # id(storage) → (weakref, bytes) of the storages the step made
        self.live_bytes = 0
        self.base = sum(arguments.values())
        self.arguments = arguments
        self.peak = self.base

    # -- memory --------------------------------------------------------------

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.live or key in self.arguments:
            return
        nbytes = st.nbytes()

        def freed(_, key=key):
            self.live_bytes -= self.live.pop(key)[1]

        self.live[key] = (weakref.ref(st, freed), nbytes)
        self.live_bytes += nbytes
        self.peak = max(self.peak, self.base + self.live_bytes)

    # -- counting ------------------------------------------------------------

    def _collective(self, name: str, group, sized) -> None:
        n, link = _group(group, self.hw)
        size = sum(_nbytes(t) for t in _tensors(sized))
        wire = _RING[name](size, n)
        st = self.stats
        st.collective_wire_bytes += wire
        st.collective_by_type[_TYPE[name]] = st.collective_by_type.get(_TYPE[name], 0.0) + wire
        st.wire_bytes_by_link[link] = st.wire_bytes_by_link.get(link, 0.0) + wire
        st.collective_count += 1
        st.add_bytes(_TYPE[name], size)

    @staticmethod
    def _traffic(func, name: str, ins: list, outs: list) -> float:
        in_st = {id(t.untyped_storage()) for t in ins}
        if name in _ALLOCATIONS or (not func._schema.is_mutable and outs
                                    and all(id(t.untyped_storage()) in in_st for t in outs)):
            return 0.0  # an allocation, or a view of an operand
        if name in _GATHERS:
            return 2.0 * sum(map(_nbytes, outs)) + sum(_nbytes(t) for t in ins[1:] if not t.is_floating_point())
        if name in _INDEXED_WRITES:
            return 2.0 * sum(map(_nbytes, ins[1:]))
        if name in _OVERWRITES:
            return float(sum(map(_nbytes, ins)))
        return float(sum(map(_nbytes, ins)) + sum(map(_nbytes, outs)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is not torch.Tensor for t in types):
            # a tensor subclass (a DTensor): let it run its local ops, which
            # come back here on plain tensors
            return NotImplemented
        out = func(*args, **kwargs)
        namespace, _, name = func._schema.name.partition("::")
        st = self.stats
        outs = _tensors(out)
        if namespace.startswith("_c10d_functional"):
            base = name.removesuffix("_coalesced").removesuffix("_")
            if base in _RING:
                self._collective(base, args[-1], out)
        elif name == "allreduce_" and namespace == "c10d":  # torch.distributed.all_reduce(tensors, group, ...)
            self._collective("all_reduce", args[1], args[0])
        elif namespace == "c10d":
            st.notes.append(f"collective uncounted: {func._schema.name}")
        else:
            ins = _tensors((args, kwargs))
            formula = _flop_registry().get(func.overloadpacket)
            if formula is not None:
                st.add_flops(name, unit_of(ins[0].dtype) if ins else "float32",
                             formula(*args, **kwargs, out_val=out))
            nbytes = self._traffic(func, name, ins, outs)
            if nbytes:
                st.add_bytes(name, nbytes)
        for t in outs:
            self._track(t)
        return out

    def record_kernel(self, kernels: tuple, work: tuple, scratch_bytes: int) -> None:
        """One call of a port kernel (the meta route of
        :mod:`repro_torch.kernels.ops` reports it): ``kernels`` the launch
        counts the card's wrapper adds one to (the first names the kernel),
        ``work`` its (FLOPs, bytes, unit), ``scratch_bytes`` the HBM traffic
        of its scratch besides."""
        flops, nbytes, unit = work
        st = self.stats
        for name in kernels:
            st.kernel_calls[name] = st.kernel_calls.get(name, 0) + 1
        st.add_flops(kernels[0], unit, flops)
        st.add_bytes(kernels[0], nbytes + scratch_bytes)


def _flop_registry() -> dict:
    from torch.utils.flop_counter import flop_registry

    return flop_registry


@contextlib.contextmanager
def _local_shapes_only():
    """DTensor works out an op's output metadata by running it at global
    shapes on fake tensors: run that with the count (every dispatch mode)
    switched off, so that only the op on this rank's shards is counted."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    original = ShardingPropagator._propagate_tensor_meta_non_cached

    def quiet(self, op_schema):
        with _disable_current_modes():
            return original(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = quiet
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = original


def count(fn, *args, hw: HW = H100, **kwargs) -> tuple:
    """Run ``fn(*args, **kwargs)`` under the count: returns (:class:`OpStats`,
    its result). Run it on ``meta`` tensors to count a step without memory or
    time; every figure is per device (a DTensor's local shard)."""
    stats = OpStats()
    arguments = {}
    for t in _tensors((args, kwargs)):
        st = t.untyped_storage()
        arguments[id(st)] = st.nbytes()
    stats.argument_bytes = sum(arguments.values())
    counter = _Counter(stats, hw, arguments)
    with _local_shapes_only(), counter:
        out = fn(*args, **kwargs)
    stats.output_bytes = storage_bytes(out)
    stats.peak_bytes = counter.peak
    stats.notes = list(dict.fromkeys(stats.notes))
    return stats, out
