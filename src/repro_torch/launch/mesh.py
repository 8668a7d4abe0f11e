"""Device meshes of the port (the port of ``repro.launch.mesh``).

Functions, never module-level constants: importing this module touches no
device and no process group.

The reference's production mesh is a TPU pod's 16 × 16 chips (2 × 16 ×
16 across two pods), every chip joined to its neighbours by the same
inter-chip links. H100 nodes have no counterpart: 8 GPUs a node joined all
to all by NVLink, the nodes by a much slower network. So a job's mesh is
not a fixed shape: it comes from ``--mesh`` (``data=D,model=M``, optionally
``pod=P,...``) and SLURM's topology, with ``model`` (tensor and expert
parallelism, a collective every layer) inside a node and ``data`` (and
``pod``) across nodes. Ranks are laid out row-major over (pod, data, model),
so a ``model`` group is ``model`` consecutive ranks, which SLURM's block
distribution places on one node; :func:`make_job_mesh` checks that it does.
"""

from __future__ import annotations

import dataclasses
import math
import os
import socket

import torch
import torch.distributed as dist

AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices or a process group
    (the sizing of a job at submission reads only these)."""

    mesh_dim_names: tuple
    shape: tuple

    def size(self, dim: "int | None" = None) -> int:
        return math.prod(self.shape) if dim is None else self.shape[dim]

    def spec(self) -> str:
        """The ``--mesh`` value of this shape."""
        return ",".join(f"{a}={n}" for a, n in zip(self.mesh_dim_names, self.shape))


def parse_mesh(spec: str, world: "int | None" = None) -> MeshShape:
    """``"data=D,model=M"`` (also ``pod=P``; any order) → a MeshShape over
    (pod, data, model) in that order, without ``pod`` unless it is given.
    A missing ``data`` is ``world / (pod · model)``; with ``world`` the
    sizes must multiply to it."""
    sizes = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        name, _, value = part.partition("=")
        if name not in AXES or not value.isdigit() or int(value) < 1 or name in sizes:
            raise ValueError(f"--mesh {spec!r}: expected axis=size pairs over {AXES}, each at most once")
        sizes[name] = int(value)
    if "data" not in sizes:
        rest = sizes.get("pod", 1) * sizes.get("model", 1)
        if world is None or world % rest:
            raise ValueError(f"--mesh {spec!r}: cannot infer the data axis from {world} ranks")
        sizes["data"] = world // rest
    sizes.setdefault("model", 1)
    names = tuple(a for a in AXES if a in sizes)
    shape = MeshShape(names, tuple(sizes[a] for a in names))
    if world is not None and shape.size() != world:
        raise ValueError(f"--mesh {spec!r} holds {shape.size()} ranks; the job has {world}")
    return shape


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ensure_group(device: torch.device) -> None:
    """A process group of one on ``tcp://localhost`` when none exists (NCCL
    on the card, gloo on the CPU)."""
    if not dist.is_initialized():
        from .distributed import initialize

        initialize(device, 0, 1, f"localhost:{_free_port()}")


def make_host_mesh(device="cuda"):
    """A 1 × 1 ("data", "model") mesh over the local device (a group of one
    rank is created if there is none): smoke tests and the card's mesh leg."""
    device = torch.device(device)
    _ensure_group(device)
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device.type, (1, 1), mesh_dim_names=("data", "model"))


def make_job_mesh(spec: str, device="cuda"):
    """The job's mesh from ``--mesh`` over the process group (joined by
    :func:`repro_torch.launch.distributed.maybe_initialize`; a group of one
    is created outside SLURM). Every rank calls it together. Raises when a
    ``model`` group would span nodes (``SLURM_NODEID``)."""
    device = torch.device(device)
    _ensure_group(device)
    shape = parse_mesh(spec, dist.get_world_size())
    model = shape.shape[-1]
    nodes = [None] * dist.get_world_size()
    dist.all_gather_object(nodes, int(os.environ.get("SLURM_NODEID", "0")))
    for first in range(0, len(nodes), model):
        if len(set(nodes[first:first + model])) > 1:
            raise RuntimeError(f"--mesh {spec}: model group of ranks {first}..{first + model - 1} spans nodes "
                               f"{sorted(set(nodes[first:first + model]))}; keep the model axis within a node")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device.type, shape.shape, mesh_dim_names=shape.mesh_dim_names)


def data_coordinate(mesh) -> "tuple[int, int]":
    """(this rank's index over the data axes, their size): the host shard of
    the data pipeline, equal for ranks that differ only in ``model``."""
    index, count = 0, 1
    for i, name in enumerate(mesh.mesh_dim_names):
        if name in ("pod", "data"):
            index = index * mesh.size(i) + mesh.get_local_rank(i)
            count *= mesh.size(i)
    return index, count
