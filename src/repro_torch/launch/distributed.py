"""Multi-process bootstrap: SLURM's environment → ``torch.distributed`` (the
port of ``repro.launch.distributed``).

On a cluster every task of the job runs the same ``python -m
repro_torch.launch.train`` under ``srun``, one task per GPU; this module reads
the process topology from SLURM's environment (no extra config system):

    SLURM_JOB_NODELIST   → coordinator host (first entry, expanded)
    SLURM_JOB_ID         → coordinator port (stable per job, 20000-29999)
    SLURM_NTASKS         → world size
    SLURM_PROCID         → rank
    SLURM_LOCALID        → the GPU this task drives on its node
    SLURM_NODEID         → the node: the "pod" of the data-parallel step

``maybe_initialize(device)`` is a no-op outside SLURM (single-process runs),
in a single-task job and under ``REPRO_DISABLE_DISTRIBUTED=1``, and returns
(rank, world size) either way, so the data pipeline's host sharding can
always be derived from it. A multi-task job with a broken environment raises:
it never falls back to a single process, which would train a model of its own
beside the others.

:func:`dp_groups` builds the two groups of the data-parallel step
(:mod:`repro_torch.training.dp_step`): "data", the GPUs of one node, and
"pod", the tasks of equal place on every node, so that the step's compressed
leg is the one between nodes.
"""

from __future__ import annotations

import os
import re

import torch
import torch.distributed as dist


def _expand_first_host(nodelist: str) -> str:
    """First hostname of a SLURM nodelist (handles "n[001-004,007],m01")."""
    m = re.match(r"^([^,\[]+)(\[([^\]]+)\])?", nodelist.strip())
    if not m:
        return nodelist.strip()
    prefix, _, ranges = m.groups()
    if not ranges:
        return prefix
    first = ranges.split(",")[0].split("-")[0]
    return f"{prefix}{first}"


def coordinator_address() -> "str | None":
    nodelist = os.environ.get("SLURM_JOB_NODELIST", "")
    if not nodelist:
        return None
    host = _expand_first_host(nodelist)
    port = 20000 + int(os.environ.get("SLURM_JOB_ID", "0")) % 10000
    return f"{host}:{port}"


def slurm_topology() -> "tuple[int, int] | None":
    """(process_index, process_count) from SLURM env, or None."""
    try:
        n = int(os.environ["SLURM_NTASKS"])
        i = int(os.environ["SLURM_PROCID"])
    except (KeyError, ValueError):
        return None
    return (i, n) if n > 1 else None


def _slurm_int(name: str) -> int:
    value = os.environ.get(name)
    if value is None:
        raise RuntimeError(f"multi-task SLURM job without ${name}: cannot place this task")
    try:
        return int(value)
    except ValueError:
        raise RuntimeError(f"${name}={value!r} is not an integer") from None


def initialize(device, rank: int, world: int, address: str, local_rank: int = 0) -> "tuple[int, int]":
    """Join the process group at ``tcp://<address>``: NCCL on ``cuda`` (each
    task pinned to GPU ``local_rank`` first), gloo on ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=f"tcp://{address}",
                            world_size=world, rank=rank)
    return rank, world


def maybe_initialize(device="cuda") -> "tuple[int, int]":
    """Join the process group when launched as a multi-task SLURM job; returns
    (rank, world size)."""
    if os.environ.get("REPRO_DISABLE_DISTRIBUTED") == "1" or "SLURM_NTASKS" not in os.environ:
        return 0, 1
    world = _slurm_int("SLURM_NTASKS")
    if world <= 1:
        return 0, 1
    rank = _slurm_int("SLURM_PROCID")
    if not 0 <= rank < world:
        raise RuntimeError(f"$SLURM_PROCID={rank} is outside 0..{world - 1}")
    address = coordinator_address()
    if address is None:
        raise RuntimeError("multi-task SLURM job without $SLURM_JOB_NODELIST: no coordinator")
    local_rank = _slurm_int("SLURM_LOCALID") if torch.device(device).type == "cuda" else 0
    return initialize(device, rank, world, address, local_rank)


def dp_groups() -> dict:
    """``{"data": group, "pod": group}`` of this rank: "data" holds the ranks
    on its node (``SLURM_NODEID``, 0 when unset), "pod" the ranks of equal
    place on every node. Every rank calls this together (each group is
    created by all ranks, in one order). Nodes must hold equal numbers of
    ranks."""
    rank = dist.get_rank()
    nodes = [None] * dist.get_world_size()
    dist.all_gather_object(nodes, int(os.environ.get("SLURM_NODEID", "0")))
    by_node = {}
    for r, node in enumerate(nodes):
        by_node.setdefault(node, []).append(r)
    members = list(by_node.values())
    if len({len(m) for m in members}) != 1:
        raise RuntimeError(f"nodes hold unequal numbers of ranks: {by_node}")
    groups = {}
    for name, lists in (("data", members), ("pod", [list(p) for p in zip(*members)])):
        for ranks in lists:
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[name] = group
    return groups


def multinode_sbatch(
    *, job_name: str, hosts: int, tasks_per_host: int = 8,
    command: str, time: str = "1-00:00:00", partition: str = "",
    gres: str = "gpu:h100:8", mem_mb: int = 300_000, logdir: str = "logs",
) -> str:
    """A complete multi-node sbatch script: one srun task per GPU, each
    running the SAME command; :func:`maybe_initialize` picks up the
    topology."""
    lines = [
        "#!/bin/bash",
        f"#SBATCH --job-name={job_name}",
        f"#SBATCH --nodes={hosts}",
        f"#SBATCH --ntasks={hosts * tasks_per_host}",
        f"#SBATCH --ntasks-per-node={tasks_per_host}",
        f"#SBATCH --mem={mem_mb}",
        f"#SBATCH --time={time}",
        f"#SBATCH --output={logdir}/{job_name}.%j.out",
        f"#SBATCH --error={logdir}/{job_name}.%j.err",
        "#SBATCH --requeue",
    ]
    if partition:
        lines.insert(2, f"#SBATCH --partition={partition}")
    if gres:
        lines.append(f"#SBATCH --gres={gres}")
    lines += [
        "",
        "set -euo pipefail",
        f"mkdir -p {logdir}",
        "# every task runs the same command; topology comes from SLURM env",
        f"srun --kill-on-bad-exit=1 {command}",
    ]
    return "\n".join(lines) + "\n"
