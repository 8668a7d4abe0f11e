"""The port's multi-process bootstrap (``repro_torch.launch.distributed``)
against the reference's ``repro.launch.distributed``, and the data-parallel
step run for real: processes on the CPU joined by gloo from a faked SLURM
environment.

The multi-process runs mirror ``tests/test_compression.py``'s 2 x 2 mesh
check: codeqwen1.5-7b's smoke config, 6 AdamW steps at lr 1e-3 on one
8 x 32 batch, compressed against exact (losses below 6.0, within 0.05 of
each other); the exact step's parameters after one step within 1e-5 of one
process's step on the whole batch (the same mean, summed in another order).
"""

import json
import os
import random
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.launch import distributed as ref
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import distributed as port

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
SLURM_VARS = ("SLURM_JOB_NODELIST", "SLURM_JOB_ID", "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID",
              "SLURM_NODEID", "REPRO_DISABLE_DISTRIBUTED")


@pytest.fixture
def slurm(monkeypatch):
    """Set SLURM variables (the rest unset) for the test."""
    for name in SLURM_VARS:
        monkeypatch.delenv(name, raising=False)

    def set_env(**env):
        for name, value in env.items():
            monkeypatch.setenv(name, str(value))

    return set_env


@pytest.mark.parametrize("nodelist", ["n[001-004,007],m01", "n001", "n[17,19]", "gpu-a[01-02],gpu-b01",
                                      "tpu[004-007]", "", "  h7  "])
@pytest.mark.parametrize("job_id", ["123456", "20000", "0"])
def test_coordinator_matches_reference(slurm, nodelist, job_id):
    slurm(SLURM_JOB_NODELIST=nodelist, SLURM_JOB_ID=job_id)
    assert port._expand_first_host(nodelist) == ref._expand_first_host(nodelist)
    assert port.coordinator_address() == ref.coordinator_address()


@pytest.mark.parametrize("ntasks,procid", [("8", "3"), ("1", "0"), ("2", "1"), ("x", "0"), (None, None),
                                           ("4", None), ("64", "63")])
def test_topology_matches_reference(slurm, ntasks, procid):
    slurm(**{k: v for k, v in (("SLURM_NTASKS", ntasks), ("SLURM_PROCID", procid)) if v is not None})
    assert port.slurm_topology() == ref.slurm_topology()


@pytest.mark.parametrize("kw", [
    dict(job_name="train-x", hosts=64, command="python -m repro_torch.launch.train --arch x", time="2-00:00:00",
         gres="gpu:h100:8", mem_mb=300_000),
    dict(job_name="t", hosts=1, tasks_per_host=4, command="python a.py", partition="gpu", gres="", logdir="out"),
    dict(job_name="t", hosts=2, tasks_per_host=1, command="echo hi", gres="gpu:h100:1"),
])
def test_sbatch_matches_reference(kw):
    assert port.multinode_sbatch(**kw) == ref.multinode_sbatch(**{"tasks_per_host": 8, **kw})


def test_sbatch_defaults_to_a_task_a_gpu():
    s = port.multinode_sbatch(job_name="j", hosts=2, command="python x.py")
    assert "#SBATCH --ntasks=16" in s and "#SBATCH --ntasks-per-node=8" in s
    assert "#SBATCH --gres=gpu:h100:8" in s and "srun --kill-on-bad-exit=1 python x.py" in s


@pytest.mark.parametrize("env", [
    {},  # outside SLURM
    {"SLURM_NTASKS": "1", "SLURM_PROCID": "0", "SLURM_JOB_NODELIST": "n1"},  # a single-task job
    {"REPRO_DISABLE_DISTRIBUTED": "1", "SLURM_NTASKS": "8", "SLURM_PROCID": "3"},
    {"SLURM_JOB_ID": "7", "SLURM_JOB_NODELIST": "n[1-2]"},  # an allocation, no task count
])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_maybe_initialize_is_a_no_op(slurm, env, device):
    slurm(**env)
    assert port.maybe_initialize(device) == (0, 1)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("env,match", [
    ({"SLURM_NTASKS": "4"}, "SLURM_PROCID"),
    ({"SLURM_NTASKS": "4", "SLURM_PROCID": "one"}, "not an integer"),
    ({"SLURM_NTASKS": "four", "SLURM_PROCID": "1"}, "not an integer"),
    ({"SLURM_NTASKS": "4", "SLURM_PROCID": "4", "SLURM_JOB_NODELIST": "n1"}, "outside"),
    ({"SLURM_NTASKS": "4", "SLURM_PROCID": "1"}, "SLURM_JOB_NODELIST"),
])
def test_a_broken_multi_task_environment_raises(slurm, env, match):
    slurm(**env)
    with pytest.raises(RuntimeError, match=match):
        port.maybe_initialize("cpu")
    assert not torch.distributed.is_initialized()


def test_a_gpu_task_needs_its_local_id(slurm):
    slurm(SLURM_NTASKS=2, SLURM_PROCID=0, SLURM_JOB_NODELIST="n1")
    with pytest.raises(RuntimeError, match="SLURM_LOCALID"):
        port.maybe_initialize("cuda")


# ---------------------------------------------------------------------------
# Processes joined by gloo from a faked SLURM environment
# ---------------------------------------------------------------------------


def free_job_id() -> int:
    """A SLURM_JOB_ID whose coordinator port (20000 + id) is free here: the
    tests run beside other workers of one run, so the port is drawn at
    random and tried."""
    for port_no in random.Random(os.getpid()).sample(range(20000, 30000), 500):
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port_no))
            except OSError:
                continue
        return port_no - 20000
    raise RuntimeError("no free port in 20000-29999")


def run_tasks(argv, nodes: list, timeout: float = 150, cwd=None) -> list:
    """Start one process a rank with SLURM's variables (rank i on node
    nodes[i]) and return each rank's stdout; the processes are killed on a
    timeout or a failure of any."""
    job_id = free_job_id()
    local = {}
    procs = []
    for rank, node in enumerate(nodes):
        env = {k: v for k, v in os.environ.items() if k not in SLURM_VARS}
        env.update(PYTHONPATH=str(SRC), OMP_NUM_THREADS="1", SLURM_JOB_ID=str(job_id),
                   SLURM_JOB_NODELIST="localhost", SLURM_NTASKS=str(len(nodes)), SLURM_PROCID=str(rank),
                   SLURM_NODEID=str(node), SLURM_LOCALID=str(local.setdefault(node, [0])[0]))
        local[node][0] += 1
        procs.append(subprocess.Popen(argv, env=env, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{out[-2000:]}\n{err[-3000:]}"
    return [out for out, _ in outs]


DP_WORKER = textwrap.dedent("""
    import json
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.distributed import dp_groups, maybe_initialize
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.registry import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.training import init_dp_state, init_train_state, make_dp_train_step, make_train_step

    torch.set_num_threads(1)
    rank, world = maybe_initialize("cpu")
    groups = dp_groups()
    cfg = get_smoke_config("codeqwen1.5-7b")
    model = build_model(cfg)
    opt = make_optimizer("adamw", lr=1e-3)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 32)).astype(np.int32))
    batch = {"tokens": tokens, "labels": tokens}
    rows = 8 // world
    shard = {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}
    out = {"rank": rank, "world": world, "data": torch.distributed.get_world_size(groups["data"]),
           "pod": torch.distributed.get_world_size(groups["pod"])}
    for compress in (False, True):
        step = make_dp_train_step(model, opt, groups, compress=compress)
        state = init_dp_state(model, opt, torch.Generator().manual_seed(0), "cpu", compress=compress)
        for i in range(6):
            state, metrics = step(state, shard)
            if i == 0 and not compress:
                first = {p: t.clone() for p, t in tree_leaves(state["params"])}
        out[f"loss_{compress}"] = float(metrics["loss"])
        out[f"ef_{compress}"] = "ef" in state
    if rank == 0:
        state = init_train_state(model, opt, torch.Generator().manual_seed(0), "cpu")
        single, _ = make_train_step(model, opt)(state, batch)
        out["one_step_err"] = max(float((first[p] - t).abs().max()) for p, t in tree_leaves(single["params"]))
    print("RESULT " + json.dumps(out))
""")


def results(outs) -> list:
    return [json.loads(line.split(" ", 1)[1]) for out in outs for line in out.splitlines()
            if line.startswith("RESULT ")]


def test_four_ranks_on_two_nodes_train_compressed_as_exact():
    """4 gloo processes, 2 "nodes" of 2: the exact and the compressed DP step
    train alike, and one exact step equals one process's step on the whole
    batch."""
    res = results(run_tasks([sys.executable, "-c", DP_WORKER], nodes=[0, 0, 1, 1]))
    assert [r["rank"] for r in res] == [0, 1, 2, 3]
    assert all(r["world"] == 4 and r["data"] == 2 and r["pod"] == 2 for r in res)
    exact, compressed = res[0]["loss_False"], res[0]["loss_True"]
    assert exact < 6.0 and compressed < 6.0, res[0]
    assert abs(exact - compressed) < 0.05, res[0]
    assert all(r["loss_False"] == exact and r["loss_True"] == compressed for r in res)  # one update everywhere
    assert [r["ef_True"] for r in res] == [True] * 4 and not any(r["ef_False"] for r in res)
    assert res[0]["one_step_err"] < 1e-5, res[0]


def test_the_train_launcher_under_srun_matches_one_process(tmp_path):
    """``python -m repro_torch.launch.train`` as a 2-task job on 2 "nodes"
    (the pod leg, exact): each rank reads its half of every batch, rank 0
    writes the checkpoint, and its parameters equal a single process's run
    on the whole batch within 1e-5."""
    def argv(ckpt):
        return [sys.executable, "-m", "repro_torch.launch.train", "--arch", "nbi-100m", "--smoke", "--device",
                "cpu", "--steps", "3", "--global-batch", "4", "--seq", "16", "--ckpt-dir", str(ckpt),
                "--ckpt-every", "3", "--log-every", "1"]

    outs = run_tasks(argv(tmp_path / "dp"), nodes=[0, 1])
    assert all("[train] step 3/3" in out for out in outs)
    single = subprocess.run(argv(tmp_path / "one"), env={**os.environ, "PYTHONPATH": str(SRC)},
                            capture_output=True, text=True, timeout=120)
    assert single.returncode == 0, single.stderr[-2000:]
    trees = {}
    for name in ("dp", "one"):
        manager = CheckpointManager(tmp_path / name)
        assert manager.all_steps() == [3]
        trees[name] = json.loads((manager.step_dir(3) / "MANIFEST.json").read_text())
        trees[name]["dir"] = manager.step_dir(3)
    assert trees["dp"]["extra"]["data_cursor"] == trees["one"]["extra"]["data_cursor"] == 3
    for a, b in zip(trees["dp"]["leaves"], trees["one"]["leaves"]):
        assert a["keypath"] == b["keypath"] and a["shape"] == b["shape"] and a["dtype"] == b["dtype"]
        if a["dtype"] == "float32":
            x = torch.frombuffer(bytearray((trees["dp"]["dir"] / a["file"]).read_bytes()), dtype=torch.float32)
            y = torch.frombuffer(bytearray((trees["one"]["dir"] / b["file"]).read_bytes()), dtype=torch.float32)
            assert float((x - y).abs().max()) < 1e-5, a["keypath"]
