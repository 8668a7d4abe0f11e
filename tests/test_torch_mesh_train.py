"""Training on a device mesh (``make_train_step(model, optimizer, rules,
mesh)``, ``repro_torch.parallel.sharding``) against the plain port step, in
gloo process groups of four CPU ranks.

Each mesh runs once, in four processes, for every config named below: from
the plain step's seeded state, the sharded gradients of the first batch and
two sharded steps, which rank 0 writes (gathered) to a file that the tests
read, with a digest of the config, the seeded state and the batches; in the
(2, 2) and (4, 1) runs rank 0 also runs the plain port step on the same
batches in its own process. The (1, 4) run, whose configs are the (2, 2)
run's, is held to the (2, 2) run's plain step, the two digests equal.
Meshes: (2, 2) with each config's own FSDP flag, (4, 1) with FSDP
forced on (every ``embed`` dim over ``data``: ZeRO-3), and (1, 4) for
mistral-large-123b's smoke config, whose 4 query heads shard and 2 KV heads
do not (the GQA repeat), and the three forms below. rwkv6-7b and
recurrentgemma-2b (heads and the ``lru`` channels over ``model``) reach the
WKV-6 and RG-LRU recurrences through the ops' local-shard routes.
minicpm3-4b (MLA: its heads over ``model``, the shared roped key expanded
over each rank's heads), llava-next-mistral-7b (seeded patches before the
text, labels -100 on them) and whisper-small (seeded audio frames; heads,
``ff`` and the vocab over ``model``) run on every mesh. The (2, 2) run also saves nbi-100m's state after
one step, which the (4, 1) run restores (elastic restore) and steps on, and
computes the sharded loss on weights carried over from the reference's init
(``convert.params_from_jax``), held against the reference's ``loss_fn`` with
no rules (ROADMAP H1: its meshes fail under this JAX version).

Tolerances: loss and metrics, and every gradient leaf, atol 2e-5 / rtol 1e-4
(the sharded step sums in other orders: over shards, then across ranks).
Parameters after the first step by ``tests/test_torch_dp.py``'s
Adam-first-step bound: Adam's first step moves an entry by lr·f(g),
f(g) = g / (|g| + eps), so an entry may differ by lr·|f(g1) - f(g2)| +
1e-6 from each run's own clipped g.
After the second step (AdamW's f32 moments) by the same identity one step
on: p2 = p1·(1 - lr·wd) - lr·u2, u2 = m̂/(√v̂ + eps) from each run's own
moments, so |Δp2| ≤ |Δp1| + lr·|Δu2| + 1e-6. 8-bit AdamW (kimi-k2's): its
first moment after one step within one quantum of its row (|Δq| ≤ 1) and
each row's scale (the absmax of the whole row, across the shards of its last
axis) within rtol 1e-4; its parameters only after the first step, as the
port's other parity tests hold it (ROADMAP H9). The elastic restore equals
the saved state bit for bit.

Every multi-process run has its own time limit (RUN_TIMEOUT); a rank that
fails or a run past the limit kills all four processes, and the gloo groups
time out their collectives (GLOO_TIMEOUT_S).
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models.common import tree_leaves
from test_torch_distributed import SLURM_VARS, free_job_id

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
LR, EPS, WD, B1, B2 = 1e-3, 1e-8, 0.1, 0.9, 0.95
ATOL, RTOL = 2e-5, 1e-4
RUN_TIMEOUT = 240
GLOO_TIMEOUT_S = 120
ARCHS = ["nbi-100m", "mistral-large-123b", "starcoder2-7b", "deepseek-moe-16b", "kimi-k2-1t-a32b", "rwkv6-7b",
         "recurrentgemma-2b", "minicpm3-4b", "llava-next-mistral-7b", "whisper-small"]
# the (1, 4) run: 4 query heads over 2 KV heads, and the three forms whose
# heads (MLA's, Whisper's) or prefix (llava's, 4 over 2) split four ways
WIDE_ARCHS = ["mistral-large-123b", "minicpm3-4b", "llava-next-mistral-7b", "whisper-small"]
BATCH, SEQ = 8, 32
ELASTIC_ARCH = "nbi-100m"

WORKER = r'''
import datetime, hashlib, json, os, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.data import make_train_loader
from repro_torch.models.common import tree_leaves
from repro_torch.models.registry import build_model
from repro_torch.optim import make_optimizer
from repro_torch.parallel.sharding import distribute_tree, full_tree, resolve_tree, rules_for, use_rules
from repro_torch.training import abstract_train_state, init_train_state, make_train_step, train_state_logical
from repro_torch.training.steps import make_grad_fn

job = json.loads(sys.argv[1])
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{job['port']}", rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=job["gloo_timeout"]))
mesh = init_device_mesh("cpu", tuple(job["shape"]), mesh_dim_names=("data", "model"))
out = job["out"]


def digest(cfg, *trees) -> str:
    """A hash of ``cfg`` and every leaf of ``trees``, bit for bit."""
    h = hashlib.sha256(repr(cfg).encode())
    for tree in trees:
        for path, leaf in tree_leaves(tree):
            h.update(path.encode())
            h.update(leaf.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def extras(cfg, batches):
    """Seeded audio frames for Whisper, patches for a visual prefix (labels
    then -100 on the patches): the data pipeline makes tokens only."""
    g = torch.Generator().manual_seed(6)
    for b in batches:
        B = b["tokens"].shape[0]
        if cfg.family == "encdec":
            b["frames"] = torch.randn((B, cfg.enc_len, cfg.d_model), generator=g)
        if cfg.n_patches:
            b["patches"] = torch.randn((B, cfg.n_patches, cfg.d_model), generator=g)
            b["labels"] = torch.cat([torch.full((B, cfg.n_patches), -100, dtype=b["labels"].dtype), b["labels"]], 1)


for arch in job["archs"]:
    cfg = get_smoke_config(arch).replace(**job.get("overrides", {}).get(arch, {}))
    if job["fsdp"]:
        cfg = cfg.replace(fsdp=True)
    model = build_model(cfg)
    opt = make_optimizer(cfg.optimizer, lr=job["lr"])
    loader = make_train_loader(model.cfg.vocab_size, job["batch"], job["seq"], seed=0)
    batches = [{k: torch.from_numpy(v) for k, v in next(loader).items()} for _ in range(2)]
    loader.close()
    extras(cfg, batches)
    rules = rules_for(cfg, mesh, param_defs=model.param_defs, batch_size=job["batch"],
                      extra_dims={"heads": cfg.n_heads})
    placements = resolve_tree(mesh, train_state_logical(model, opt), rules)
    inputs = resolve_tree(mesh, model.train_input_logical(), rules)
    fed = [distribute_tree(b, mesh, inputs) for b in batches]
    state0 = init_train_state(model, opt, torch.Generator().manual_seed(0), "cpu")
    grads_fn = make_grad_fn(model, placements["params"], mesh)
    with use_rules(rules, mesh):
        grads = full_tree(grads_fn(distribute_tree(state0["params"], mesh, placements["params"]), fed[0])[2])
    step = make_train_step(model, opt, rules, mesh)
    s1, m1 = step(distribute_tree(state0, mesh, placements), fed[0])
    s2, m2 = step(s1, fed[1])
    result = {"rules": {k: v for k, v in rules.items()}, "grads": grads, "s1": full_tree(s1),
              "s2": full_tree(s2), "m": [{k: float(v) for k, v in m.items()} for m in (m1, m2)],
              "inputs": digest(cfg, state0, dict(enumerate(batches)))}
    if arch == job["elastic_arch"] and job["save"]:
        CheckpointManager(job["save"]).save_sharded(1, s1)
    if arch == job["elastic_arch"] and job["restore"]:
        r1, _, _ = CheckpointManager(job["restore"]).restore_sharded(abstract_train_state(model, opt), placements,
                                                                     mesh, device="cpu")
        e2, _ = step(r1, fed[1])
        result.update(restored=full_tree(r1), elastic=full_tree(e2))
    if arch == job["elastic_arch"] and job["ref_weights"]:
        ref = torch.load(job["ref_weights"])
        params = distribute_tree(ref["params"], mesh, placements["params"])
        batch = distribute_tree(ref["batch"], mesh, inputs)
        with use_rules(rules, mesh):
            loss, metrics = model.loss_fn(params, batch)
        result["ref_case"] = {"loss": float(loss.full_tensor()), **{k: float(v.full_tensor())
                                                                      for k, v in metrics.items()}}
    if rank == 0:
        if job["plain"]:
            plain = make_train_step(model, opt)
            p1, pm1 = plain(state0, batches[0])
            p2, pm2 = plain(p1, batches[1])
            result["plain"] = {"grads": make_grad_fn(model)(state0["params"], batches[0])[2], "s1": p1, "s2": p2,
                               "m": [{k: float(v) for k, v in m.items()} for m in (pm1, pm2)]}
        torch.save(result, os.path.join(out, arch + ".pt"))
dist.destroy_process_group()
'''


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(job: dict, world: int = 4, timeout: float = RUN_TIMEOUT) -> None:
    """Run WORKER in ``world`` processes."""
    arg = json.dumps({**job, "port": free_port(), "gloo_timeout": GLOO_TIMEOUT_S, "lr": LR, "batch": BATCH,
                      "seq": SEQ, "elastic_arch": ELASTIC_ARCH})
    run_processes([[sys.executable, "-c", WORKER, arg]] * world,
                  [{"WORLD_SIZE": str(world), "RANK": str(r)} for r in range(world)], Path(job["out"]), timeout)


def run_processes(argvs: list, envs: list, out: Path, timeout: float = RUN_TIMEOUT) -> list:
    """Start one process an argv (with its extra environment), each writing
    ``out/rank<i>.log``; kill them all when one fails or the time limit
    passes. Returns the logs' text."""
    env = {k: v for k, v in os.environ.items() if k not in SLURM_VARS}
    env.update(PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    logs = [out / f"rank{r}.log" for r in range(len(argvs))]
    procs = [subprocess.Popen(argv, env={**env, **extra}, stdout=open(log, "w"), stderr=subprocess.STDOUT)
             for argv, extra, log in zip(argvs, envs, logs)]
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                raise AssertionError(f"rank {failed[0]} failed:\n{logs[failed[0]].read_text()[-4000:]}")
            if all(c == 0 for c in codes):
                return [log.read_text() for log in logs]
            if time.monotonic() > deadline:
                raise AssertionError(f"mesh run past its {timeout} s limit:\n{logs[0].read_text()[-2000:]}")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


@pytest.fixture(scope="module")
def reference_case(tmp_path_factory):
    """The reference's nbi-100m smoke weights (converted), a batch, and the
    reference's loss and metrics on them without rules."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as jax_get_smoke_config
    from repro.models.registry import build_model as jax_build_model
    from repro_torch import convert

    jmodel = jax_build_model(jax_get_smoke_config(ELASTIC_ARCH))
    np_params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, 512, (BATCH, SEQ)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((BATCH, 1), -100, np.int32)], axis=1)
    batch = {"tokens": tokens, "labels": labels}
    loss, metrics = jmodel.loss_fn(jax.tree_util.tree_map(jax.numpy.asarray, np_params),
                                   {k: jax.numpy.asarray(v) for k, v in batch.items()})
    path = tmp_path_factory.mktemp("ref") / "weights.pt"
    torch.save({"params": convert.params_from_jax(np_params, device="cpu"),
                "batch": {k: torch.from_numpy(v) for k, v in batch.items()}}, path)
    return path, {"loss": float(loss), **{k: float(v) for k, v in metrics.items()}}


@pytest.fixture(scope="module")
def mesh_2x2(tmp_path_factory, reference_case):
    out = tmp_path_factory.mktemp("mesh_2x2")
    run_ranks({"shape": [2, 2], "fsdp": None, "archs": ARCHS, "out": str(out), "save": str(out / "ckpt"),
               "restore": None, "ref_weights": str(reference_case[0]), "plain": True})
    return out


@pytest.fixture(scope="module")
def mesh_4x1(tmp_path_factory, mesh_2x2):
    out = tmp_path_factory.mktemp("mesh_4x1")
    run_ranks({"shape": [4, 1], "fsdp": True, "archs": ARCHS, "out": str(out), "save": None,
               "restore": str(mesh_2x2 / "ckpt"), "ref_weights": None, "plain": True})
    return out


@pytest.fixture(scope="module")
def mesh_1x4(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_1x4")
    run_ranks({"shape": [1, 4], "fsdp": None, "archs": WIDE_ARCHS, "out": str(out), "save": None,
               "restore": None, "ref_weights": None, "plain": False})
    return out


@pytest.fixture(scope="module")
def runs(request):
    return {"2x2": request.getfixturevalue("mesh_2x2"), "4x1": request.getfixturevalue("mesh_4x1"),
            "1x4": request.getfixturevalue("mesh_1x4")}


CASES = [("2x2", a) for a in ARCHS] + [("4x1", a) for a in ARCHS] + [("1x4", a) for a in WIDE_ARCHS]


def load(runs, mesh, arch) -> dict:
    return torch.load(runs[mesh] / f"{arch}.pt", weights_only=False)


def leaves(tree) -> dict:
    return {p: t.double().numpy() for p, t in tree_leaves(tree)}


def close(got, want, what, atol=ATOL, rtol=RTOL):
    err = np.abs(got - want) - (atol + rtol * np.abs(want))
    assert err.max(initial=-1) <= 0, f"{what}: past atol {atol} / rtol {rtol} by {err.max()}"


def clipped(grads: dict) -> dict:
    norm = np.sqrt(sum(float((g ** 2).sum()) for g in grads.values()))
    return {p: g * min(1.0, 1.0 / max(norm, 1e-12)) for p, g in grads.items()}


def adam_direction(m, v, count):
    return (m / (1 - B1 ** count)) / (np.sqrt(np.maximum(v, 0.0) / (1 - B2 ** count)) + EPS)


def moments(state: dict, count: int, eight_bit: bool) -> dict:
    """u = m̂ / (√v̂ + eps) of every parameter from a state's moments."""
    flat = leaves(state)
    out = {}
    for key in leaves(state["params"]):
        if eight_bit:
            m, v = (flat[f"['opt']['{w}']{key}['q']"] * flat[f"['opt']['{w}']{key}['scale']"][..., None]
                    for w in ("m", "v"))
        else:
            m, v = flat[f"['opt']['m']{key}"], flat[f"['opt']['v']{key}"]
        out["['params']" + key] = adam_direction(m, v, count)
    return out


@pytest.mark.parametrize("mesh,arch", CASES)
def test_sharded_step_matches_the_plain_step(runs, mesh, arch):
    r = load(runs, mesh, arch)
    source = r if "plain" in r else load(runs, "2x2", arch)  # (1, 4): the (2, 2) run's plain step
    assert r["inputs"] == source["inputs"]  # the same config, seeded state and batches
    plain = source["plain"]
    rules = r["rules"]
    if mesh == "4x1":
        assert rules["embed"] == "data" and rules["batch"] == "data"  # ZeRO-3 over data
    if mesh == "1x4":
        assert rules["heads"] == "model"
        if get_smoke_config(arch).n_kv_heads % 4:
            assert rules["kv_heads"] is None  # the GQA repeat
    for got, want in zip(r["m"], plain["m"]):
        assert set(got) == set(want)
        for k in want:
            close(np.float64(got[k]), np.float64(want[k]), f"metric {k}")
    g_got, g_want = leaves(r["grads"]), leaves(plain["grads"])
    for p in g_want:
        close(g_got[p], g_want[p], f"gradient {p}")
    s1, p1 = leaves(r["s1"]), leaves(plain["s1"])
    f = lambda g: g / (np.abs(g) + EPS)  # noqa: E731
    cg_got, cg_want = clipped(g_got), clipped(g_want)
    for p in g_want:
        key = "['params']" + p
        bound = LR * np.abs(f(cg_got[p]) - f(cg_want[p])) + 1e-6
        assert (np.abs(s1[key] - p1[key]) <= bound).all(), f"{key} after step 1: {np.abs(s1[key] - p1[key]).max()}"
    eight_bit = "['opt']['m']['embed']['q']" in p1
    if eight_bit:
        for key in p1:
            if key.endswith("['q']"):
                assert np.abs(s1[key] - p1[key]).max() <= 1, key
            elif key.endswith("['scale']"):
                close(s1[key], p1[key], key, atol=1e-12)
        return
    s2, p2 = leaves(r["s2"]), leaves(plain["s2"])
    u_got, u_want = moments(r["s2"], 2, False), moments(plain["s2"], 2, False)
    for key in u_want:
        bound = np.abs(s1[key] - p1[key]) + LR * np.abs(u_got[key] - u_want[key]) + 1e-6
        assert (np.abs(s2[key] - p2[key]) <= bound).all(), f"{key} after step 2"


def test_elastic_restore_onto_another_mesh(runs):
    """Saved after one step on (2, 2), restored onto (4, 1) with FSDP: the
    restored state is the saved one bit for bit, and its second step matches
    the plain step's."""
    saved = load(runs, "2x2", ELASTIC_ARCH)
    r = load(runs, "4x1", ELASTIC_ARCH)
    for (p, a), (_, b) in zip(tree_leaves(r["restored"]), tree_leaves(saved["s1"])):
        assert torch.equal(a, b), p
    p1, p2 = leaves(saved["plain"]["s1"]), leaves(saved["plain"]["s2"])
    e1, e2 = leaves(r["restored"]), leaves(r["elastic"])
    u_got, u_want = moments(r["elastic"], 2, False), moments(saved["plain"]["s2"], 2, False)
    for key in u_want:
        bound = np.abs(e1[key] - p1[key]) + LR * np.abs(u_got[key] - u_want[key]) + 1e-6
        assert (np.abs(e2[key] - p2[key]) <= bound).all(), key


def test_sharded_loss_matches_the_reference(runs, reference_case):
    """nbi-100m's loss and metrics on the reference's weights, sharded over
    (2, 2) (vocab, heads and ff over model, the batch over data), against
    the reference's loss_fn without rules."""
    got = load(runs, "2x2", ELASTIC_ARCH)["ref_case"]
    _, want = reference_case
    assert set(got) == set(want)
    for k in want:
        close(np.float64(got[k]), np.float64(want[k]), k)


def test_checkpoint_is_the_unsharded_format(runs):
    """The sharded save writes the one-device format: restore_tree reads it
    into the plain state's structure, equal to the gathered state."""
    from repro_torch.checkpoint.manager import restore_tree

    saved = load(runs, "2x2", ELASTIC_ARCH)
    tree, _ = restore_tree(runs["2x2"] / "ckpt" / "step_000000001", saved["s1"])
    for (p, a), (_, b) in zip(tree_leaves(tree), tree_leaves(saved["s1"])):
        assert torch.equal(a, b), p


def train_losses(log: str) -> list:
    return [float(line.split("loss=")[1].split()[0]) for line in log.splitlines() if line.startswith("[train] step")]


def test_launcher_trains_on_a_mesh_of_slurm_tasks(tmp_path):
    """``python -m repro_torch.launch.train --mesh data=2,model=2`` as four
    SLURM tasks against ``--mesh data=1,model=1`` in one process, for
    mistral-large-123b's smoke config (FSDP, so both run the mesh step):
    the sharded init draws the same weights on every mesh, and ranks that
    differ only in ``model`` read the same rows (their data coordinate's),
    so the losses agree step by step (printed to 4 decimals)."""
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "mistral-large-123b", "--smoke",
            "--device", "cpu", "--steps", "3", "--global-batch", str(BATCH), "--seq", str(SEQ), "--log-every", "1"]
    job = str(free_job_id())
    slurm = [{"SLURM_JOB_ID": job, "SLURM_JOB_NODELIST": "localhost", "SLURM_NTASKS": "4", "SLURM_PROCID": str(r),
              "SLURM_NODEID": "0", "SLURM_LOCALID": str(r)} for r in range(4)]
    (tmp_path / "four").mkdir()
    (tmp_path / "one").mkdir()
    four = run_processes([argv + ["--mesh", "data=2,model=2"]] * 4, slurm, tmp_path / "four")
    one = run_processes([argv + ["--mesh", "data=1,model=1"]], [{}], tmp_path / "one")
    got, want = train_losses(four[0]), train_losses(one[0])
    assert len(got) == len(want) == 3, (four[0][-2000:], one[0][-2000:])
    assert np.allclose(got, want, rtol=RTOL, atol=1e-4), (got, want)
    assert train_losses(four[1]) == got  # a model-axis peer logs the same losses


@pytest.mark.gpu
def test_local_route_launches_the_kernels_on_the_card():
    """On a 1 x 1 NCCL mesh, CUDA DTensors reach the kernels as local
    tensors: one launch each, the same values as a plain call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels import flash_attention, moe_gating, rmsnorm

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        rng = np.random.default_rng(0)
        q, k, v = (torch.from_numpy(rng.standard_normal((2, 4, 256, 64)).astype(np.float32)).cuda()
                   for _ in range(3))
        x = torch.from_numpy(rng.standard_normal((2, 256, 768)).astype(np.float32)).cuda()
        w = torch.ones(768, device="cuda")
        logits = torch.from_numpy(rng.standard_normal((4, 64, 64)).astype(np.float32)).cuda()
        rows = (Shard(0), Shard(1))
        on = lambda t, *pl: DTensor.from_local(t, mesh, pl or rows, run_check=False)  # noqa: E731
        before = (flash_attention.tf32_launches, rmsnorm.launches, moe_gating.launches)
        a = ops.attention(on(q), on(k), on(v), causal=True).to_local()
        n = ops.rmsnorm(on(x, Shard(0), Replicate()), on(w, Replicate(), Replicate())).to_local()
        g = ops.moe_gating(on(logits, Shard(0), Replicate()), top_k=6, capacity=8)[0].to_local()
        after = (flash_attention.tf32_launches, rmsnorm.launches, moe_gating.launches)
        assert [b - a_ for a_, b in zip(before, after)] == [1, 1, 1]
        assert torch.equal(a, ops.attention(q, k, v, causal=True))
        assert torch.equal(n, ops.rmsnorm(x, w))
        assert torch.equal(g, ops.moe_gating(logits, top_k=6, capacity=8)[0])
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_recurrence_routes_launch_their_kernels_on_the_card():
    """On a 1 x 1 NCCL mesh, CUDA DTensors split over their rows and channels
    (K3) or heads (K4) reach the RG-LRU and WKV-6 kernels as local tensors:
    one launch each, the same values as a plain call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels import rglru_scan, rwkv6_scan

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        g = torch.Generator(device="cuda").manual_seed(0)
        a = torch.rand((2, 256, 512), generator=g, device="cuda")
        b = torch.randn((2, 256, 512), generator=g, device="cuda")
        h0 = torch.randn((2, 512), generator=g, device="cuda")
        r, k, v = (torch.randn((2, 4, 128, 64), generator=g, device="cuda").bfloat16() for _ in range(3))
        w = torch.rand((2, 4, 128, 64), generator=g, device="cuda").bfloat16()
        u = torch.randn((4, 64), generator=g, device="cuda").bfloat16()
        s0 = torch.randn((2, 4, 64, 64), generator=g, device="cuda")
        on = lambda t, *pl: DTensor.from_local(t, mesh, pl, run_check=False)  # noqa: E731
        before = (rglru_scan.launches, rwkv6_scan.launches)
        lru = ops.lru_scan(on(a, Shard(0), Shard(2)), on(b, Shard(0), Shard(2)), on(h0, Shard(0), Shard(1)))
        rows = (Shard(0), Shard(1))
        wkv = ops.wkv6(on(r, *rows), on(k, *rows), on(v, *rows), on(w, *rows), on(u, Replicate(), Shard(0)),
                       on(s0, *rows))
        after = (rglru_scan.launches, rwkv6_scan.launches)
        assert [y - x for x, y in zip(before, after)] == [1, 1]
        for got, want in zip((*lru, *wkv), (*ops.lru_scan(a, b, h0), *ops.wkv6(r, k, v, w, u, s0))):
            assert torch.equal(got.to_local(), want)
    finally:
        dist.destroy_process_group()
