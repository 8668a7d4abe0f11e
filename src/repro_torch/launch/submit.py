"""GPU sizing and job commands for the port (the port of
``repro.launch.submit``'s ``TrainLauncher`` / ``ServeLauncher`` arithmetic).

The paper's Kraken2 wrapper measures its database at submission time and
inflates the memory request. The same is done here from the model config and
the port's own numerics on an NVIDIA H100 80GB HBM3: bytes a GPU (weights,
gradients, the optimizer's state and its update's transients, activations
and logits), the GPUs and hosts of the job, host memory and a wall time, and
the command each task runs. Without a mesh the data-parallel step replicates
the model, so one GPU must hold it. With a mesh (``data=D,model=M``) each GPU
holds its own shard of every leaf, as ``resolve_tree`` lays the state out,
and its share of the activations. A job that does not fit is refused with the
smallest GPU count (and mesh) that fits, never submitted to run out of
memory. A serve job is sized the same way: on one GPU its weights, cache and
working set, on a mesh each GPU's shards of them (the cache's ``kv_seq`` dim
over ``model``).

Plain functions of the config, importing nothing of ``repro``: the launcher
plugin ``launchers/torch_h100.py`` wraps them for ``nbilaunch``.
"""

from __future__ import annotations

import math
import shlex

from repro_torch.analysis.roofline import H100
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.common import tree_leaves, torch_dtype
from repro_torch.models.registry import build_model

from .distributed import multinode_sbatch
from .mesh import MeshShape, parse_mesh

# Bytes a job's peak may reach on one GPU: the NVIDIA H100 80GB HBM3's
# nominal 80 GB (``H100.hbm_bytes``). recurrentgemma-2b's 26-layer train step
# ran out of memory there with 74.2 GiB (79.7e9 bytes) allocated
# (chip_smoke.py phase 5, PERF.md).
GPU_MEMORY_BYTES = H100.hbm_bytes
GPUS_PER_HOST = H100.node_gpus
# host memory: the reference's rule (48 GB an accelerator plus the paper's
# fixed 100 GB overhead)
HOST_RAM_PER_GPU_GB = 48
FIXED_OVERHEAD_GB = 100
# Train throughput measured by chip_smoke.py phase 5 on an NVIDIA H100 80GB
# HBM3 at 700.00 W (the lowest tok/s of each path's runs in PERF.md
# section 5): arch, layers (None: all), tok/s (llava-next-mistral-7b's
# positions, 1152 patches and 896 text tokens a row: its step's FLOPs
# follow the positions). MFU = 6 * active parameters * tok/s / the config
# dtype's peak: nbi-100m 30.0%, deepseek-moe-16b 9.1%, recurrentgemma-2b
# 8.8%, rwkv6-7b 4.2%, minicpm3-4b 5.5%, llava-next-mistral-7b 13.6%,
# starcoder2-7b 16.4%, codeqwen1.5-7b 16.4%, mistral-large-123b 24.9% (its 8
# microbatches under remat "selective"). deepseek-moe-16b with MLA attention
# (its leading dense layer and 3 MoE layers, 20035.7 tok/s, 9.3%) has no
# row: no arch names it (the reference has no such config), and a row is
# keyed by an arch's published config.
MEASURED_TRAIN = [("nbi-100m", None, 30401.0), ("deepseek-moe-16b", 4, 19633.8),
                  ("rwkv6-7b", 8, 2989.1), ("recurrentgemma-2b", 14, 8337.9),
                  ("minicpm3-4b", 28, 4232.3), ("llava-next-mistral-7b", 8, 11191.1),
                  ("starcoder2-7b", 5, 13755.8), ("codeqwen1.5-7b", 6, 12554.8),
                  ("mistral-large-123b", 1, 18714.2)]

# AdamW's peak, per parameter: old and new weights, two f32 gradient trees
# (the cast and the clipped one) and old and new moments (PERF.md section 6:
# about 28 bytes in bf16); the 8-bit moments are 1 byte each, Lion has
# one f32 moment
_STATE_BYTES = {"adamw": 8, "adamw8bit": 2, "lion": 4}
# Calibrated on chip_smoke.py phase 5's peaks (NVIDIA H100 80GB HBM3, 700.00 W,
# PERF.md section 5: nbi-100m 8 x 512 7242.3 MiB, deepseek-moe-16b 4 layers
# 4 x 2048 68238.4, rwkv6-7b 8 layers 65978.2, recurrentgemma-2b 14 layers
# 2 x 2048 53743.5, minicpm3-4b 28 layers 4 x 2048 62538.6,
# llava-next-mistral-7b 8 layers 4 x 2048 positions 60006.4; the model
# gives 0.98 to 1.01 of each; not refitted to later peaks, which it gives
# 0.983 to 0.996 of: deepseek-moe-16b with MLA attention 4 layers 4 x 2048
# 66662.3, starcoder2-7b 5 layers 4 x 2048 57512.0, codeqwen1.5-7b 6 layers
# 4 x 2048 62842.1, mistral-large-123b 1 layer 8 x 2048 in 8 microbatches
# under remat "selective" 64130.4, which it counts as "full"): the update's f32
# temporaries of the largest leaf, f32 logits copies a token (logits, their
# softmax terms and gradient), and the f32 activations a layer keeps a token
# in units of (D, d_ff) under remat "none", or that one layer's recompute
# holds under remat "full" (which keeps each layer's input besides)
_UPDATE_TEMPS = 3
_LOGIT_COPIES = 5
_LAYER_ACTS = (10, 4)


# the largest job the refusal's search for a GPU count that fits considers
MAX_GPUS = 8192


class DoesNotFit(ValueError):
    """The job's peak does not fit one GPU."""


def _act_bytes(cfg) -> int:
    return torch_dtype(cfg.dtype).itemsize


def train_memory_model(cfg, batch: int, seq: int, mesh: "MeshShape | None" = None) -> int:
    """Peak bytes on one GPU of a train step of ``batch`` x ``seq`` tokens:
    the largest of the optimizer update's peak, the backward's (weights,
    moments, gradients, activations and logits) and, on a mesh, the sharded
    init's. Without ``mesh`` the step runs on one GPU; with it ``batch`` is
    the global batch, laid out with the state by the rules (each sum counts
    every leaf's local shard, the activations and logits this GPU's rows and
    its share of the ``ff`` and ``vocab`` dims). A 1 x 1 mesh gives the
    one-GPU numbers."""
    from repro_torch.parallel.sharding import dp_axes, local_shape, mesh_axis_sizes, resolve_tree, rules_for

    model = build_model(cfg)
    mesh = mesh or MeshShape(("data", "model"), (1, 1))
    sizes = mesh_axis_sizes(mesh)
    rules = rules_for(cfg, mesh, param_defs=model.param_defs, batch_size=batch, extra_dims={"heads": cfg.n_heads})
    defs = [d for _, d in tree_leaves(model.param_defs)]
    placements = [p for _, p in tree_leaves(resolve_tree(mesh, model.param_logical(), rules))]
    local = [math.prod(local_shape(d.shape, p, mesh)) for d, p in zip(defs, placements)]
    params, largest = sum(local), max(local)
    weights = sum(n * d.dtype.itemsize for n, d in zip(local, defs))
    state = _STATE_BYTES.get(cfg.optimizer, 8)
    update = 2 * weights + 8 * params + 2 * state * params + 4 * _UPDATE_TEMPS * largest
    dp = math.prod(sizes[a] for a in dp_axes(mesh)) if rules["batch"] else 1
    shards = {name: sizes["model"] if rules.get(name) else 1 for name in ("ff", "vocab")}
    tokens = batch // dp * seq // max(1, cfg.microbatch)
    layer = tokens * (_LAYER_ACTS[0] * cfg.d_model + _LAYER_ACTS[1] * cfg.d_ff // shards["ff"]) * 4
    if cfg.remat == "none":
        acts = cfg.n_layers * layer
    else:
        acts = cfg.n_layers * tokens * cfg.d_model * _act_bytes(cfg) + layer
    logits = tokens * model.cfg.vocab_size // shards["vocab"] * 4 * _LOGIT_COPIES
    backward = 2 * weights + state * params + acts + logits
    if mesh.size() == 1:
        return int(max(update, backward))
    # ZeRO-3 gathers a layer's weights over the data axes at use: under remat
    # "none" autograd keeps every layer's gathered weights, else one layer's
    # (and its recompute's)
    stacked = [(n, d) for n, d in zip(local, defs) if d.logical and d.logical[0] == "layers"]
    gathered = 0
    if rules["embed"]:
        layer_bytes = sum(n * d.dtype.itemsize for n, d in stacked) // cfg.n_layers * dp
        gathered = layer_bytes * (cfg.n_layers if cfg.remat == "none" else 2)
    # the sharded init draws one layer of a stacked leaf, or an unstacked
    # leaf whole, in f32 (and its cast) beside the shards drawn so far
    slice_f32 = max(math.prod(d.shape[1:] if d.logical[:1] == ("layers",) else d.shape) for d in defs) * 8
    init = weights + slice_f32
    return int(max(update, backward + gathered, init))


def default_mesh(gpus: int) -> MeshShape:
    """The mesh the sizing assumes for ``gpus`` GPUs: ``model`` over the GPUs
    of one host (at most 8, the NVLink domain), ``data`` over the hosts."""
    model = math.gcd(gpus, GPUS_PER_HOST)
    return MeshShape(("data", "model"), (gpus // model, model))


def serve_memory_model(cfg, batch: int, max_seq: int, mesh: "MeshShape | None" = None) -> int:
    """Peak bytes on one GPU of serving ``batch`` requests of up to
    ``max_seq`` tokens: the weights, the cache (its exact layout) and a
    prefill's working set and last logits. Against kimi-k2-1t-a32b's measured
    serving peak (2 of 61 layers, 8 x 1056 tokens, 42852.0 MiB on an NVIDIA
    H100 80GB HBM3 at 700.00 W, PERF.md section 5) it gives 40499 MiB. With
    ``mesh`` each sum is this GPU's part, laid out by the serving rules
    (``sharding.serve_rules``): every weight's and cache leaf's local shard,
    the working set of its rows with its share of the ``ff`` (or experts')
    dim, its share of the logits. Not counted, as on one GPU: the
    prompt-sized cache the prefill returns beside the padded one (on a mesh
    gathered over ``model`` one leaf at a time). A 1 x 1 mesh gives the
    one-GPU number."""
    from repro_torch.parallel.sharding import dp_axes, local_shape, mesh_axis_sizes, resolve_tree, serve_rules

    model = build_model(cfg)
    mesh = mesh or MeshShape(("data", "model"), (1, 1))
    sizes = mesh_axis_sizes(mesh)
    rules = serve_rules(model, mesh, batch, max_seq)

    def local_bytes(shapes, logical):
        placements = [p for _, p in tree_leaves(resolve_tree(mesh, logical, rules))]
        return sum(math.prod(local_shape(t.shape, p, mesh)) * t.dtype.itemsize
                   for (_, t), p in zip(tree_leaves(shapes), placements))

    weights = local_bytes(model.param_defs, model.param_logical())
    cache = local_bytes(model.cache_defs_fn(batch, max_seq), model.cache_logical_fn())
    rows = batch // (math.prod(sizes[a] for a in dp_axes(mesh)) if rules["batch"] else 1)
    shards = {name: sizes["model"] if rules.get(name) else 1 for name in ("ff", "experts", "vocab")}
    ff = max(cfg.d_ff // shards["ff"], cfg.moe_d_ff * (cfg.top_k + cfg.n_shared_experts) // shards["experts"])
    work = rows * max_seq * (_LAYER_ACTS[0] * cfg.d_model + _LAYER_ACTS[1] * ff) * _act_bytes(cfg)
    return int(weights + cache + work + rows * model.cfg.vocab_size // shards["vocab"] * 4)


def train_mfu_floor() -> float:
    """The lowest model-FLOP utilisation of :data:`MEASURED_TRAIN`."""
    def mfu(arch, layers, tok_s):
        cfg = get_config(arch)
        cfg = cfg.replace(n_layers=layers) if layers else cfg
        return 6 * cfg.active_param_count() * tok_s / H100.peak_flops[cfg.dtype]

    return min(mfu(*run) for run in MEASURED_TRAIN)


def _config(arch: str, smoke: bool):
    return get_smoke_config(arch) if smoke else get_config(arch)


def _fits(what: str, need: int, device: str, remedy) -> None:
    """Raise :class:`DoesNotFit` when ``need`` bytes exceed a GPU's, saying
    ``remedy()``."""
    if device == "cuda" and need > GPU_MEMORY_BYTES:
        raise DoesNotFit(
            f"{what} needs {need / 1e9:.1f} GB on one GPU, more than an H100's {GPU_MEMORY_BYTES / 1e9:.0f} GB: "
            + remedy())


def smallest_fit(cfg, global_batch: int, seq: int, memory=train_memory_model) -> "tuple[int, MeshShape, int] | None":
    """(GPUs, mesh, bytes a GPU) of the smallest power-of-two GPU count up to
    :data:`MAX_GPUS` whose :func:`default_mesh` fits the job, or None:
    ``memory(cfg, batch, seq, mesh)`` is the train step's
    (:func:`train_memory_model`) or serving's (:func:`serve_memory_model`)."""
    gpus = 1
    while gpus <= MAX_GPUS:
        mesh = default_mesh(gpus)
        need = memory(cfg, global_batch, seq, mesh)
        if need <= GPU_MEMORY_BYTES:
            return gpus, mesh, need
        gpus *= 2
    return None


def _remedy(cfg, global_batch: int, seq: int, memory=train_memory_model) -> str:
    found = smallest_fit(cfg, global_batch, seq, memory)
    if found is None:
        return f"no mesh of up to {MAX_GPUS} GPUs fits it"
    gpus, mesh, need = found
    return (f"the smallest GPU count that fits is gpus={gpus} with mesh={mesh.spec()} "
            f"({need / 1e9:.1f} GB a GPU)")


def _placement(gpus: int, device: str) -> dict:
    if gpus < 1:
        raise ValueError(f"gpus must be at least 1, got {gpus}")
    if device != "cuda":  # processes on the CPU of one host (gloo ranks), one a "gpu"
        return {"gpus": 0, "hosts": 1, "gpus_per_host": gpus, "tasks": gpus, "gres": "",
                "host_mem_gb": FIXED_OVERHEAD_GB}
    hosts = math.ceil(gpus / GPUS_PER_HOST)
    if gpus % hosts:
        raise ValueError(f"{gpus} GPUs do not spread evenly over {hosts} hosts of {GPUS_PER_HOST}")
    per_host = gpus // hosts
    return {"gpus": gpus, "hosts": hosts, "gpus_per_host": per_host, "tasks": gpus, "gres": f"gpu:h100:{per_host}",
            "host_mem_gb": HOST_RAM_PER_GPU_GB * per_host + FIXED_OVERHEAD_GB}


def size_train(arch: str, *, global_batch: int, seq: int, steps: int, gpus: int = 1, smoke: bool = False,
               device: str = "cuda", mesh: str = "") -> dict:
    """GPUs, hosts, gres, host memory, bytes a GPU and wall time of a train
    job: one task a GPU, each on ``global_batch / gpus`` rows, or with
    ``mesh`` (``data=D,model=M``, D·M = gpus) the state sharded over the
    mesh. Raises :class:`DoesNotFit`, naming the smallest GPU count and mesh
    that fit, when a GPU cannot hold its part of the step."""
    cfg = _config(arch, smoke)
    if cfg.family == "encdec":
        raise ValueError(f"{arch}: the train launcher's data pipeline makes no audio frames (as the reference's)")
    sizing = _placement(gpus, device)
    if mesh:
        shape = parse_mesh(mesh, sizing["tasks"])
        need = train_memory_model(cfg, global_batch, seq, shape)
        what = f"training {arch} on {global_batch} x {seq} tokens over mesh {shape.spec()}"
    else:
        if global_batch % sizing["tasks"]:
            raise ValueError(f"global batch {global_batch} does not split over {sizing['tasks']} tasks")
        need = train_memory_model(cfg, global_batch // sizing["tasks"], seq)
        what = f"training {arch} on {global_batch // sizing['tasks']} x {seq} tokens a GPU (data parallel)"
    _fits(what, need, device, lambda: _remedy(cfg, global_batch, seq))
    # wall time: 6 N D at the lowest MFU the card has shown, twice, plus ten minutes
    flops = 6 * cfg.active_param_count() * steps * global_batch * seq
    secs = flops / (max(1, sizing["gpus"]) * H100.peak_flops[cfg.dtype] * train_mfu_floor())
    return {**sizing, "bytes_per_gpu": need, "time_s": int(secs * 2) + 600}


def size_serve(arch: str, *, batch: int, max_seq: int, smoke: bool = False, device: str = "cuda", gpus: int = 1,
               mesh: str = "") -> dict:
    """GPUs, hosts, gres, host memory, bytes a GPU and mesh of a serve job:
    one GPU (one task), or with ``mesh`` (``data=D,model=M``, D·M = gpus; on
    more than one GPU :func:`default_mesh`'s when not given) the model and
    cache sharded over the mesh, one task a GPU. Raises
    :class:`DoesNotFit`, naming the smallest GPU count and mesh that fit,
    when a GPU cannot hold its part."""
    cfg = _config(arch, smoke)
    sizing = _placement(gpus, device)
    if not mesh and sizing["tasks"] > 1:
        mesh = default_mesh(sizing["tasks"]).spec()
    shape = parse_mesh(mesh, sizing["tasks"]) if mesh else None
    need = serve_memory_model(cfg, batch, max_seq, shape)
    where = f" over mesh {shape.spec()}" if shape else ""
    _fits(f"serving {arch} at batch {batch} x {max_seq} tokens{where}", need, device,
          lambda: _remedy(cfg, batch, max_seq, serve_memory_model))
    return {**sizing, "bytes_per_gpu": need, "mesh": mesh}


def _python(*words) -> str:
    return shlex.join(["python", *map(str, words)])


def train_command(arch: str, *, steps: int, global_batch: int, seq: int, ckpt_dir: str, smoke: bool = False,
                  device: str = "cuda", tasks: int = 1, eco_preempt: bool = False, plugin: str = "",
                  mesh: str = "") -> str:
    """The job's command: ``python -m repro_torch.launch.train ...``, or the
    plugin's ``python <plugin> train ... --eco-preempt`` (the port does not
    import the eco scheduler); under ``srun`` with more than one task."""
    args = ["--arch", arch, "--steps", steps, "--global-batch", global_batch, "--seq", seq, "--ckpt-dir", ckpt_dir]
    if smoke:
        args.append("--smoke")
    if device != "cuda":
        args += ["--device", device]
    if mesh:
        args += ["--mesh", mesh]
    if eco_preempt:
        if not plugin:
            raise ValueError("--eco-preempt runs through the launcher plugin: name its file")
        cmd = _python(plugin, "train", *args, "--eco-preempt")
    else:
        cmd = _python("-m", "repro_torch.launch.train", *args)
    return f"srun --kill-on-bad-exit=1 {cmd}" if tasks > 1 else cmd


def serve_command(arch: str, *, batch: int, prompt_len: int, gen_len: int, smoke: bool = False,
                  device: str = "cuda", tasks: int = 1, mesh: str = "") -> str:
    """The job's command: ``python -m repro_torch.launch.serve ...``, under
    ``srun`` with ``--mesh`` over more than one task."""
    args = ["--arch", arch, "--batch", batch, "--prompt-len", prompt_len, "--gen-len", gen_len]
    if smoke:
        args.append("--smoke")
    if device != "cuda":
        args += ["--device", device]
    if mesh:
        args += ["--mesh", mesh]
    cmd = _python("-m", "repro_torch.launch.serve", *args)
    return f"srun --kill-on-bad-exit=1 {cmd}" if tasks > 1 else cmd


def train_sbatch(arch: str, sizing: dict, command: str, *, time: str, mem_mb: int, partition: str = "") -> str:
    """Standalone sbatch script of a train job (the deploy artifact for big
    runs): one srun task a GPU on every host."""
    return multinode_sbatch(
        job_name=f"train-{arch}", hosts=sizing["hosts"], tasks_per_host=max(1, sizing["gpus_per_host"]),
        command=command.removeprefix("srun --kill-on-bad-exit=1 "), time=time, partition=partition,
        gres=sizing["gres"], mem_mb=mem_mb,
    )
