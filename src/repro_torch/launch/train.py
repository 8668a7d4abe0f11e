"""train — the end-to-end training driver of the port.

    python -m repro_torch.launch.train --arch nbi-100m --steps 300 \
        --global-batch 16 --seq 512 --ckpt-dir ckpt/nbi100m
    python -m repro_torch.launch.train --arch nbi-100m --smoke --device cpu
    python -m repro_torch.launch.train --arch deepseek-moe-16b --smoke --device cpu
    srun python -m repro_torch.launch.train --arch nbi-100m ...   # one task a GPU
    srun python -m repro_torch.launch.train --arch mistral-large-123b --mesh data=8,model=8 ...
    python launchers/torch_h100.py train --arch nbi-100m ... --eco-preempt

``--arch`` takes the dense family, MoE (deepseek-moe-16b, kimi-k2-1t-a32b;
the log adds the router's ``aux_loss``), RWKV-6 and Griffin. Not Whisper: the
data pipeline makes tokens and no audio frames, as the reference's, so
whisper-small trains through ``build_model(cfg).loss_fn`` and
:func:`repro_torch.training.make_train_step` with frames added to each batch.

The port of ``repro.launch.train``: config → model → optimizer (the config's,
with ``cosine_warmup``) → data pipeline → train step → checkpoint manager, on
one device (``cuda`` unless ``--device cpu``) or, as a multi-task SLURM job,
on one GPU a task, with:

* **data parallelism** — under ``srun`` with more than one task, ``train``
  joins the process group first (:func:`repro_torch.launch.distributed.
  maybe_initialize`), each rank reads its shard of every global batch, and
  the step averages the gradients over the ranks exactly
  (:func:`repro_torch.training.make_dp_train_step` with ``compress=False``,
  the average the reference's GSPMD step computes); rank 0 writes the
  checkpoints and every rank restores them;
* **a device mesh** — ``--mesh data=D,model=M`` (optionally ``pod=P,``)
  over the job's D·M tasks (:func:`repro_torch.launch.mesh.make_job_mesh`,
  ``model`` within a node), for the dense GQA and MoE families: the rules
  come from ``rules_for(cfg, mesh, param_defs=..., batch_size=global batch,
  extra_dims={"heads": n_heads})`` as in the reference's launcher, the state
  is drawn straight into its placements (``init_sharded_train_state``) and
  :func:`repro_torch.training.make_train_step` runs with them: data
  parallelism over the batch, tensor and expert parallelism over ``model``,
  ZeRO-3 over the data axes with ``cfg.fsdp``. Each rank reads the rows of
  its data coordinate (ranks that differ only in ``model`` read the same
  rows). Every rank takes part in each (unsharded, synchronous) checkpoint
  and restores onto whatever mesh it runs on. A mesh with model 1 and no
  FSDP runs the data-parallel step above;

* **restart safety** — on start, the latest checkpoint (weights, optimizer
  state, step, data cursor) is restored if present; SIGTERM/SIGINT triggers a
  final synchronous save, so preemption loses at most the steps since the
  last periodic (asynchronous) save;
* **eco-preemption** — with ``--eco-preempt`` the loop checkpoints and exits
  at the next peak-hours boundary and prints the ``--begin`` directive for
  the next eco window. The scheduler is an object with
  ``next_peak_start(now)`` and ``begin_directive(duration_s, now)``, handed
  in as ``main(argv, eco=...)`` or ``train(args, eco=...)``: the port imports
  nothing of ``repro``, so the launcher plugin ``launchers/torch_h100.py``
  builds the reference's ``EcoScheduler`` and passes it. The flag without a
  scheduler is an error, never ignored;
* **throughput accounting** — tokens/s in the log.

On one device (no mesh, one task) the step is a :class:`repro_torch.training.
TrainGraph`, the counterpart of the reference's ``jax.jit`` over its train
step with the state donated: built after any restore, it adopts the state as
static buffers, each batch is copied into its static batch, and on the card
every step after the first (an eager warm-up, then the capture) replays a
CUDA graph; on the CPU the same buffers are stepped eagerly. The
data-parallel and mesh steps stay eager (ROADMAP Queue 1, item 3d).
"""

from __future__ import annotations

import argparse
import signal
import time
from datetime import datetime, timedelta

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import make_train_loader
from repro_torch.models.common import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.optim import cosine_warmup, make_optimizer
from repro_torch.training import (
    TrainGraph,
    abstract_train_state,
    init_sharded_train_state,
    init_train_state,
    make_dp_train_step,
    make_train_step,
    train_state_logical,
)

from .distributed import dp_groups, maybe_initialize
from .mesh import data_coordinate, make_job_mesh, parse_mesh

NO_SCHEDULER = ("--eco-preempt needs the eco scheduler, which the port does not import: run through the "
                "launcher plugin (python launchers/torch_h100.py train ... --eco-preempt, or nbilaunch "
                "--launcher-dir launchers torch-train ... eco_preempt=1)")


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--host-index", type=int, default=0)
    ap.add_argument("--host-count", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--mesh", default="", help="data=D,model=M[,pod=P]: train on a device mesh of the job's tasks")
    ap.add_argument("--eco-preempt", action="store_true",
                    help="checkpoint + exit at the next peak-hours boundary (needs the launcher plugin)")
    ap.add_argument("--now", default=None, help=argparse.SUPPRESS)  # tests
    return ap


def train(args, *, eco=None, on_metrics=None) -> dict:
    """Run ``args.steps`` steps (from the latest checkpoint, if any). Returns
    ``{"completed_steps", "stopped", "metrics", "final_loss", "replays",
    "graph_seconds"}`` (the graph's replays, and its warm-up's and
    capture's wall seconds on the card) and, after an eco-preemption,
    ``"resubmit_begin"``."""
    if args.eco_preempt and eco is None:
        raise ValueError(NO_SCHEDULER)
    device = resolve_device(args.device)
    # under a multi-task SLURM job, join the process group and take this
    # rank's data shard; a no-op in single-process runs
    rank, world = maybe_initialize(device)
    if world > 1 and args.host_count == 1:
        args.host_index, args.host_count = rank, world
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    optimizer = make_optimizer(cfg.optimizer, lr=cosine_warmup(args.lr, args.warmup, max(args.steps, 1)))
    mesh = None
    if args.mesh:
        shape = parse_mesh(args.mesh, world)
        if shape.shape[-1] > 1 or cfg.fsdp:
            mesh = make_job_mesh(args.mesh, device)
    manager = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    data_cursor = 0
    if mesh is not None:
        rules, placements, step_fn = _mesh_step(model, optimizer, mesh, args.global_batch)
        args.host_index, args.host_count = data_coordinate(mesh) if rules["batch"] else (0, 1)
        state = init_sharded_train_state(model, optimizer, args.seed, mesh, placements, device)
        if manager and manager.latest_step() is not None:
            state, extra, start_step = manager.restore_sharded(abstract_train_state(model, optimizer), placements,
                                                               mesh, device=device)
            data_cursor = int(extra.get("data_cursor", start_step))
            print(f"[train] resumed from step {start_step}")
    else:
        if world > 1:
            step_fn = make_dp_train_step(model, optimizer, dp_groups(), compress=False)
        else:
            step_fn = make_train_step(model, optimizer)
        state = init_train_state(model, optimizer, torch.Generator(device=device).manual_seed(args.seed), device)
        if manager and manager.latest_step() is not None:
            state, extra, start_step = manager.restore(state, device=device)
            data_cursor = int(extra.get("data_cursor", start_step))
            print(f"[train] resumed from step {start_step}")
    # one device: the step over static buffers, replayed as a CUDA graph on the
    # card, captured over the (restored) state it adopts here
    graph = TrainGraph(step_fn, state) if mesh is None and world == 1 else None

    loader = make_train_loader(
        model.cfg.vocab_size, args.global_batch, args.seq, seed=args.seed,
        host_index=args.host_index, host_count=args.host_count, start=data_cursor,
    )

    def save(step, extra, blocking):
        if mesh is not None:  # every rank gathers; rank 0 writes
            manager.save_sharded(step, state, extra=extra)
        elif rank == 0:
            manager.save(step, state, extra=extra, blocking=blocking)

    # ---- eco-preemption & signal handling ----------------------------------
    # ``--now`` (tests/examples) sets a *virtual clock start*: simulated time
    # advances with real elapsed time from that instant.
    wall_t0 = time.monotonic()
    virtual_start = datetime.fromisoformat(args.now) if args.now else None

    def clock() -> datetime:
        if virtual_start is None:
            return datetime.now()
        return virtual_start + timedelta(seconds=time.monotonic() - wall_t0)

    eco_deadline = eco.next_peak_start(clock()) if eco is not None else None
    if eco_deadline:
        print(f"[eco] will checkpoint+exit at peak boundary {eco_deadline}")

    stop = {"reason": None}

    def _sig(signum, _frame):
        stop["reason"] = f"signal {signum}"

    old_handlers = {}
    for s in (signal.SIGINT, signal.SIGTERM):
        try:
            old_handlers[s] = signal.signal(s, _sig)
        except ValueError:
            pass  # not the main thread (tests)

    # ---- loop ---------------------------------------------------------------
    metrics_hist = []
    t_start = time.perf_counter()
    tokens_per_step = args.global_batch * args.seq
    steps_done = start_step  # steps whose update actually applied
    try:
        for step in range(start_step, args.steps):
            if graph is not None:
                state, metrics = graph(graph.state, graph.feed({k: torch.from_numpy(v) for k, v in
                                                                 next(loader).items()}))
            else:
                batch = {k: torch.from_numpy(v).to(device) for k, v in next(loader).items()}
                if mesh is not None:
                    batch = _global_batch(batch, mesh, rules, args.global_batch)
                state, metrics = step_fn(state, batch)
            steps_done = step + 1
            if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
                m = {k: float(v) for k, v in metrics.items()}  # waits for the step
                dt = time.perf_counter() - t_start
                m.update(step=step + 1, tokens_per_s=tokens_per_step * (step + 1 - start_step) / dt)
                metrics_hist.append(m)
                if on_metrics:
                    on_metrics(m)
                aux = f" aux_loss={m['aux_loss']:.4f}" if "aux_loss" in m else ""  # MoE's load balance
                print(
                    f"[train] step {step + 1}/{args.steps} loss={m['loss']:.4f} "
                    f"acc={m.get('accuracy', 0):.3f}{aux} tok/s={m['tokens_per_s']:.0f}",
                    flush=True,
                )
            # a save copies the state to the host before it returns (also when
            # the write is not blocking): the next replay overwrites the
            # static state in place
            if manager and (step + 1) % args.ckpt_every == 0:
                save(step + 1, {"data_cursor": loader.state_dict()["cursor"], "arch": args.arch}, False)
            if not stop["reason"] and eco_deadline and clock() >= eco_deadline:
                stop["reason"] = "eco-preempt"
            if world > 1:  # every rank stops after the same step
                stop["reason"] = _agree_stop(stop["reason"], device)
            if stop["reason"]:
                break
    finally:
        for s, h in old_handlers.items():
            signal.signal(s, h)
        loader.close()

    result = {
        "completed_steps": steps_done,
        "stopped": stop["reason"],
        "metrics": metrics_hist,
        "final_loss": metrics_hist[-1]["loss"] if metrics_hist else None,
        "replays": graph.replays if graph is not None else 0,
        "graph_seconds": dict(graph.seconds) if graph is not None else {},
    }
    if manager and (stop["reason"] or args.steps > start_step):
        save(steps_done, {"data_cursor": loader.state_dict()["cursor"], "arch": args.arch,
                          "stopped": stop["reason"]}, True)
    if stop["reason"] == "eco-preempt":
        remaining_s = 3600  # conservative: at least an hour of work left
        result["resubmit_begin"] = eco.begin_directive(remaining_s, clock())
        print(f"[eco] resubmit with --begin={result['resubmit_begin']}")
    return result


def _mesh_step(model, optimizer, mesh, global_batch: int):
    """(rules, the train state's placements, the step) on ``mesh``, the
    rules derived as the reference's launcher derives them."""
    from repro_torch.parallel.sharding import resolve_tree, rules_for

    cfg = model.cfg
    rules = rules_for(cfg, mesh, param_defs=model.param_defs, batch_size=global_batch,
                      extra_dims={"heads": cfg.n_heads})
    placements = resolve_tree(mesh, train_state_logical(model, optimizer), rules)
    return rules, placements, make_train_step(model, optimizer, rules, mesh)


def _global_batch(local: dict, mesh, rules: dict, global_batch: int) -> dict:
    """This rank's rows as the DTensors of the global batch."""
    from repro_torch.parallel.sharding import from_local, placements_for

    placements = placements_for(("batch", None), rules, mesh)
    return {k: from_local(v, mesh, placements, (global_batch, *v.shape[1:])) for k, v in local.items()}


def _agree_stop(reason, device):
    """The stop decision of every rank: any rank's reason stops them all."""
    flag = torch.tensor([0 if reason is None else 1 if reason == "eco-preempt" else 2], device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    code = int(flag)
    if code == 0:
        return None
    return reason or ("eco-preempt" if code == 1 else "signal on another rank")


def main(argv=None, *, eco=None) -> int:
    """The CLI. ``eco`` is the scheduler ``--eco-preempt`` uses (the launcher
    plugin passes the reference's ``EcoScheduler``)."""
    ap = build_argparser()
    args = ap.parse_args(argv)
    if args.eco_preempt and eco is None:
        ap.error(NO_SCHEDULER)
    result = train(args, eco=eco if args.eco_preempt else None)
    if result["final_loss"] is not None:
        print(f"[train] done: steps={result['completed_steps']} final_loss={result['final_loss']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
