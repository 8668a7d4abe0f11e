"""train — the end-to-end training driver of the port.

    python -m repro_torch.launch.train --arch nbi-100m --steps 300 \
        --global-batch 16 --seq 512 --ckpt-dir ckpt/nbi100m
    python -m repro_torch.launch.train --arch nbi-100m --smoke --device cpu
    python -m repro_torch.launch.train --arch deepseek-moe-16b --smoke --device cpu

``--arch`` takes the dense family, MoE (deepseek-moe-16b, kimi-k2-1t-a32b;
the log adds the router's ``aux_loss``), RWKV-6 and Griffin. Not Whisper: the
data pipeline makes tokens and no audio frames, as the reference's, so
whisper-small trains through ``build_model(cfg).loss_fn`` and
:func:`repro_torch.training.make_train_step` with frames added to each batch.

The port of ``repro.launch.train``: config → model → optimizer (the config's,
with ``cosine_warmup``) → data pipeline → train step → checkpoint manager, on
one device (``cuda`` unless ``--device cpu``), with:

* **restart safety** — on start, the latest checkpoint (weights, optimizer
  state, step, data cursor) is restored if present; SIGTERM/SIGINT triggers a
  final synchronous save, so preemption loses at most the steps since the
  last periodic (asynchronous) save;
* **eco-preemption** — ``train(args, eco=...)`` takes a scheduler with
  ``next_peak_start(now)`` and ``begin_directive(duration_s, now)`` (the
  reference's ``EcoScheduler`` has both): the loop checkpoints and exits at
  the next peak-hours boundary and returns the ``--begin`` directive for the
  next eco window. The CLI flag ``--eco-preempt`` comes with the scheduler
  glue (ROADMAP M10); the port imports nothing of ``repro``;
* **throughput accounting** — tokens/s in the log.
"""

from __future__ import annotations

import argparse
import signal
import time
from datetime import datetime, timedelta

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import make_train_loader
from repro_torch.models.common import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.optim import cosine_warmup, make_optimizer
from repro_torch.training import init_train_state, make_train_step


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
    ap.add_argument("--now", default=None, help=argparse.SUPPRESS)  # tests
    return ap


def train(args, *, eco=None, on_metrics=None) -> dict:
    """Run ``args.steps`` steps (from the latest checkpoint, if any). Returns
    ``{"completed_steps", "stopped", "metrics", "final_loss"}`` and, after an
    eco-preemption, ``"resubmit_begin"``."""
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    optimizer = make_optimizer(cfg.optimizer, lr=cosine_warmup(args.lr, args.warmup, max(args.steps, 1)))
    step_fn = make_train_step(model, optimizer)

    # ---- state: fresh init or checkpoint restore --------------------------
    manager = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    data_cursor = 0
    state = init_train_state(model, optimizer, torch.Generator(device=device).manual_seed(args.seed), device)
    if manager and manager.latest_step() is not None:
        state, extra, start_step = manager.restore(state, device=device)
        data_cursor = int(extra.get("data_cursor", start_step))
        print(f"[train] resumed from step {start_step}")

    loader = make_train_loader(
        model.cfg.vocab_size, args.global_batch, args.seq, seed=args.seed,
        host_index=args.host_index, host_count=args.host_count, start=data_cursor,
    )

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
            batch = {k: torch.from_numpy(v).to(device) for k, v in next(loader).items()}
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
            if manager and (step + 1) % args.ckpt_every == 0:
                manager.save(
                    step + 1, state,
                    extra={"data_cursor": loader.state_dict()["cursor"], "arch": args.arch},
                    blocking=False,
                )
            if stop["reason"]:
                break
            if eco_deadline and clock() >= eco_deadline:
                stop["reason"] = "eco-preempt"
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
    }
    if manager and (stop["reason"] or args.steps > start_step):
        manager.save(
            steps_done, state,
            extra={"data_cursor": loader.state_dict()["cursor"], "arch": args.arch,
                   "stopped": stop["reason"]},
            blocking=True,
        )
    if stop["reason"] == "eco-preempt":
        remaining_s = 3600  # conservative: at least an hour of work left
        result["resubmit_begin"] = eco.begin_directive(remaining_s, clock())
        print(f"[eco] resubmit with --begin={result['resubmit_begin']}")
    return result


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    result = train(args)
    if result["final_loss"] is not None:
        print(f"[train] done: steps={result['completed_steps']} final_loss={result['final_loss']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
