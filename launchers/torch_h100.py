"""NBI-Slurm launchers for the PyTorch port on NVIDIA H100 nodes:
``torch-train`` and ``torch-serve``.

    nbilaunch --launcher-dir launchers torch-train arch=nbi-100m steps=300 gpus=8
    nbilaunch --launcher-dir launchers torch-train arch=mistral-large-123b gpus=64 mesh=data=8,model=8
    nbilaunch --launcher-dir launchers torch-serve arch=codeqwen1.5-7b batch=8
    nbilaunch --launcher-dir launchers torch-serve arch=mistral-large-123b gpus=4 mesh=data=1,model=4
    cp launchers/torch_h100.py ~/.nbi/launchers/   # then: nbilaunch torch-train ...
    python launchers/torch_h100.py train --arch nbi-100m ... --eco-preempt

The paper's wrapper pattern: each launcher sizes its job from the model
config at submission time (:mod:`repro_torch.launch.submit`: bytes a GPU,
``gres gpu:h100:N``, hosts of 8 GPUs, one task a GPU under ``srun``, host
memory, wall time) and refuses a job whose step does not fit its GPUs,
naming the smallest GPU count and mesh that fit. Without ``mesh`` the job is
data parallel (every GPU holds the model); with ``mesh=data=D,model=M``
(D·M = gpus) it trains on that device mesh (``--mesh``: ZeRO-3 over
``data`` with the config's ``fsdp``, tensor and expert parallelism over
``model`` within a host). ``torch-serve`` serves on one GPU, or with ``gpus``
over a mesh (``mesh``, or the default ``model`` over a host's GPUs and
``data`` over the hosts): the weights and the KV cache split over the GPUs
(the cache's sequence over ``model``), one task a GPU under ``srun``. On the
CPU (``device=cpu``) ``gpus`` counts processes (gloo ranks) of one host.
Their names differ from the JAX package's ``train`` and ``serve``, which stay
as they are.

This file is the one place where the port meets ``repro``: the port imports
nothing of it, so eco-preemption runs through this file's ``__main__``, which
builds the scheduler (``repro.core.eco.EcoScheduler``, from the NBI-Slurm
config) and hands it to ``repro_torch.launch.train.main``. A ``torch-train``
job with ``eco_preempt=1`` runs this file; it checkpoints and exits at the
next peak-hours boundary and prints the ``--begin`` of the next eco window.
It imports nothing that imports JAX.
"""

from __future__ import annotations

import sys
from pathlib import Path

PLUGIN = str(Path(__file__).resolve())
if __name__ == "__main__":  # run from a checkout: its packages sit in src/
    _src = Path(PLUGIN).parent.parent / "src"
    if (_src / "repro_torch").is_dir():
        sys.path.insert(0, str(_src))

from repro.core.launcher import InputSpec, Launcher, LauncherError  # noqa: E402
from repro.core.resources import Opts  # noqa: E402


class TorchTrainLauncher(Launcher):
    """Train a model of the PyTorch port on H100 GPUs (repro_torch.launch.train)."""

    tool_name = "torch-train"
    tool_version = "0.1.0"
    activation = ("none", "")
    inputs_spec = [
        InputSpec("arch", required=True, kind="str", help="architecture id"),
    ]
    params_spec = [
        InputSpec("steps", required=False, kind="int", default=100),
        InputSpec("global_batch", required=False, kind="int", default=32),
        InputSpec("seq", required=False, kind="int", default=1024),
        InputSpec("ckpt_dir", required=False, kind="str", default="ckpt"),
        InputSpec("smoke", required=False, kind="int", default=0, help="1 = reduced smoke config"),
        InputSpec("gpus", required=False, kind="int", default=1, help="one task a GPU, 8 a host"),
        InputSpec("mesh", required=False, kind="str", default="",
                  help="data=D,model=M over the gpus (empty: data parallel)"),
        InputSpec("device", required=False, kind="str", default="cuda", help="cuda or cpu"),
        InputSpec("eco_preempt", required=False, kind="int", default=0,
                  help="1 = checkpoint + exit at the next peak-hours boundary"),
    ]

    def default_opts(self) -> Opts:
        return Opts.new(threads=8, memory="32GB", time="12h", gres="")

    def build(self) -> None:
        from repro_torch.launch import submit

        p = self.params
        try:
            self.sizing = submit.size_train(
                self.inputs["arch"], global_batch=int(p["global_batch"]), seq=int(p["seq"]),
                steps=int(p["steps"]), gpus=int(p["gpus"]), smoke=bool(p["smoke"]), device=p["device"],
                mesh=p["mesh"])
        except ValueError as e:  # DoesNotFit included
            raise LauncherError(f"{self.tool_name}: {e}") from None
        _apply(self.opts, self.sizing)
        self.opts.time_s = max(self.opts.time_s, self.sizing["time_s"])

    def outputs(self) -> dict:
        return {"checkpoints": f"{self.outdir}/{self.params['ckpt_dir']}"}

    def make_command(self) -> str:
        from repro_torch.launch import submit

        p = self.params
        return submit.train_command(
            self.inputs["arch"], steps=p["steps"], global_batch=p["global_batch"], seq=p["seq"],
            ckpt_dir=f"{self.outdir}/{p['ckpt_dir']}", smoke=bool(p["smoke"]), device=p["device"],
            tasks=self.sizing["tasks"], eco_preempt=bool(p["eco_preempt"]), plugin=PLUGIN, mesh=p["mesh"])

    def sbatch_script(self) -> str:
        """Standalone multi-node sbatch (the deploy artifact for big runs)."""
        from repro_torch.launch import submit

        return submit.train_sbatch(self.inputs["arch"], self.sizing, self.make_command(),
                                   time=self.opts.slurm_time, partition=self.opts.queue,
                                   mem_mb=self.opts.memory_mb)


class TorchServeLauncher(Launcher):
    """Serve a model of the PyTorch port on H100 GPUs (repro_torch.launch.serve)."""

    tool_name = "torch-serve"
    tool_version = "0.1.0"
    inputs_spec = [
        InputSpec("arch", required=True, kind="str"),
    ]
    params_spec = [
        InputSpec("batch", required=False, kind="int", default=8),
        InputSpec("prompt_len", required=False, kind="int", default=128),
        InputSpec("gen_len", required=False, kind="int", default=64),
        InputSpec("smoke", required=False, kind="int", default=0),
        InputSpec("gpus", required=False, kind="int", default=1, help="one task a GPU, 8 a host"),
        InputSpec("mesh", required=False, kind="str", default="",
                  help="data=D,model=M over the gpus (empty: model over a host's GPUs, data over the hosts)"),
        InputSpec("device", required=False, kind="str", default="cuda", help="cuda or cpu"),
    ]

    def default_opts(self) -> Opts:
        return Opts.new(threads=8, memory="32GB", time="4h")

    def build(self) -> None:
        from repro_torch.launch import submit

        p = self.params
        try:
            self.sizing = submit.size_serve(self.inputs["arch"], batch=int(p["batch"]),
                                            max_seq=int(p["prompt_len"]) + int(p["gen_len"]),
                                            smoke=bool(p["smoke"]), device=p["device"], gpus=int(p["gpus"]),
                                            mesh=p["mesh"])
        except ValueError as e:
            raise LauncherError(f"{self.tool_name}: {e}") from None
        _apply(self.opts, self.sizing)

    def make_command(self) -> str:
        from repro_torch.launch import submit

        p = self.params
        return submit.serve_command(self.inputs["arch"], batch=p["batch"], prompt_len=p["prompt_len"],
                                    gen_len=p["gen_len"], smoke=bool(p["smoke"]), device=p["device"],
                                    tasks=self.sizing["tasks"], mesh=self.sizing["mesh"])


def _apply(opts: Opts, sizing: dict) -> None:
    """Hosts, tasks (one a GPU), gres and host memory of a sizing."""
    opts.nodes = sizing["hosts"]
    opts.ntasks = sizing["tasks"]
    opts.gres = sizing["gres"]
    if sizing["tasks"] > 1:
        opts.extra = [*opts.extra, f"--ntasks-per-node={sizing['gpus_per_host']}"]
    opts.memory_mb = max(opts.memory_mb, int(sizing["host_mem_gb"] * 1024))


def main(argv=None) -> int:
    """``train ...`` (the port's train CLI, with the eco scheduler for
    ``--eco-preempt``) or ``serve ...`` (the port's serve CLI)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in ("train", "serve"):
        print("usage: torch_h100.py {train,serve} [arguments of repro_torch.launch.train / .serve]",
              file=sys.stderr)
        return 2
    if argv[0] == "train":
        from repro.core.eco import EcoScheduler
        from repro_torch.launch import train

        return train.main(argv[1:], eco=EcoScheduler())
    from repro_torch.launch import serve

    return serve.main(argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
