"""The port as an NBI-Slurm job: GPU sizing (``repro_torch.launch.submit``),
the launcher plugin (``launchers/torch_h100.py``: ``torch-train``,
``torch-serve``), jobs run by the simulator, and eco-preemption through the
plugin.

The simulator tests are the port's counterparts of
``tests/test_system.py``'s ``TestTrainingJobEndToEnd``: ``SimCluster(
execute=True)`` runs each job's script through bash at its simulated end, and
the script runs the port's smoke trainer on the CPU.
"""

import json
import os
import re
import subprocess
import sys
from datetime import datetime
from pathlib import Path

import pytest

from repro.cli import nbilaunch
from repro.core import Manifest, Pipeline, SimCluster, discover_launchers
from repro.core.eco import EcoScheduler
from repro.core.job import Job
from repro.core.launcher import LauncherError
from repro.core.resources import Opts
from repro.launch.submit import ServeLauncher, TrainLauncher
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.launch import submit

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
PLUGIN = ROOT / "launchers" / "torch_h100.py"
# a Monday at 17:00, the start of the default peak hours (17:00-20:00)
PEAK_START = "2026-10-19T17:00:00"


@pytest.fixture
def launchers(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", str(SRC))  # the simulator's jobs import the port
    return discover_launchers(str(ROOT / "launchers"))


# ---------------------------------------------------------------------------
# Sizing
# ---------------------------------------------------------------------------

# chip_smoke.py phase 5's peaks, NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md
# section 5): arch, layers (None: all), batch, sequence (llava's positions:
# 1152 patches and 896 text tokens), MiB
CALIBRATION = [("nbi-100m", None, 8, 512, 7242.3), ("deepseek-moe-16b", 4, 4, 2048, 68238.4),
               ("rwkv6-7b", 8, 4, 2048, 65978.2), ("recurrentgemma-2b", 14, 2, 2048, 53743.5),
               ("minicpm3-4b", 28, 4, 2048, 62538.6), ("llava-next-mistral-7b", 8, 4, 2048, 60006.4),
               ("starcoder2-7b", 5, 4, 2048, 57512.0), ("codeqwen1.5-7b", 6, 4, 2048, 62842.1),
               ("mistral-large-123b", 1, 8, 2048, 64130.4)]


@pytest.mark.parametrize("arch,layers,batch,seq,mib", CALIBRATION)
def test_train_memory_model_within_30_percent_of_the_measured_peaks(arch, layers, batch, seq, mib):
    cfg = get_config(arch)
    cfg = cfg.replace(n_layers=layers) if layers else cfg
    got = submit.train_memory_model(cfg, batch, seq) / 2**20
    assert abs(got - mib) <= 0.3 * mib, (got, mib)


@pytest.mark.parametrize("arch,layers,batch,seq", [("recurrentgemma-2b", None, 2, 2048),
                                                   ("mistral-large-123b", None, 1, 1024),
                                                   ("kimi-k2-1t-a32b", None, 1, 1024)])
def test_configs_that_do_not_fit_one_gpu_are_refused(launchers, arch, layers, batch, seq):
    """recurrentgemma-2b's 26 layers ran out of memory at 74.2 GiB (PERF.md);
    mistral-large-123b and kimi-k2-1t-a32b are 0.12 T and 1.03 T parameters.
    The refusal names the smallest GPU count and mesh that fit."""
    with pytest.raises(submit.DoesNotFit, match="smallest GPU count that fits is gpus="):
        submit.size_train(arch, global_batch=batch, seq=seq, steps=10)
    with pytest.raises(LauncherError, match="smallest GPU count that fits is gpus="):
        launchers["torch-train"](arch=arch, global_batch=batch, seq=seq, eco=False, backend=SimCluster())
    assert submit.train_memory_model(get_config(arch), batch, seq) > submit.GPU_MEMORY_BYTES


@pytest.mark.parametrize("gpus,hosts,per_host", [(1, 1, 1), (4, 1, 4), (8, 1, 8), (12, 2, 6), (16, 2, 8),
                                                 (64, 8, 8)])
def test_gpus_spread_at_eight_a_host(gpus, hosts, per_host):
    s = submit.size_train("nbi-100m", global_batch=8 * gpus, seq=512, steps=100, gpus=gpus)
    assert (s["gpus"], s["hosts"], s["gpus_per_host"], s["tasks"]) == (gpus, hosts, per_host, gpus)
    assert s["gres"] == f"gpu:h100:{per_host}"
    assert s["host_mem_gb"] == 48 * per_host + 100  # the reference's rule


def test_uneven_spreads_and_batches_are_refused():
    with pytest.raises(ValueError, match="evenly"):
        submit.size_train("nbi-100m", global_batch=72, seq=64, steps=1, gpus=9)
    with pytest.raises(ValueError, match="split"):
        submit.size_train("nbi-100m", global_batch=10, seq=64, steps=1, gpus=4)
    with pytest.raises(ValueError, match="audio frames"):
        submit.size_train("whisper-small", global_batch=8, seq=448, steps=1)


def test_wall_time_uses_the_lowest_measured_mfu():
    """rwkv6-7b at 8 layers, 2989.1 tok/s: the lowest MFU phase 5 measured."""
    cfg = get_config("rwkv6-7b").replace(n_layers=8)
    assert submit.train_mfu_floor() == pytest.approx(6 * cfg.active_param_count() * 2989.1 / 989e12)
    one = submit.size_train("nbi-100m", global_batch=16, seq=512, steps=1000)
    eight = submit.size_train("nbi-100m", global_batch=16, seq=512, steps=1000, gpus=8)
    flops = 6 * get_config("nbi-100m").active_param_count() * 1000 * 16 * 512
    assert one["time_s"] == int(flops / (67e12 * submit.train_mfu_floor()) * 2) + 600
    assert eight["time_s"] < one["time_s"]


def test_no_tpu_constant_in_the_port():
    for path in [*(SRC / "repro_torch").rglob("*.py"), PLUGIN]:
        text = path.read_text()
        for word in ("16e9", "v5e", "197e12", "tpu:"):
            assert word not in text, f"{path}: {word}"


def test_serve_sizing():
    s = submit.size_serve("codeqwen1.5-7b", batch=8, max_seq=1056)
    assert s["gres"] == "gpu:h100:1" and s["tasks"] == 1
    assert 15e9 < s["bytes_per_gpu"] < submit.GPU_MEMORY_BYTES  # 16.4 GB of bf16 weights and the cache
    with pytest.raises(submit.DoesNotFit, match="smallest GPU count that fits is gpus=4 with mesh=data=1,model=4"):
        submit.size_serve("mistral-large-123b", batch=8, max_seq=1056)  # 245 GB of bf16 weights
    assert submit.size_serve("mistral-large-123b", batch=8, max_seq=1056, device="cpu")["gres"] == ""


# ---------------------------------------------------------------------------
# The plugin
# ---------------------------------------------------------------------------


def test_plugin_is_discovered_beside_the_reference_launchers(launchers):
    assert {"torch-train", "torch-serve", "train", "serve", "kraken2"} <= set(launchers)
    assert launchers["train"] is TrainLauncher and launchers["serve"] is ServeLauncher
    assert launchers["torch-train"].__module__ == "nbi_launchers.torch_h100"


def test_plugin_imports_no_jax():
    code = ("import sys; from repro.core import discover_launchers; d = discover_launchers(sys.argv[1]); "
            "assert 'torch-train' in d; d['torch-train'](arch='nbi-100m', eco=False).make_command(); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')); print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT / "launchers")], capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stdout + out.stderr


def test_nbilaunch_dry_run_prints_the_gpu_script(launchers, capsys):
    rc = nbilaunch.main(["--launcher-dir", str(ROOT / "launchers"), "torch-train", "arch=nbi-100m", "gpus=16",
                         "global_batch=64", "seq=512", "steps=200", "--no-eco", "--dry-run"])
    assert rc == 0
    script = capsys.readouterr().out
    for line in ("#SBATCH --nodes=2", "#SBATCH --ntasks=16", "#SBATCH --ntasks-per-node=8",
                 "#SBATCH --gres=gpu:h100:8", f"#SBATCH --mem={(48 * 8 + 100) * 1024}"):
        assert line in script, line
    assert ("srun --kill-on-bad-exit=1 python -m repro_torch.launch.train --arch nbi-100m --steps 200 "
            "--global-batch 64 --seq 512 --ckpt-dir ./ckpt") in script
    rc = nbilaunch.main(["--launcher-dir", str(ROOT / "launchers"), "torch-train", "arch=nbi-100m",
                         "eco_preempt=1", "--no-eco", "--dry-run"])
    assert rc == 0
    script = capsys.readouterr().out
    assert "#SBATCH --gres=gpu:h100:1" in script and "--ntasks=1" in script and "srun" not in script
    assert f"python {PLUGIN} train --arch nbi-100m" in script and script.rstrip().endswith("--eco-preempt")


def test_nbilaunch_refuses_what_does_not_fit(launchers, capsys):
    rc = nbilaunch.main(["--launcher-dir", str(ROOT / "launchers"), "torch-train", "arch=mistral-large-123b",
                         "--dry-run"])
    assert rc == 1 and "smallest GPU count that fits is gpus=64 with mesh=data=8,model=8" in capsys.readouterr().out


def test_train_sbatch_is_the_multinode_script(launchers):
    tl = launchers["torch-train"](arch="nbi-100m", gpus=16, global_batch=64, eco=False, backend=SimCluster())
    script = tl.sbatch_script()
    assert "#SBATCH --nodes=2" in script and "#SBATCH --ntasks-per-node=8" in script
    assert "#SBATCH --gres=gpu:h100:8" in script
    assert "\nsrun --kill-on-bad-exit=1 python -m repro_torch.launch.train --arch nbi-100m" in script


# ---------------------------------------------------------------------------
# Jobs run by the simulator
# ---------------------------------------------------------------------------


def train_job(name, ckpt, steps, log, *extra):
    cmd = submit.train_command("nbi-100m", steps=steps, global_batch=2, seq=16, ckpt_dir=str(ckpt), smoke=True,
                               device="cpu")
    job = Job(name=name, command=f"{cmd} {' '.join(extra)} > {log} 2>&1",
              opts=Opts.new(threads=2, memory="4GB", time="2h"), sim_duration_s=60)
    job.prelude = [f"export PYTHONPATH={SRC}"]
    return job


def test_sim_executes_the_ports_training_through_the_launcher(launchers, tmp_path):
    """nbilaunch's torch-train on the CPU: the simulator runs the job's script,
    which trains the port's smoke model; the checkpoint is on disk and the
    manifest records success."""
    sim = SimCluster(execute=True)
    tl = launchers["torch-train"](arch="nbi-100m", smoke=1, device="cpu", steps=4, global_batch=2, seq=16,
                                  outdir=str(tmp_path / "out"), eco=False, backend=sim)
    assert tl.opts.gres == "" and tl.opts.ntasks == 1
    jid = tl.submit(eco=False)
    sim.run_until_idle()
    assert sim.get(jid).state == "COMPLETED"
    assert Manifest.load(tl.manifest_path())["status"] == "completed"
    assert CheckpointManager(tmp_path / "out" / "ckpt").latest_step() == 4


def test_failure_requeue_then_resume(launchers, tmp_path):
    """A first run reaches step 3 (its node then dies); the requeued run of
    the same job resumes from the checkpoint and reaches step 6."""
    sim = SimCluster(execute=True)
    ckpt = tmp_path / "ckpt"
    id1 = train_job("run1", ckpt, 3, tmp_path / "run1.log").run(sim)
    sim.run_until_idle()
    assert sim.get(id1).state == "COMPLETED"
    assert CheckpointManager(ckpt).latest_step() == 3
    id2 = train_job("run2", ckpt, 6, tmp_path / "run2.log").run(sim)
    sim.run_until_idle()
    assert sim.get(id2).state == "COMPLETED"
    assert "resumed from step 3" in (tmp_path / "run2.log").read_text()
    assert CheckpointManager(ckpt).latest_step() == 6


def test_train_pipeline_with_eval_step(launchers, tmp_path):
    """Pipeline: the port's train job → an 'eval' job that reads its
    checkpoint (afterok)."""
    sim = SimCluster(execute=True)
    ckpt = tmp_path / "ckpt"
    p = Pipeline("train-eval", backend=sim)
    p.add("train", train_job("train", ckpt, 2, tmp_path / "train.log"))
    p.add("eval", Job(name="eval", command=f"test -d {ckpt}/step_000000002 && echo ok > {tmp_path}/eval.txt",
                      opts=Opts.new(threads=1, memory="1GB", time="1h"), sim_duration_s=5), after="train")
    p.run()
    sim.run_until_idle()
    assert {j.name: j.state for j in sim.accounting()} == {"train": "COMPLETED", "eval": "COMPLETED"}
    assert (tmp_path / "eval.txt").read_text().strip() == "ok"


def test_sim_executes_a_serve_job(launchers, tmp_path):
    sim = SimCluster(execute=True)
    sl = launchers["torch-serve"](arch="nbi-100m", smoke=1, device="cpu", batch=2, prompt_len=8, gen_len=4,
                                  outdir=str(tmp_path), eco=False, backend=sim)
    assert sl.make_command().startswith("python -m repro_torch.launch.serve --arch nbi-100m --batch 2")
    jid = sl.submit(eco=False)
    sim.run_until_idle()
    assert sim.get(jid).state == "COMPLETED"
    assert Manifest.load(sl.manifest_path())["status"] == "completed"


def served_tokens(log: str) -> list:
    return [line.split("-> ")[1] for line in log.splitlines() if line.startswith("[serve] req")]


def test_launcher_serves_on_a_mesh_of_slurm_tasks(launchers, tmp_path):
    """torch-serve with gpus=4 mesh=data=2,model=2 on the CPU: the plugin's
    command (``srun`` over four tasks, ``--mesh``) run as four SLURM tasks
    over gloo, against ``--mesh data=1,model=1`` in one process. The mesh
    engine draws the same weights on every mesh, so the greedy tokens agree
    request by request, on every rank."""
    from test_torch_mesh_train import run_processes

    from test_torch_distributed import free_job_id

    sl = launchers["torch-serve"](arch="nbi-100m", smoke=1, device="cpu", gpus=4, mesh="data=2,model=2", batch=4,
                                  prompt_len=8, gen_len=4, outdir=str(tmp_path), eco=False, backend=SimCluster())
    assert sl.opts.ntasks == 4 and sl.opts.gres == ""
    command = sl.make_command()
    assert command.startswith("srun --kill-on-bad-exit=1 python -m repro_torch.launch.serve")
    argv = [sys.executable, *command.removeprefix("srun --kill-on-bad-exit=1 python").split()]
    assert argv[-2:] == ["--mesh", "data=2,model=2"]
    job = str(free_job_id())
    slurm = [{"SLURM_JOB_ID": job, "SLURM_JOB_NODELIST": "localhost", "SLURM_NTASKS": "4", "SLURM_PROCID": str(r),
              "SLURM_NODEID": "0", "SLURM_LOCALID": str(r)} for r in range(4)]
    (tmp_path / "four").mkdir()
    (tmp_path / "one").mkdir()
    four = run_processes([argv] * 4, slurm, tmp_path / "four")
    one = run_processes([argv[:-1] + ["data=1,model=1"]], [{}], tmp_path / "one")
    want = served_tokens(one[0])
    assert len(want) == 4, one[0][-2000:]
    assert all(served_tokens(log) == want for log in four), (four[0][-2000:], want)
    assert "over mesh data=2,model=2" in four[0]


# ---------------------------------------------------------------------------
# Eco-preemption through the plugin
# ---------------------------------------------------------------------------


def leaves_of(ckpt: Path, step: int) -> dict:
    d = CheckpointManager(ckpt).step_dir(step)
    manifest = json.loads((d / "MANIFEST.json").read_text())
    return {r["keypath"]: (d / r["file"]).read_bytes() for r in manifest["leaves"]}, manifest["extra"]


def test_eco_preempt_job_stops_at_the_peak_and_resumes_bitwise(launchers, tmp_path):
    """An eco-preempt job started at the first instant of peak hours stops
    after one step with "eco-preempt", saves step 1 and prints the --begin of
    the next eco window (EcoScheduler().begin_directive(3600, clock)); the
    job rerun without the flag resumes to 4 steps, bitwise equal to 4
    straight steps."""
    sim = SimCluster(execute=True)
    ckpt, straight = tmp_path / "eco", tmp_path / "straight"
    cmd = submit.train_command("nbi-100m", steps=4, global_batch=2, seq=16, ckpt_dir=str(ckpt), smoke=True,
                               device="cpu", eco_preempt=True, plugin=str(PLUGIN))
    eco_job = Job(name="eco", command=f"{cmd} --now {PEAK_START} --log-every 1 > {tmp_path}/eco.log 2>&1",
                  opts=Opts.new(threads=2, memory="4GB", time="2h"), sim_duration_s=60)
    eco_job.prelude = [f"export PYTHONPATH={SRC}"]
    ids = [eco_job.run(sim)]
    sim.run_until_idle()
    log = (tmp_path / "eco.log").read_text()
    assert "[train] step 1/4" in log and "[train] step 2/4" not in log, log
    begin = re.search(r"--begin=(\S+)", log).group(1)
    assert begin == EcoScheduler().begin_directive(3600, datetime.fromisoformat(PEAK_START))
    assert CheckpointManager(ckpt).all_steps() == [1]
    assert leaves_of(ckpt, 1)[1]["stopped"] == "eco-preempt"
    ids.append(train_job("rerun", ckpt, 4, tmp_path / "rerun.log").run(sim))
    ids.append(train_job("straight", straight, 4, tmp_path / "straight.log").run(sim))
    sim.run_until_idle()
    assert [sim.get(i).state for i in ids] == ["COMPLETED"] * 3
    assert "resumed from step 1" in (tmp_path / "rerun.log").read_text()
    (resumed, extra), (want, _) = leaves_of(ckpt, 4), leaves_of(straight, 4)
    assert extra["data_cursor"] == 4 and resumed == want


def test_eco_preempt_without_a_scheduler_exits_non_zero():
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", "nbi-100m", "--smoke",
                          "--device", "cpu", "--steps", "1", "--eco-preempt"], capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode != 0 and "launchers/torch_h100.py" in out.stderr
    from repro_torch.launch.train import build_argparser, train

    with pytest.raises(ValueError, match="launcher plugin"):
        train(build_argparser().parse_args(["--arch", "nbi-100m", "--smoke", "--device", "cpu",
                                            "--eco-preempt"]))


def test_plugin_main_rejects_other_commands(capsys):
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_h100_main", PLUGIN)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main([]) == 2 and mod.main(["bench"]) == 2
    assert "usage" in capsys.readouterr().err
