#!/usr/bin/env python3
"""Time chip_smoke.py's attention and RMSNorm cases from several trees of the
repo on one card, in turns, each tree in its own process.

    python3 chip_variants.py [--cases NAME,...] [--time-only] ROOT [ROOT ...]
    python3 chip_variants.py --serve ARCH ROOT [ROOT ...]
    python3 chip_variants.py --continuous ARCH ROOT [ROOT ...]

A ROOT is a tree of the repo: this checkout (``.``), a ``git archive`` of
another commit unpacked under ``build/`` (which git ignores), or a copy of
``src/`` there with other constants in a kernel's
source. Every root builds its kernels first, all at once, each into its own
``ROOT/build/``, and prints its attention and RMSNorm kernels' registers and
spills. ``--cases`` takes chip_smoke.py's attention case names and its RMSNorm
case names (``norm_cases``), in any mix; a tree whose RMSNorm wrapper has
``launch_config`` prints each RMSNorm case's launch too.
Then every root is timed once in order and once in reverse: for a parent
and a change, parent, change, change, parent.
A timing process imports the root's ``repro_torch`` and then this checkout's
``chip_smoke``, so that every root runs the same cases with the same timer.
``--serve ARCH`` runs ``chip_smoke.serve_path`` for ARCH instead (serving,
exact launch counts and the traced prefill's device time and kernel shares);
``--continuous ARCH`` runs ``chip_smoke.continuous_path`` for ARCH
(continuous batching with f32 activations: exact launch counts, generated
tok/s over the run's wall, every token against a full forward).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def child(root: Path, cases: list[str], time_only: bool, serve: str | None, continuous: str | None) -> None:
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    if not Path(fa.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"{fa.__file__} is not under {root}")
    sys.path.insert(1, str(HERE))
    import chip_smoke as cs  # this checkout's cases and timer; repro_torch stays the root's
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_variants: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)  # the allocator exists before serve_path resets its peak
    cs.say(f"[root] {root} | {cs.nvidia_smi_line()}")
    for r in _build.ptxas_report():
        if "attn" in r["kernel"] or "rmsnorm" in r["kernel"]:
            cs.say(f"[root] {r['kernel']} | registers {r['registers']} | spills "
                   f"{r['spill_store_bytes']}/{r['spill_load_bytes']} B")
    if serve:
        cs.serve_path(serve, device, True)
        return
    if continuous:
        cs.continuous_path(continuous, device, True)
        return
    attention = [c for c in cases if c in {a[0] for a in cs.attention_cases(True)}]
    norms = {n[0]: n[1:] for n in cs.norm_cases(True) if n[0] in cases}
    if unknown := set(cases) - set(attention) - set(norms):
        raise SystemExit(f"chip_variants: no such case {sorted(unknown)}")
    if not time_only:
        if attention:
            cs.run_attention_cases(device, cs.Timer(device), True, only=attention)
        for name, (rows, D, dtype) in norms.items():
            if hasattr(cs.rn_kernel, "launch_config"):
                cs.say(f"[root] rmsnorm {name}: {cs.norm_launch_line(rows, D, dtype)}")
        if norms:
            cs.run_norm_cases(device, cs.Timer(device), True, only=norms)
        return
    # a diagnostic variant computes another function: time it, check nothing
    g = torch.Generator(device=device).manual_seed(0)
    for name, B, Hq, Hkv, Sq, Skv, d, dv, dtype, causal, window, cap in cs.attention_cases(True):
        if name in cases:
            q, k, v = (torch.randn(shape, generator=g, device=device).to(dtype)
                       for shape in ((B, Hq, Sq, d), (B, Hkv, Skv, d), (B, Hkv, Skv, dv)))
            kw = dict(causal=causal, window=window, logit_cap=cap)
            ms = cs.Timer(device)(lambda: cs.ops.attention(q, k, v, **kw), iters=20)
            cs.say(f"[time-only] {name}: kernel={ms:.4f}ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", type=Path)
    ap.add_argument("--cases", default="mla_prefill,mla_ragged,mla_window,mla_prefill_s512,mla_unequal_turns",
                    help="chip_smoke.py attention cases, comma-separated")
    ap.add_argument("--time-only", action="store_true",
                    help="time the kernel alone, unchecked (for diagnostic variants that compute something else)")
    ap.add_argument("--serve", metavar="ARCH", help="run chip_smoke.py's serving path of ARCH, traced")
    ap.add_argument("--continuous", metavar="ARCH", help="run chip_smoke.py's continuous-batching path of ARCH")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    roots = [r.resolve() for r in args.roots]
    cases = args.cases.split(",")
    if args.child:
        child(roots[0], cases, args.time_only, args.serve, args.continuous)
        return 0
    build = "import sys; sys.path.insert(0, sys.argv[1]); from repro_torch.kernels import _build; _build.library_path()"
    jobs = [subprocess.Popen([sys.executable, "-c", build, str(root / "src")]) for root in dict.fromkeys(roots)]
    if any(job.wait() for job in jobs):
        return 1
    for r in range(2):
        for root in roots if r == 0 else roots[::-1]:
            print(f"[round {r}] {root}", flush=True)
            flags = ((["--time-only"] if args.time_only else []) + (["--serve", args.serve] if args.serve else [])
                     + (["--continuous", args.continuous] if args.continuous else []))
            run = subprocess.run([sys.executable, __file__, "--child", *flags, "--cases", args.cases, str(root)])
            if run.returncode:
                return run.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
