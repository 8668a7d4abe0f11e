"""Dry-run: count every (architecture × shape × mesh) cell's step per device
without memory or a device (the port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell's step against abstract inputs
on 512 fake XLA devices and parses the partitioned HLO. Here the step runs
on ``meta`` tensors (shapes and dtypes, no storage): on a production mesh as
rank 0 of a process group of the ``fake`` backend (collectives return at
once), the train state, parameters, cache and inputs DTensors of meta local
shards laid out by the reference's rules. :func:`repro_torch.analysis.opstats.count`
counts the step as it runs (FLOPs, HBM bytes, collective wire bytes, peak
live bytes, the port's kernel calls), and each cell's record adds the
three-term roofline under an H100's peaks
(:mod:`repro_torch.analysis.roofline`).

Usage:
  python -m repro_torch.launch.dryrun                       # all cells, both meshes
  python -m repro_torch.launch.dryrun --arch rwkv6-7b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --out results/dryrun  # JSON per cell

Cells are persisted incrementally; rerunning skips completed cells unless
--force. Exit code is non-zero if any attempted cell fails. A cell builds
its process group and destroys it when done; it refuses to start beside a
group that already exists (it would build its mesh on that group).
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.analysis.opstats import count
from repro_torch.analysis.roofline import H100, roofline_report, unit_of
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.launch.mesh import parse_mesh
from repro_torch.models.common import map_defs
from repro_torch.models.registry import build_model
from repro_torch.optim import make_optimizer
from repro_torch.training.steps import (
    abstract_train_state,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    train_state_logical,
)

# (kind, seq_len, global_batch)
SHAPES = {
    "train_4k": ("train", 4_096, 256),
    "prefill_32k": ("prefill", 32_768, 32),
    "decode_32k": ("decode", 32_768, 128),
    "long_500k": ("decode", 524_288, 1),
}

# The H100 counterparts of the reference's production meshes (a pod of 16 ×
# 16 chips, two pods): 8 GPUs a node joined by NVLink, so the model axis
# stays 8 wide inside a node (16 would span two, which make_job_mesh
# refuses) and the data axes span the nodes.
MESHES = {"single": "data=32,model=8", "multi": "pod=2,data=32,model=8"}


def plan_cells(archs=None, shapes=None):
    """All (arch, shape) cells incl. assignment-mandated skips."""
    cells = []
    for arch in archs or ASSIGNED:
        cfg = get_config(arch)
        for shape_name, (kind, seq, batch) in SHAPES.items():
            if shapes and shape_name not in shapes:
                continue
            skip = None
            if shape_name == "long_500k" and not cfg.sub_quadratic:
                skip = "full-attention arch: 500k decode excluded by assignment rule"
            if kind == "decode" and not cfg.has_decoder:
                skip = "encoder-only arch has no decode step"
            cells.append(
                {"arch": arch, "shape": shape_name, "kind": kind,
                 "seq": seq, "batch": batch, "skip": skip}
            )
    return cells


def kernel_widths(cfg):
    """``cfg`` with head widths the attention kernel takes, where its own are
    none of ``HEAD_DIM_PAIRS``: 64, or MLA's (64 + 32, 64). The smoke configs'
    16-wide heads are no kernel's, and a count refuses them as the card's
    wrapper does; RWKV-6 has no attention (its WKV head size of 16 is one of
    the kernel's) and stays as it is."""
    from repro_torch.kernels.flash_attention import HEAD_DIM_PAIRS

    if cfg.family == "rwkv6":
        return cfg
    if cfg.attention == "mla":
        pair = (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim)
        return cfg if pair in HEAD_DIM_PAIRS else cfg.replace(qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64)
    hd = cfg.resolved_head_dim
    return cfg if (hd, hd) in HEAD_DIM_PAIRS else cfg.replace(head_dim=64)


def _on_mesh(tree, logical, rules, mesh):
    """A tree of meta tensors as DTensors of meta local shards, laid out by
    the rules (no tensor holds storage)."""
    from repro_torch.parallel.sharding import from_local, local_shape, resolve_tree

    def shard(t, pl):
        local = torch.empty(local_shape(t.shape, pl, mesh), dtype=t.dtype, device="meta")
        return from_local(local, mesh, pl, tuple(t.shape))

    return map_defs(shard, tree, resolve_tree(mesh, logical, rules))


def step_and_inputs(model, kind: str, batch: int, seq: int, rules=None, mesh=None) -> tuple:
    """(step, its arguments on ``meta``) of one train, prefill or decode step
    of ``batch`` rows of ``seq`` tokens (decode: a cache of ``seq``), on
    ``mesh`` under ``rules`` when given (DTensors of meta local shards)."""
    def place(tree, logical):
        return tree if mesh is None else _on_mesh(tree, logical, rules, mesh)

    if kind == "train":
        optimizer = make_optimizer(model.cfg.optimizer)
        state = place(abstract_train_state(model, optimizer), train_state_logical(model, optimizer))
        inputs = place(model.train_inputs(batch, seq), model.train_input_logical())
        return make_train_step(model, optimizer, rules, mesh), (state, inputs)
    params = place(model.abstract_params(), model.param_logical())
    if kind == "prefill":
        inputs = place(model.prefill_inputs(batch, seq), model.prefill_input_logical())
        return make_prefill_step(model, rules, mesh), (params, inputs)
    cache = place(model.cache_defs_fn(batch, seq), model.cache_logical_fn())
    toks = model.decode_inputs(batch)
    tokens = place({"tokens": toks["tokens"]}, {"tokens": ("batch", None)})["tokens"]
    return make_serve_step(model, rules, mesh), (params, cache, tokens, toks["pos"])


def _fake_mesh(spec: str):
    """The mesh of ``spec`` as rank 0 of a new process group of the ``fake``
    backend (no process, no communication)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = parse_mesh(spec)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=shape.size())
    return init_device_mesh("cpu", shape.shape, mesh_dim_names=shape.mesh_dim_names)


def count_cell(arch: str, shape_name: str, mesh_name: str = "single", *, cfg=None, spec: "str | None" = None) -> dict:
    """Count one step of the cell (``cfg``: the arch's published config when
    not given; ``spec``: the ``--mesh`` value, ``MESHES[mesh_name]`` when not
    given) and return its record. Raises when a process group exists; the
    cell's own group is destroyed when it returns or raises."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("count_cell builds its own fake process group; one already exists in this process")
    kind, seq, batch = SHAPES[shape_name]
    cfg = cfg or get_config(arch)
    spec = spec or MESHES[mesh_name]
    model = build_model(cfg)
    t0 = time.time()
    try:
        mesh = _fake_mesh(spec)
        from repro_torch.parallel.sharding import rules_for

        rules = rules_for(
            cfg, mesh,
            param_defs=model.param_defs,
            batch_size=batch,
            extra_dims={"kv_seq": seq, "heads": cfg.n_heads, "seq": seq},
            fsdp=cfg.fsdp and kind == "train",  # ZeRO-3 is a training-path rule
        )
        step, args = step_and_inputs(model, kind, batch, seq, rules, mesh)
        stats, _ = count(step, *args)
        chips = mesh.size()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    count_s = time.time() - t0
    tokens = batch * (1 if kind == "decode" else seq)
    model_flops = (6 if kind == "train" else 2) * cfg.active_param_count() * tokens
    return {
        "arch": arch,
        "shape": shape_name,
        "kind": kind,
        "mesh": spec,
        "chips": chips,
        "seq": seq,
        "batch": batch,
        "count_s": round(count_s, 1),
        "rules": {k: (list(v) if isinstance(v, tuple) else v) for k, v in rules.items()},
        "memory": {"argument_bytes": stats.argument_bytes, "output_bytes": stats.output_bytes,
                   "peak_bytes": stats.peak_bytes},
        "flops_per_device": stats.flops,
        "flops_by_unit": stats.flops_by_unit,
        "flops_by_op": stats.flops_by_op,
        "hbm_bytes_per_device": stats.hbm_bytes,
        "collective_wire_bytes_per_device": stats.collective_wire_bytes,
        "wire_bytes_by_link": stats.wire_bytes_by_link,
        "collective_by_type": stats.collective_by_type,
        "collective_count": stats.collective_count,
        "kernel_calls": stats.kernel_calls,
        "analysis_notes": stats.notes[:8],
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "padded_vocab": model.cfg.vocab_size,
        "roofline": roofline_report(
            per_device_flops=stats.flops, per_device_hbm_bytes=stats.hbm_bytes,
            per_device_wire_bytes=stats.collective_wire_bytes, chips=chips, model_flops=model_flops,
            tokens=tokens, hw=H100, flops_by_unit=stats.flops_by_unit,
            wire_bytes_by_link=stats.wire_bytes_by_link, unit=unit_of(cfg.dtype)),
        "status": "ok",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", help="arch id (repeatable)")
    ap.add_argument("--shape", action="append", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = plan_cells(args.arch, args.shape)
    failures = 0
    for cell in cells:
        for mesh_name in meshes:
            tag = f"{cell['arch']}__{cell['shape']}__{mesh_name}"
            path = outdir / f"{tag}.json"
            if cell["skip"]:
                path.write_text(json.dumps({**cell, "mesh": MESHES[mesh_name], "status": "skipped",
                                            "skip_reason": cell["skip"]}, indent=2))
                print(f"[skip] {tag}: {cell['skip']}")
                continue
            if path.exists() and not args.force:
                try:
                    prev = json.loads(path.read_text())
                except json.JSONDecodeError:
                    prev = {}
                if prev.get("status") == "ok":
                    print(f"[cached] {tag}")
                    continue
            print(f"[count] {tag} ...", flush=True)
            try:
                rec = count_cell(cell["arch"], cell["shape"], mesh_name)
                path.write_text(json.dumps(rec, indent=2))
                print(
                    f"[ok] {tag} count={rec['count_s']}s "
                    f"flops/dev={rec['flops_per_device']:.3e} "
                    f"wire/dev={rec['collective_wire_bytes_per_device']:.3e} "
                    f"peak/dev={rec['memory']['peak_bytes'] / 1e9:.2f}GB",
                    flush=True,
                )
            except Exception as e:  # noqa: BLE001 — report and continue
                failures += 1
                path.write_text(json.dumps({**cell, "mesh": MESHES[mesh_name], "status": "error",
                                            "error": f"{type(e).__name__}: {e}",
                                            "traceback": traceback.format_exc()[-4000:]},
                                           indent=2))
                print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
    print(f"done; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
