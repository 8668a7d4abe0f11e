#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which stops the script with a non-zero exit when it fails:

1. device: the card's name and power limit (``nvidia-smi``); no CUDA device
   is a failure, never a fallback to the CPU;
2. build: compile every kernel from ``src/repro_torch/kernels/csrc`` into
   ``build/repro_torch/`` and print ptxas registers, shared memory, spills
   and warnings, each flash-attention kernel's block per head-dim pair and
   dtype (rows, keys a tile, stages, dynamic shared memory), and the
   WKV-6 and MoE gating launches (threads, shared memory, registers, blocks
   resident per SM) and each RMSNorm case's (path, warps a row, vectors a
   thread, blocks, blocks resident per SM) as the library reports them;
3. kernels: hold each kernel against its plain PyTorch version on the card
   and time kernel, plain version and one library call (a yardstick the port
   never calls) with CUDA events around replays of a CUDA graph of the calls;
4. main paths, one engine at a time, each freed before the next: serve 16
   greedy requests through nbi-100m, recurrentgemma-2b, rwkv6-7b (full
   width, 8 of its 32 layers), deepseek-moe-16b (8 of 28),
   kimi-k2-1t-a32b (full width, 2 of its 61 layers: 384
   experts, top-8, groups of 256), minicpm3-4b (MLA, 16 of 62), starcoder2-7b
   (full width, 8 of its 32 layers), mistral-large-123b (full width, 8 of
   its 88 layers) and whisper-small
   (full width and depth, fed zero audio frames as the engine feeds them)
   with seeded weights, and feed
   llava-next-mistral-7b's model functions 1152 seeded patch embeddings
   before each text; count every kernel's launches around each path and
   require the exact counts, and no launch of the RMSNorm kernel's generic
   path on any path (nbi-100m: each prefill attention through the
   f32 tensor-core (3xTF32) flash-attention kernel and each RMSNorm through
   the RMSNorm kernel; Griffin: each prefill attention through the bf16
   flash-attention kernel and each RG-LRU prefill scan through the LRU
   kernel; RWKV-6: each WKV prefill through the WKV kernel;
   the MoE paths: bf16 attention, norms, and each MoE layer's routing,
   prefill and decode, through the gating kernels, the slots kernel on every
   routing whose groups span more than one tile; minicpm3-4b: each prefill
   attention through the bf16 MLA kernel at (96, 64) and 4L+1 norms,
   q_ln and kv_ln included, per prefill and decode step; the other dense
   paths: bf16 attention at d 128 and 2L+1 norms; whisper-small: each of
   its 12 encoder, 12 self- and 12 cross-attentions a prefill batch through
   the bf16 kernel at d 64, and no other launch); check the
   decode-equals-forward law at full width and the card against the CPU on
   a small model of each family (the card's decode step a replay of its
   CUDA graph), then trace one batch with torch.profiler
   (device busy share, each of the port's kernels' share of the prefill's
   device time, and the ops that take the most device time; the kernels the
   trace shows by name, replays included, must be as many as the counters
   say). Without a mesh the engines decode by replaying a CUDA graph of the
   step (``launch/serve.py``'s ``_DecodeGraph``), which counts at each
   replay the launches its capture recorded: every path's
   ``decode_replays`` must equal its decode steps. Each path then runs its
   graph against the eager ``decode_fn`` on a copy of the static cache, 4
   steps in turns from one state (greedy tokens and every logit equal, the
   median wall ms a step, and device ms and busy share
   from 4 profiled steps each); then
   continuous batching (``ContinuousBatchingEngine``, 8 slots, 16 requests
   of mixed lengths) on minicpm3-4b at full width (16 of 62 layers), on nbi-100m and on
   codeqwen1.5-7b at full width (8 of its 32 layers), with f32 activations: exact
   launches per insert and decode step (each insert's attentions through the
   f32 tensor-core (3xTF32) kernel of its heads: the MLA kernel at (96, 64),
   the d 64 kernel, the d 128 kernel; none through the other f32 kernels), every chosen
   token within 1e-3 of the max logit of a full forward over its request,
   and decode steps against the static bound; then inserts into the
   engine's static cache between replays, beside a slot part-way through its
   generation, with the same checks, exact launches, and the first
   request's tokens equal to a run of it alone; then the graph against the
   eager step with every slot filled;
5. training: train nbi-100m at full width and depth through
   ``repro_torch.launch.train`` (global batch 8 x 512 tokens, 30 AdamW steps
   with cosine warmup, the port's data pipeline, seeded weights drawn on the
   card) with the launch counters set to 0 just before and read just after:
   every forward's 12 attentions through the f32 tensor-core (3xTF32)
   flash-attention kernel and its 25 norms through the RMSNorm kernel, the
   backward (the plain path recomputed) through neither; the loss must fall.
   The launcher steps through the train step's CUDA graph
   (``training/graph.py``'s ``TrainGraph``, the counterpart of the
   reference's ``jax.jit`` over its train step with the state donated): the
   first step is an eager warm-up, then the step is captured, and every
   later step must replay it (every train path below holds its replays to
   its steps less one; the launch counts add at each replay what the
   capture recorded, so they stay exact). Then train tok/s, step ms (the
   warm-up's and the capture's apart) and peak memory, one replay traced
   with torch.profiler (device busy share, K1's and K2's shares, top ops),
   the replays against eager steps from a clone of one state in turns
   (losses, metrics, launches and the final states equal bit for bit; wall
   and device ms a step and busy share of each: the eager step's median is
   the host's yardstick), one train step of a small model on the card
   against the CPU and its replays against its eager steps, and resume
   equivalence: 2N straight steps against N steps, a checkpoint, a fresh
   restore and N more, bitwise under ``torch.use_deterministic_algorithms``
   (the resumed run's eager warm-up standing where the straight run
   replayed: equal losses).
   Then train deepseek-moe-16b (4 of 28 layers), rwkv6-7b (4 of 32),
   recurrentgemma-2b (14 of 26), whisper-small (all 12 + 12 layers, 8
   rows of 448 tokens against 8 x 1500 seeded audio frames, which the data
   pipeline does not make), minicpm3-4b (MLA, 8 of 62 layers, 4 x 2048
   tokens), llava-next-mistral-7b (8 of 32 layers, 4 rows of 896 text
   tokens behind 1152 seeded patch embeddings, which the data pipeline does
   not make either), an MoE model with MLA attention (deepseek-moe-16b's
   widths with minicpm3-4b's MLA ranks, 4 of 28 layers), starcoder2-7b (5
   of 32), codeqwen1.5-7b (6 of 32) and mistral-large-123b (1 of 88, 8 rows
   as 8 microbatches under remat "selective") at full width for 8 steps
   each (llava 10) through the launcher's pieces (the config's optimizer with cosine
   warmup, the train state drawn on the card, the train step's graph, the
   data pipeline), with the counts set to 0 just before and read just after:
   under remat "full" and "selective" every forward kernel runs twice a
   step (the forward, then the backward's recompute of each layer), once a
   microbatch, K5 (route and slots) per MoE routing, K4 per RWKV-6 layer, K3 per recurrent layer, K1 per attention layer (Whisper's
   encoder, self- and cross-attentions; MLA's through the bf16 (96, 64)
   kernel), K2 per RMSNorm (MLA's q_ln and kv_ln included), and no backward
   launches one; the loss must fall. Then each
   family's step ms, tok/s, peak memory, one traced replay (the port's
   kernels in the trace must equal what the replay added to the counts),
   the time of the state's copy into the graph's static leaves, one eager
   step held against its count (whisper-small's replays against its eager steps
   in turns too) and a small model's train step on the card against the
   CPU and its replays against its eager steps, its launches counted
   around the card's step and held exact (the
   small MLA model's in f32: K1's f32 (96, 64) kernel in the forward and in
   the recompute). The dry-run leg: each train path's step (nbi-100m's
   before its trace) and nbi-100m's prefill at 8 x 512 are counted on meta in this
   process (``repro_torch.analysis.opstats``, no process group) and run
   once on the card: the counted kernel calls must equal the launches and
   the counted argument bytes the state's and batch's storages, exactly,
   and the counted peak must lie within 0.85-1.15 of the measured one
   (``max_memory_allocated`` above what was allocated before the step, plus
   the arguments); each prints the roofline's terms under the H100's
   published peaks beside the measured median step, and the count's lower
   bound may not exceed the measured step. Later, beside the eco leg (which
   times nothing), ``python -m repro_torch.launch.dryrun --arch
   deepseek-moe-16b --shape train_4k --mesh single`` counts that cell in a
   subprocess on a fake process group of 256 ranks: status ok, wire bytes
   above zero, K5 twice a MoE layer. Then the data-parallel
   step in a process group of one rank (NCCL, ``tcp://localhost``): at the
   resume check's shapes, nbi-100m's exact DP step (``compress=False``)
   equals ``make_train_step`` bit for bit after N steps under
   ``torch.use_deterministic_algorithms``, with the same exact K1 and K2
   launches (counted as a path); both steps timed in turns; the compressed
   step runs, the mean of 20 error-fed syncs of a constant tracks it (rtol
   0.02), and the int8 payload, scales and error-feedback carry on the card
   equal the CPU's (a gloo group) bit for bit. Then the mesh leg: the step
   on a 1 x 1 ("data", "model") device mesh in a process group of one rank
   (NCCL; gloo in the rehearsal), the state and batches DTensors laid out by
   ``rules_for`` with FSDP forced on (so ``embed`` and ``batch`` map to
   ``data``): nbi-100m at full width and depth at the resume check's shapes,
   TRAIN_SMALL_MODELS' deepseek-moe-16b, recurrentgemma-2b and rwkv6-7b in
   bf16, and minicpm3-4b (MLA: K1's bf16 (96, 64) kernel) and
   llava-next-mistral-7b (1152 seeded patches) at full width and 4 layers
   and whisper-small (seeded frames) whole (MESH_WIDE), each N steps
   against ``make_train_step`` from the same state, bit for bit under
   ``torch.use_deterministic_algorithms``, the kernels (K1, K2, K3, K4, K5)
   reached through the ops' local-shard routes with exactly the plain
   step's launches (counted as paths); both steps timed in turns. Then
   serving on the same mesh: ``ServeEngine(mesh=)`` against
   ``ServeEngine()`` holding the same weights for nbi-100m at full width and
   depth, the small deepseek-moe-16b (a capacity no pick can overflow),
   recurrentgemma-2b and rwkv6-7b, and at full width minicpm3-4b (16
   layers), llava-next-mistral-7b (its text) and whisper-small (whole);
   llava's prefix through ``make_prefill_step``
   and ``make_serve_step`` against the model's functions; and
   ``ContinuousBatchingEngine(mesh=)`` for nbi-100m and minicpm3-4b (full
   width, 16 layers) in f32 (K1's f32 (96, 64) kernel an insert): greedy tokens
   and the last logits bit for bit, the exact launches of prefill and
   decode (counted as paths), each run's decode steps timed in turns. The
   mesh engines decode by replaying a CUDA graph too (the step under the
   rules and the gather of the logits, captured once): each of the nine
   mesh engine paths holds its ``decode_replays`` to its decode steps, and
   runs its graph against the eager mesh step on a copy of the static
   DTensor cache as phase 4's paths do (greedy tokens and every logit
   equal, wall and device ms and busy share in turns); llava's prefix steps
   stay eager (no engine). Then
   eco-preemption through the launcher plugin ``launchers/torch_h100.py``
   in a subprocess (this script imports nothing of ``repro``), with
   ``NBISLURM_CONFIG`` an empty file: started at the first instant of the default peak hours, the run
   stops after one step with "eco-preempt", saves step 1 and prints the next
   eco window's ``--begin``; rerun without the flag (in this process) it
   resumes to N steps, bitwise equal to N straight steps. Every leg prints
   its seconds, and the script its total.

The line before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. ``--rehearse-cpu`` runs phases 3
to 5 at smoke size on the CPU through the plain versions, to check the
script's control flow without a card; it prints no device result.
"""

from __future__ import annotations

import argparse
import contextlib
import filecmp
import gc
import itertools
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# cuBLAS reads its workspace setting when its first handle is made; the
# resume check of phase 5 runs under torch.use_deterministic_algorithms, which
# needs one of the two fixed settings. 8 x 4 MiB is PyTorch's default on Hopper.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
# The family train paths run near the card's memory (deepseek-moe-16b's peak
# is about 67 of 79 GiB). With fixed-size segments, blocks split by the
# earlier paths left 14 GiB reserved but unallocated there and its AdamW
# update ran out of memory; expandable segments grow in place instead. The
# allocator reads this when CUDA starts.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.analysis.opstats import count, storage_bytes  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa_kernel  # noqa: E402
from repro_torch.kernels import moe_gating as gating_kernel  # noqa: E402
from repro_torch.kernels import rglru_scan as lru_kernel  # noqa: E402
from repro_torch.kernels import rmsnorm as rn_kernel  # noqa: E402
from repro_torch.kernels import rwkv6_scan as wkv_kernel  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data import make_train_loader  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.distributed import dp_groups, initialize  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.serve import ContinuousBatchingEngine, ServeEngine, _DecodeGraph, _whole  # noqa: E402
from repro_torch.launch.serve import device_name, fill_cache, pad_cache_to  # noqa: E402
from repro_torch.launch.train import build_argparser as train_argparser  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import rglru as rg  # noqa: E402
from repro_torch.models.common import map_defs, tree_leaves  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.optim import cosine_warmup, make_optimizer  # noqa: E402
from repro_torch.parallel import ef_compressed_psum, init_ef_state, quant_int8  # noqa: E402
from repro_torch.parallel.sharding import distribute, distribute_tree, full_tree, resolve_tree, rules_for  # noqa: E402
from repro_torch.training import init_dp_state, init_train_state, make_dp_train_step, make_train_step  # noqa: E402
from repro_torch.training import TrainGraph, train_state_logical  # noqa: E402

# Kernel and plain version both accumulate in f32 and round once at the end,
# so a bf16 output may differ by one rounding step (8 significant bits)
ATTN_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4), torch.bfloat16: dict(atol=1e-3, rtol=2**-7)}
# the library yardstick only has to compute the same function: in bf16 it
# rounds its probabilities before the second product
LIBRARY_ATTN_TOL = {**ATTN_TOL, torch.bfloat16: dict(atol=0.05, rtol=0.0)}
# bf16 RMSNorm: atol 0.05 plus one bf16 rounding step relative (8 significant bits)
NORM_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5), torch.bfloat16: dict(atol=0.05, rtol=2**-7)}
# ROADMAP's tolerances: LRU 1e-5, WKV atol 5e-4 / rtol 1e-3 (f32); a bf16
# output may differ by one rounding step of its own (8 significant bits)
LRU_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5), torch.bfloat16: dict(atol=0.05, rtol=2**-7)}
WKV_TOL = {torch.float32: dict(atol=5e-4, rtol=1e-3), torch.bfloat16: dict(atol=0.05, rtol=2**-7)}

KERNEL_INFO = {
    # K1 has eight kernels: bf16 on the tensor cores, bf16 at (96, 64), and
    # f32 on the tensor cores as 3xTF32 at (64, 64), (96, 64), (128, 128),
    # (128, 64), (64, 128) and (256, 256), the last a cluster of two blocks
    "flash_attention_bf16": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:111",
    ),
    # the bf16 MLA kernel at (d, dv) = (96, 64), MLA's prefill
    "flash_attention_bf16_mla": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:111",
    ),
    "flash_attention_tf32": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:111",
    ),
    # the f32 (3xTF32) MLA kernel at (d, dv) = (96, 64)
    "flash_attention_tf32_mla": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:111",
    ),
    # the f32 (3xTF32) kernels whose K and V come split, 16-key tiles:
    # (128, 128), (128, 64), (64, 128), and (256, 256) on a cluster of two
    # blocks that split the head dims
    "flash_attention_tf32_d128": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:111",
    ),
    "flash_attention_tf32_d128_dv64": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:111",
    ),
    "flash_attention_tf32_d64_dv128": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:111",
    ),
    "flash_attention_tf32_d256": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:111",
    ),
    "rmsnorm": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:34",
    ),
    "lru_scan": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:56",
    ),
    "wkv6": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        replaces="src/repro/kernels/rwkv6_scan.py:90",
    ),
    "moe_gating": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/moe_gating.cu",
        replaces="src/repro/kernels/moe_gating.py:72",
    ),
}
# kernel: (wrapper module, its launch counter)
COUNTERS = {"flash_attention_bf16": (fa_kernel, "bf16_launches"),
            "flash_attention_bf16_mla": (fa_kernel, "bf16_mla_launches"),
            "flash_attention_tf32": (fa_kernel, "tf32_launches"),
            "flash_attention_tf32_mla": (fa_kernel, "tf32_mla_launches"),
            "flash_attention_tf32_d128": (fa_kernel, "tf32_d128_launches"),
            "flash_attention_tf32_d128_dv64": (fa_kernel, "tf32_d128_dv64_launches"),
            "flash_attention_tf32_d64_dv128": (fa_kernel, "tf32_d64_dv128_launches"),
            "flash_attention_tf32_d256": (fa_kernel, "tf32_d256_launches"), "rmsnorm": (rn_kernel, "launches"),
            "rmsnorm_generic": (rn_kernel, "generic_launches"),
            "lru_scan": (lru_kernel, "launches"), "wkv6": (wkv_kernel, "launches"),
            "moe_gating": (gating_kernel, "launches"), "moe_gating_slots": (gating_kernel, "slots_launches")}
# the phase-3 case whose numbers stand for each attention kernel in the JSON
# line: a shape a main path gives it (the kernels on no main path: f32 at
# Griffin's d 256, and the mixed pairs at 2 x 16 heads x 1024, causal)
ATTN_JSON_CASE = {"flash_attention_bf16": "deepseek_prefill",
                  "flash_attention_bf16_mla": "mla_prefill", "flash_attention_tf32": "nbi100m_prefill",
                  "flash_attention_tf32_mla": "mla_f32_insert", "flash_attention_tf32_d128": "codeqwen_f32_insert",
                  "flash_attention_tf32_d128_dv64": "f32_d128_dv64", "flash_attention_tf32_d64_dv128": "f32_d64_dv128",
                  "flash_attention_tf32_d256": "d256_f32"}
# a part of each kernel's name as the profiler shows it; a kernel goes to the
# first name it matches
TRACE_NAMES = {"flash_attention_bf16_mla": "flash_attn_bf16_mla_kernel",
               "flash_attention_bf16": "flash_attn_bf16_kernel",
               "flash_attention_tf32_mla": "flash_attn_tf32_mla_kernel",
               "flash_attention_tf32_d128": "flash_attn_tf32_d128_kernel",
               "flash_attention_tf32_d128_dv64": "flash_attn_tf32_d128_dv64_kernel",
               "flash_attention_tf32_d64_dv128": "flash_attn_tf32_d64_dv128_kernel",
               "flash_attention_tf32_d256": "flash_attn_tf32_d256_kernel",
               "flash_attention_tf32": "flash_attn_tf32_kernel", "rmsnorm": "rmsnorm_",
               "lru_scan": "lru_scan_kernel", "wkv6": "wkv6_kernel", "moe_gating": "moe_gating_"}


def by_trace_name(kernels, value) -> dict:
    """The sum of ``value(entry)`` over the profiler's kernel entries of each
    of the port's kernels, each entry counted once, under the first name it
    matches."""
    out = dict.fromkeys(TRACE_NAMES, 0)
    for e in kernels:
        name = next((n for n, part in TRACE_NAMES.items() if part in e.key), None)
        if name:
            out[name] += value(e)
    return out


def trace_shares(kernels) -> dict:
    """Device ms of each of the port's kernels in a trace."""
    return by_trace_name(kernels, lambda e: e.self_device_time_total / 1e3)


def trace_calls(kernels) -> dict:
    """Calls of each of the port's kernels in a trace."""
    return by_trace_name(kernels, lambda e: e.count)


def launched_kernels(launches: dict) -> dict:
    """The kernel calls a trace shows for the counters' ``launches``, under
    :data:`TRACE_NAMES`: a call of the gating with more than one tile a group
    runs the slots kernel too, and the RMSNorm's generic path is one of its
    ``rmsnorm_`` kernels."""
    calls = {name: launches[name] for name in TRACE_NAMES}
    calls["moe_gating"] += launches["moe_gating_slots"]
    return calls


def check_trace(what: str, kernels, launches: dict, attempt: int) -> bool:
    """Whether the port's kernels in a trace (the profiler's kernel entries)
    equal the counters' ``launches`` of the traced work, by name
    (:func:`trace_calls`, :func:`launched_kernels`); raises at the last of
    TRACE_TRIES attempts (the profiler can lose a record)."""
    want, seen = launched_kernels(launches), trace_calls(kernels)
    say(f"[trace] {what}, run {attempt}: the port's kernels in the trace { {k: n for k, n in seen.items() if n} } "
        f"(by the counters { {k: n for k, n in want.items() if n} })")
    if seen != want and attempt == TRACE_TRIES:
        raise AssertionError(f"{what}: the trace shows the port's kernels {seen}, the counters {want}")
    return seen == want


def profiled(device, acts: list, run):
    """``run()`` under torch.profiler recording ``acts``, PROFILER_LEAD_S
    after the profiler starts and behind PROFILER_LEAD_KERNELS empty
    kernels (``torch.cuda._sleep``, left out of the entries): traces of
    nbi-100m's train step on an H100 lost the records of their first
    kernels, from 1 to the 100 of the step's first two layers, also after a
    warm-up cycle of the profiler or 0.1 s into it. Returns the profiler's
    kernel entries and what ``run()`` returned."""
    from torch.profiler import profile

    with profile(activities=acts) as prof:
        time.sleep(PROFILER_LEAD_S)
        if device.type == "cuda":
            for _ in range(PROFILER_LEAD_KERNELS):
                torch.cuda._sleep(1)
            sync(device)
        out = run()
    return [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA") and LEAD_KERNEL not in e.key], out


def say(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Mean device time of one call in ms. On the card the calls are captured
    in a CUDA graph and the graph is replayed between two CUDA events, so the
    Python wrappers' host time, which exceeds a small kernel's device time, is
    not what is measured. In a CPU rehearsal: the host clock."""

    def __init__(self, device: torch.device):
        self.device = device

    def __call__(self, fn, iters: int, warmup: int = 3, replays: int = 3) -> float:
        if self.device.type != "cuda":
            for _ in range(warmup):
                fn()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) * 1e3 / iters
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up off the default stream before capture
            for _ in range(warmup):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / (replays * iters)
        del graph
        return ms


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def within(got, want, atol: float, rtol: float) -> bool:
    err = (got.float() - want.float()).abs()
    return bool(torch.isfinite(got.float()).all()) and not bool((err > atol + rtol * want.float().abs()).any())


def check_close(got, want, atol: float, rtol: float, what: str) -> float:
    max_abs = float((got.float() - want.float()).abs().max())
    if not within(got, want, atol, rtol):
        raise AssertionError(f"{what}: kernel disagrees with its plain version (max abs err {max_abs})")
    return max_abs


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def attention_cases(full: bool):
    """(name, B, Hq, Hkv, Sq, Skv, d, dv, dtype, causal, window, logit_cap).
    The first four are shapes the main paths give the kernels: a 512-token
    prefill batch of nbi-100m, a 2304-token prefill batch of
    recurrentgemma-2b, a 2048-token prefill batch of deepseek-moe-16b and one
    of minicpm3-4b (MLA, q and k 96 wide, v 64); then the MLA kernel at a
    ragged Sq and Skv, under a window, at minicpm3-4b's 512-token batch and
    at 1088 rows (8.5 blocks: the last block's second warpgroup has no rows
    and takes nine turns without products beside the first's nine tiles),
    MLA's f32 pair as the continuous-batching phase's one-row inserts give it
    (a request of 1000, 512, 200 and 64 tokens) and at the 3xTF32 MLA
    kernel's edges (ragged, a window under its 32-key tiles, the cap, Skv one
    past a tile), f32 at (128, 128) as codeqwen1.5-7b's inserts of 1000, 512,
    200 and 64 tokens give it (32 heads) and at the 3xTF32 d 128 kernel's
    edges (ragged, a window over its 16-key tiles, the cap, Skv one past two
    tiles, 32 query heads over 8 KV heads as mistral's), f32 at Griffin's
    (256, 256) under its window (the 3xTF32 cluster kernel) and at (64, 128)
    and (128, 64) (2 x 16 heads x 1024, causal; on no main path), and edges of
    the bf16 kernel's TMA boxes and 64-key tiles
    at full size; last, the shapes the train paths and kimi-k2's serving give
    the bf16 kernels (deepseek-moe-16b's 4 x 2048, recurrentgemma-2b's MQA
    d 256 under its window at 2 x 2048, minicpm3-4b's MLA at (96, 64), 4 x
    40 heads x 2048, d 128 at starcoder2-7b's 36 heads over 4 and
    codeqwen1.5-7b's 32 over 32 at 4 x 2048, mistral-large-123b's 96 over 8
    at a microbatch of 1 x 2048 and llava-next-mistral-7b's 32 over 8 at 4 x
    2048 positions, kimi-k2's 64 over 8 heads at 8 x 1024); then
    whisper-small's bf16 d 64 kernel as its prefill batch of 8 gives it:
    the encoder over 1500 frames (ragged against the 128-row blocks and the
    64-key tiles), cross-attention from 384 prompt tokens over them,
    and the decoder's causal self-attention over the 384."""
    f32, bf16 = torch.float32, torch.bfloat16
    if not full:
        return [
            ("nbi100m_prefill", 2, 4, 4, 16, 16, 16, 16, f32, True, 0, 0.0),
            ("griffin_prefill", 2, 4, 1, 20, 20, 16, 16, bf16, True, 8, 0.0),
            ("deepseek_prefill", 2, 4, 4, 16, 16, 16, 16, bf16, True, 0, 0.0),
            ("mla_prefill", 2, 4, 4, 16, 16, 24, 16, bf16, True, 0, 0.0),
            ("mla_ragged", 1, 4, 4, 13, 40, 24, 16, bf16, False, 0, 0.0),
            ("mla_window", 1, 4, 4, 24, 24, 24, 16, bf16, True, 8, 0.0),
            ("mla_prefill_s512", 2, 4, 4, 12, 12, 24, 16, bf16, True, 0, 0.0),
            ("mla_unequal_turns", 1, 4, 4, 17, 17, 24, 16, bf16, True, 0, 0.0),
            ("mla_f32_insert", 1, 4, 4, 20, 20, 24, 16, f32, True, 0, 0.0),
            ("mla_f32_insert_s512", 1, 4, 4, 12, 12, 24, 16, f32, True, 0, 0.0),
            ("mla_f32_insert_s200", 1, 4, 4, 8, 8, 24, 16, f32, True, 0, 0.0),
            ("mla_f32_insert_s64", 1, 4, 4, 5, 5, 24, 16, f32, True, 0, 0.0),
            ("mla_f32_ragged", 1, 4, 4, 13, 40, 24, 16, f32, False, 0, 0.0),
            ("mla_f32_window", 1, 4, 4, 24, 24, 24, 16, f32, True, 3, 0.0),
            ("mla_f32_logit_cap", 1, 4, 4, 16, 16, 24, 16, f32, True, 0, 30.0),
            ("mla_f32_skv33", 1, 4, 4, 12, 9, 24, 16, f32, False, 0, 0.0),
            ("codeqwen_f32_insert", 1, 4, 4, 20, 20, 16, 16, f32, True, 0, 0.0),
            ("codeqwen_f32_insert_s512", 1, 4, 4, 12, 12, 16, 16, f32, True, 0, 0.0),
            ("codeqwen_f32_insert_s200", 1, 4, 4, 8, 8, 16, 16, f32, True, 0, 0.0),
            ("codeqwen_f32_insert_s64", 1, 4, 4, 5, 5, 16, 16, f32, True, 0, 0.0),
            ("codeqwen_f32_ragged", 1, 4, 4, 13, 40, 16, 16, f32, False, 0, 0.0),
            ("codeqwen_f32_window", 1, 4, 4, 24, 24, 16, 16, f32, True, 3, 0.0),
            ("codeqwen_f32_logit_cap", 1, 4, 4, 16, 16, 16, 16, f32, True, 0, 30.0),
            ("codeqwen_f32_skv33", 1, 4, 4, 12, 9, 16, 16, f32, False, 0, 0.0),
            ("codeqwen_f32_gqa", 1, 8, 2, 20, 20, 16, 16, f32, True, 0, 0.0),
            ("d256_f32", 1, 2, 1, 12, 12, 16, 16, f32, True, 4, 0.0),
            ("f32_d64_dv128", 1, 4, 4, 12, 12, 8, 16, f32, True, 0, 0.0),
            ("f32_d128_dv64", 1, 4, 4, 12, 12, 16, 8, f32, True, 0, 0.0),
            ("gqa_bf16", 1, 8, 2, 24, 24, 16, 16, bf16, True, 0, 0.0),
            ("ragged", 1, 4, 4, 13, 13, 16, 16, f32, True, 0, 0.0),
            ("window", 1, 4, 4, 24, 24, 16, 16, f32, True, 8, 0.0),
            ("logit_cap", 1, 4, 4, 16, 16, 16, 16, f32, True, 0, 30.0),
            ("non_causal", 1, 4, 4, 10, 20, 16, 16, f32, False, 0, 0.0),
            ("ragged_non_causal_bf16", 1, 4, 4, 13, 40, 16, 16, bf16, False, 0, 0.0),
            ("mqa_d256_window_bf16", 1, 4, 1, 23, 23, 16, 16, bf16, True, 8, 0.0),
            ("deepseek_train", 2, 4, 4, 32, 32, 16, 16, bf16, True, 0, 0.0),
            ("griffin_train", 2, 4, 1, 16, 16, 16, 16, bf16, True, 8, 0.0),
            ("mla_train", 2, 4, 4, 32, 32, 24, 16, bf16, True, 0, 0.0),
            ("starcoder_train", 2, 9, 1, 32, 32, 16, 16, bf16, True, 0, 0.0),
            ("codeqwen_train", 2, 4, 4, 32, 32, 16, 16, bf16, True, 0, 0.0),
            ("mistral_train", 1, 12, 1, 32, 32, 16, 16, bf16, True, 0, 0.0),
            ("llava_train", 2, 8, 2, 32, 32, 16, 16, bf16, True, 0, 0.0),
            ("kimi_prefill", 2, 8, 2, 32, 32, 16, 16, bf16, True, 0, 0.0),
            ("whisper_encoder", 2, 4, 4, 24, 24, 16, 16, bf16, False, 0, 0.0),
            ("whisper_cross", 2, 4, 4, 12, 24, 16, 16, bf16, False, 0, 0.0),
            ("whisper_decoder_prefill", 2, 4, 4, 12, 12, 16, 16, bf16, True, 0, 0.0),
        ]
    return [
        ("nbi100m_prefill", 8, 12, 12, 512, 512, 64, 64, f32, True, 0, 0.0),
        ("griffin_prefill", 8, 10, 1, 2304, 2304, 256, 256, bf16, True, 2048, 0.0),
        ("deepseek_prefill", 8, 16, 16, 2048, 2048, 128, 128, bf16, True, 0, 0.0),
        ("mla_prefill", 8, 40, 40, 2048, 2048, 96, 64, bf16, True, 0, 0.0),
        ("mla_ragged", 2, 40, 40, 333, 1000, 96, 64, bf16, False, 0, 0.0),
        ("mla_window", 2, 40, 40, 1500, 1500, 96, 64, bf16, True, 512, 0.0),
        ("mla_prefill_s512", 8, 40, 40, 512, 512, 96, 64, bf16, True, 0, 0.0),
        ("mla_unequal_turns", 2, 40, 40, 1088, 1088, 96, 64, bf16, True, 0, 0.0),
        ("mla_f32_insert", 1, 40, 40, 1000, 1000, 96, 64, f32, True, 0, 0.0),
        ("mla_f32_insert_s512", 1, 40, 40, 512, 512, 96, 64, f32, True, 0, 0.0),
        ("mla_f32_insert_s200", 1, 40, 40, 200, 200, 96, 64, f32, True, 0, 0.0),
        ("mla_f32_insert_s64", 1, 40, 40, 64, 64, 96, 64, f32, True, 0, 0.0),
        ("mla_f32_ragged", 2, 40, 40, 333, 1000, 96, 64, f32, False, 0, 0.0),
        ("mla_f32_window", 1, 40, 40, 1000, 1000, 96, 64, f32, True, 20, 0.0),
        ("mla_f32_logit_cap", 1, 40, 40, 257, 257, 96, 64, f32, True, 0, 30.0),
        ("mla_f32_skv33", 2, 40, 40, 129, 33, 96, 64, f32, False, 0, 0.0),
        ("codeqwen_f32_insert", 1, 32, 32, 1000, 1000, 128, 128, f32, True, 0, 0.0),
        ("codeqwen_f32_insert_s512", 1, 32, 32, 512, 512, 128, 128, f32, True, 0, 0.0),
        ("codeqwen_f32_insert_s200", 1, 32, 32, 200, 200, 128, 128, f32, True, 0, 0.0),
        ("codeqwen_f32_insert_s64", 1, 32, 32, 64, 64, 128, 128, f32, True, 0, 0.0),
        ("codeqwen_f32_ragged", 2, 32, 32, 333, 1000, 128, 128, f32, False, 0, 0.0),
        ("codeqwen_f32_window", 1, 32, 32, 1000, 1000, 128, 128, f32, True, 20, 0.0),
        ("codeqwen_f32_logit_cap", 1, 32, 32, 257, 257, 128, 128, f32, True, 0, 30.0),
        ("codeqwen_f32_skv33", 2, 32, 32, 129, 33, 128, 128, f32, False, 0, 0.0),
        ("codeqwen_f32_gqa", 1, 32, 8, 1000, 1000, 128, 128, f32, True, 0, 0.0),
        ("d256_f32", 2, 10, 1, 1024, 1024, 256, 256, f32, True, 512, 0.0),
        ("f32_d64_dv128", 2, 16, 16, 1024, 1024, 64, 128, f32, True, 0, 0.0),
        ("f32_d128_dv64", 2, 16, 16, 1024, 1024, 128, 64, f32, True, 0, 0.0),
        ("gqa_bf16_s2048", 1, 32, 8, 2048, 2048, 128, 128, bf16, True, 0, 0.0),
        ("ragged_s300", 2, 12, 12, 300, 300, 64, 64, f32, True, 0, 0.0),
        ("window_128", 2, 12, 12, 512, 512, 64, 64, f32, True, 128, 0.0),
        ("logit_cap_30", 2, 12, 12, 512, 512, 64, 64, f32, True, 0, 30.0),
        ("non_causal_sq200_skv512", 2, 12, 12, 200, 512, 64, 64, f32, False, 0, 0.0),
        ("ragged_non_causal_bf16", 2, 16, 16, 333, 1000, 128, 128, bf16, False, 0, 0.0),
        ("mqa_d256_window_bf16", 2, 10, 1, 2300, 2300, 256, 256, bf16, True, 2048, 0.0),
        ("deepseek_train", 4, 16, 16, 2048, 2048, 128, 128, bf16, True, 0, 0.0),
        ("griffin_train", 2, 10, 1, 2048, 2048, 256, 256, bf16, True, 2048, 0.0),
        ("mla_train", 4, 40, 40, 2048, 2048, 96, 64, bf16, True, 0, 0.0),
        ("starcoder_train", 4, 36, 4, 2048, 2048, 128, 128, bf16, True, 0, 0.0),
        ("codeqwen_train", 4, 32, 32, 2048, 2048, 128, 128, bf16, True, 0, 0.0),
        ("mistral_train", 1, 96, 8, 2048, 2048, 128, 128, bf16, True, 0, 0.0),
        ("llava_train", 4, 32, 8, 2048, 2048, 128, 128, bf16, True, 0, 0.0),
        ("kimi_prefill", 8, 64, 8, 1024, 1024, 128, 128, bf16, True, 0, 0.0),
        ("whisper_encoder", 8, 12, 12, 1500, 1500, 64, 64, bf16, False, 0, 0.0),
        ("whisper_cross", 8, 12, 12, 384, 1500, 64, 64, bf16, False, 0, 0.0),
        ("whisper_decoder_prefill", 8, 12, 12, 384, 384, 64, 64, bf16, True, 0, 0.0),
    ]


def norm_cases(full: bool):
    """(name, rows, D, dtype); the first two are the main path's prefill and
    decode rows of nbi-100m, then deepseek-moe-16b's largest prefill and a
    decode step, minicpm3-4b's q_ln (768 wide) and kv_ln (256 wide) at its
    largest prefill and a decode step, and
    mistral-large-123b's largest prefill and a decode step at D 12288, the
    kernel's widest; then kimi-k2's largest prefill and a decode step at D
    7168, recurrentgemma-2b's train step (2 x 2048 rows at D 2560),
    minicpm3-4b's residual norms (D 2560) and starcoder2-7b's (D 4608) at
    their largest prefill, and last a D that is not a multiple of 8 (bf16),
    the generic path's."""
    f32, bf16 = torch.float32, torch.bfloat16
    if not full:
        return [("prefill_rows", 32, 64, f32), ("decode_rows", 2, 64, f32),
                ("bf16_wide", 16, 256, bf16), ("deepseek_prefill_rows", 64, 64, bf16),
                ("deepseek_decode_rows", 2, 64, bf16),
                ("mla_q_ln_prefill_rows", 32, 24, bf16), ("mla_kv_ln_prefill_rows", 32, 16, bf16),
                ("mla_q_ln_decode_rows", 2, 24, bf16), ("mla_kv_ln_decode_rows", 2, 16, bf16),
                ("mistral_large_prefill_rows", 32, 64, bf16), ("mistral_large_decode_rows", 2, 64, bf16),
                ("kimi_prefill_rows", 32, 64, bf16), ("kimi_decode_rows", 2, 64, bf16),
                ("griffin_train_rows", 64, 64, bf16), ("minicpm_prefill_rows", 64, 40, bf16),
                ("starcoder2_prefill_rows", 64, 72, bf16), ("generic_d1004", 7, 20, bf16)]
    return [("prefill_rows", 4096, 768, f32), ("decode_rows", 8, 768, f32),
            ("bf16_4096", 2048, 4096, bf16), ("deepseek_prefill_rows", 16384, 2048, bf16),
            ("deepseek_decode_rows", 8, 2048, bf16),
            ("mla_q_ln_prefill_rows", 16384, 768, bf16), ("mla_kv_ln_prefill_rows", 16384, 256, bf16),
            ("mla_q_ln_decode_rows", 8, 768, bf16), ("mla_kv_ln_decode_rows", 8, 256, bf16),
            ("mistral_large_prefill_rows", 8192, 12288, bf16), ("mistral_large_decode_rows", 8, 12288, bf16),
            ("kimi_prefill_rows", 8192, 7168, bf16), ("kimi_decode_rows", 8, 7168, bf16),
            ("griffin_train_rows", 4096, 2560, bf16), ("minicpm_prefill_rows", 16384, 2560, bf16),
            ("starcoder2_prefill_rows", 16384, 4608, bf16), ("generic_d1004", 7, 1004, bf16)]


def run_attention_cases(device, timer, full: bool, only=None) -> dict:
    """Every case's numbers (or those of the cases named in ``only``), by case
    name."""
    g = torch.Generator(device=device).manual_seed(0)
    rows = {}
    for name, B, Hq, Hkv, Sq, Skv, d, dv, dtype, causal, window, cap in attention_cases(full):
        if only is not None and name not in only:
            continue
        scale = 4.0 if cap else 1.0  # large logits so that the cap bites
        q = (torch.randn((B, Hq, Sq, d), generator=g, device=device) * scale).to(dtype)
        k = (torch.randn((B, Hkv, Skv, d), generator=g, device=device) * scale).to(dtype)
        v = torch.randn((B, Hkv, Skv, dv), generator=g, device=device).to(dtype)
        kw = dict(causal=causal, window=window, logit_cap=cap)
        got = ops.attention(q, k, v, **kw)
        sync(device)
        want = ref.attention_ref(q, k, v, **kw)
        sync(device)
        err = check_close(got, want, what=f"flash_attention[{name}]", **ATTN_TOL[dtype])
        past = ""
        if window and Skv > window:  # the limit must catch a kernel that attends past the window
            wide = ref.attention_ref(q, k, v, **{**kw, "window": window + 256})
            if within(wide, want, **ATTN_TOL[dtype]):
                raise AssertionError(f"flash_attention[{name}]: the limit cannot see the window")
            past = f" (256 keys past the window: {float((wide.float() - want.float()).abs().max()):.3e})"
            del wide
        ms = timer(lambda: ops.attention(q, k, v, **kw), iters=20)
        plain_ms = timer(lambda: ref.attention_ref(q, k, v, **kw), iters=5, warmup=1)
        library_ms = None
        if not cap:  # no single library call applies a tanh logit cap
            mask = None
            if window:
                q_pos = torch.arange(Sq, device=device)[:, None]
                k_pos = torch.arange(Skv, device=device)[None, :]
                mask = (k_pos <= q_pos) & (q_pos - k_pos < window)
            sdpa = dict(attn_mask=mask, is_causal=causal and mask is None, enable_gqa=Hq != Hkv)
            lib_out = F.scaled_dot_product_attention(q, k, v, **sdpa)
            check_close(lib_out, want, what=f"library attention[{name}]", **LIBRARY_ATTN_TOL[dtype])
            library_ms = timer(lambda: F.scaled_dot_product_attention(q, k, v, **sdpa), iters=20)
        sync(device)
        shape = (B, Hq, Hkv, Sq, Skv, d, dv, dtype, causal, window)
        flops, nbytes, _ = work = roofline.attention_work(*shape, kernel=False)
        bound_ms, bound_by = roofline.bound(work)
        bounds = ""
        if dtype == torch.float32:
            # the same function as three TF32 products on the tensor cores;
            # the tensor-core kernel is held against this bound
            tf32_ms, tf32_by = roofline.bound(roofline.attention_work(*shape))
            bounds = f" bound_f32_fma={bound_ms:.4f}ms ({bound_by}) bound_3xtf32={tf32_ms:.4f}ms ({tf32_by})"
            if fa_kernel.kernel_kind(dtype, d, dv) == fa_kernel.F32_TF32:
                bound_ms, bound_by = tf32_ms, tf32_by
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=library_ms)
        say(f"[kernels] flash_attention {name}: B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Skv={Skv} d={d} dv={dv} "
            f"{str(dtype).removeprefix('torch.')} causal={causal} window={window} cap={cap} | "
            f"max_abs_err={err:.3e}{past} kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
            f"library={'none' if library_ms is None else f'{library_ms:.4f}ms'} "
            f"bound={bound_ms:.4f}ms ({bound_by}){bounds} GFLOP={flops / 1e9:.3f} MB={nbytes / 1e6:.1f}")
        rows[name] = row
    return rows


def norm_launch_line(rows: int, D: int, dtype) -> str:
    c = rn_kernel.launch_config(rows, D, dtype)
    return (f"path={c['path']} team={c['team_warps']} warps vectors a thread={c['vectors_per_thread']} "
            f"threads={c['threads']} teams a block={c['teams']} blocks={c['blocks']} on {c['sms']} SMs, "
            f"{c['blocks_per_sm']} resident per SM, rows a team={c['rows_per_team']}"
            + (", x past L1 (larger than L2)" if c["stream_x"] else ""))


def run_norm_cases(device, timer, full: bool, only=None) -> dict:
    """Every case's numbers (or those of the cases named in ``only``), by case
    name. On the card each call must take the path ``launch_config`` names:
    the vector path at every width of 8 bf16 or 4 f32 values, the generic
    path otherwise."""
    g = torch.Generator(device=device).manual_seed(1)
    out = {}
    for name, rows, D, dtype in norm_cases(full):
        if only is not None and name not in only:
            continue
        x = torch.randn((rows, D), generator=g, device=device).to(dtype)
        w = 1.0 + 0.1 * torch.randn((D,), generator=g, device=device)
        generic_before = getattr(rn_kernel, "generic_launches", 0)
        got = ops.rmsnorm(x, w)
        sync(device)
        if device.type == "cuda" and hasattr(rn_kernel, "launch_config"):  # older trees (chip_variants.py): one path
            generic = rn_kernel.generic_launches - generic_before
            path = rn_kernel.launch_config(rows, D, dtype)["path"]
            if generic != (path == "generic") or (path == "generic") == rn_kernel.takes_vector_path(D, dtype):
                raise AssertionError(f"rmsnorm[{name}]: path {path}, generic launches {generic}")
        want = ref.rmsnorm_ref(x, w)
        sync(device)
        err = check_close(got, want, what=f"rmsnorm[{name}]", **NORM_TOL[dtype])
        ms = timer(lambda: ops.rmsnorm(x, w), iters=50)
        plain_ms = timer(lambda: ref.rmsnorm_ref(x, w), iters=20)
        w_lib = w.to(dtype)
        library_ms = timer(lambda: F.rms_norm(x, (D,), w_lib, eps=1e-6), iters=50)
        # the card's streaming rate at the same bytes: a copy of x into y (not
        # the same function: no library_ms)
        copy_ms = timer(lambda: got.copy_(x), iters=50)
        sync(device)
        _, nbytes, _ = work = roofline.rmsnorm_work(rows, D, dtype, w.element_size())
        bound_ms, bound_by = roofline.bound(work)
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=library_ms)
        say(f"[kernels] rmsnorm {name}: rows={rows} D={D} {str(dtype).removeprefix('torch.')} | "
            f"max_abs_err={err:.3e} kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
            f"library={library_ms:.4f}ms copy={copy_ms:.4f}ms bound={bound_ms:.4f}ms ({bound_by}) "
            f"{100 * bound_ms / ms:.1f}% of bound "
            f"MB={nbytes / 1e6:.2f}")
        out[name] = row
    return out


def lru_cases(full: bool):
    """(name, B, T, W, dtype). The first three are shapes recurrentgemma-2b's
    prefill gives the kernel (a, b f32, W 2560): a batch of 8 prompts of 2304
    tokens, one long prompt alone, and the batch of 8 prompts of 256 tokens
    that the main path serves; then bf16 rows that are 4-byte but not
    16-byte aligned (W 2500), which take the 4-byte copies; last, its train
    step's 2 x 2048 (the only case at 32-wide tiles)."""
    f32, bf16 = torch.float32, torch.bfloat16
    if not full:
        return [("griffin_prefill", 2, 20, 64, f32), ("griffin_prefill_b1", 1, 40, 64, f32),
                ("griffin_prefill_s256", 2, 8, 64, f32), ("bf16_ragged", 1, 13, 40, bf16),
                ("griffin_train", 2, 16, 64, f32)]
    return [("griffin_prefill", 8, 2304, 2560, f32), ("griffin_prefill_b1", 1, 2304, 2560, f32),
            ("griffin_prefill_s256", 8, 256, 2560, f32), ("bf16_ragged", 4, 1001, 2500, bf16),
            ("griffin_train", 2, 2048, 2560, f32)]


def lru_launch_line(B: int, T: int, W: int, dtype) -> str:
    c = lru_kernel.launch_config(B, T, W, dtype)
    return (f"WT={c['tile']} steps a stage={c['steps']} stages={c['stages']} threads={c['threads']} "
            f"smem={c['smem_bytes']} B blocks={c['blocks']} on {c['sms']} SMs, {c['blocks_per_sm']} resident "
            f"per SM, {c['path']}, {c['in_flight_bytes'] / 2**20:.2f} MiB of a and b in flight")


# input sets each timed K3 call cycles over, so that CUDA-graph replays of
# cases near the 50 MB L2 read their inputs from device memory
LRU_INPUT_SETS = 3


def run_lru_cases(device, timer, full: bool) -> dict:
    """Each case against the plain version, to the bit and within LRU_TOL,
    then timed over LRU_INPUT_SETS input sets in turn."""
    g = torch.Generator(device=device).manual_seed(3)
    first = None
    for name, B, T, W, dtype in lru_cases(full):
        sets = [((0.5 + 0.499 * torch.rand((B, T, W), generator=g, device=device)).to(dtype),
                 torch.randn((B, T, W), generator=g, device=device).to(dtype),
                 torch.randn((B, W), generator=g, device=device))  # nonzero carried state
                for _ in range(LRU_INPUT_SETS)]
        a, b, h0 = sets[0]
        got_h, got_last = ops.lru_scan(a, b, h0)
        sync(device)
        want_h, want_last = ref.lru_ref(a, b, h0)
        sync(device)
        err = max(check_close(got_h, want_h, what=f"lru_scan[{name}]", **LRU_TOL[dtype]),
                  check_close(got_last, want_last, what=f"lru_scan[{name}] h_final", **LRU_TOL[torch.float32]))
        if not (torch.equal(got_h, want_h) and torch.equal(got_last, want_last)):
            raise AssertionError(f"lru_scan[{name}]: kernel differs from its plain version (max abs err "
                                 f"{err}); the two round the same operations in the same order")
        turns = itertools.cycle(sets)
        ms = timer(lambda: ops.lru_scan(*next(turns)), iters=7 * LRU_INPUT_SETS)
        plain_ms = timer(lambda: ref.lru_ref(a, b, h0), iters=1, warmup=1)
        # the card's streaming rate at the same bytes: a + b reads a and b and
        # writes one array like them (not the same function: no library_ms)
        stream_ms = timer(lambda: torch.add(*next(turns)[:2]), iters=7 * LRU_INPUT_SETS)
        sync(device)
        _, nbytes, _ = work = roofline.lru_work(B, T, W, dtype)
        bound_ms, bound_by = roofline.bound(work)
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=None)
        say(f"[kernels] lru_scan {name}: B={B} T={T} W={W} {str(dtype).removeprefix('torch.')} h0 nonzero | "
            f"bit-exact, max_abs_err={err:.3e} kernel={ms:.4f}ms plain={plain_ms:.4f}ms library=none "
            f"a+b={stream_ms:.4f}ms "
            f"bound={bound_ms:.4f}ms ({bound_by}) {100 * bound_ms / ms:.1f}% of bound MB={nbytes / 1e6:.1f}")
        first = first or row
    return first


def wkv_cases(full: bool):
    """(name, B, H, T, d, dtype, nonzero s0); the first is the RWKV-6 prefill,
    the last rwkv6-7b's train step (4 x 2048)."""
    if not full:
        return [("rwkv6_prefill", 2, 4, 24, 16, torch.bfloat16, False),
                ("f32_s0", 1, 2, 13, 16, torch.float32, True),
                ("rwkv6_long_s0", 1, 2, 40, 16, torch.bfloat16, True),
                ("rwkv6_train", 2, 4, 32, 16, torch.bfloat16, False)]
    return [("rwkv6_prefill", 8, 64, 1024, 64, torch.bfloat16, False),
            ("f32_s0_ragged", 2, 64, 300, 64, torch.float32, True),
            # a long prompt from a carried state: f32 drift over T held by WKV_TOL
            ("rwkv6_long_s0", 2, 64, 4096, 64, torch.bfloat16, True),
            ("rwkv6_train", 4, 64, 2048, 64, torch.bfloat16, False)]


def run_wkv_cases(device, timer, full: bool) -> dict:
    g = torch.Generator(device=device).manual_seed(4)
    first = None
    for name, B, H, T, d, dtype, carried in wkv_cases(full):
        r, k, v = ((0.5 * torch.randn((B, H, T, d), generator=g, device=device)).to(dtype) for _ in range(3))
        # decays in (0, 1), as exp(-exp(w0 + lora)) gives them
        w = torch.exp(-torch.exp(0.5 * torch.randn((B, H, T, d), generator=g, device=device) - 1.0)).to(dtype)
        u = 0.5 * torch.randn((H, d), generator=g, device=device)
        s0 = (0.5 * torch.randn((B, H, d, d), generator=g, device=device) if carried
              else torch.zeros((B, H, d, d), device=device))
        got_y, got_s = ops.wkv6(r, k, v, w, u, s0)
        sync(device)
        want_y, want_s = ref.wkv6_ref(r, k, v, w, u, s0)
        sync(device)
        err = max(check_close(got_y, want_y, what=f"wkv6[{name}]", **WKV_TOL[dtype]),
                  check_close(got_s, want_s, what=f"wkv6[{name}] state", **WKV_TOL[torch.float32]))
        ms = timer(lambda: ops.wkv6(r, k, v, w, u, s0), iters=10)
        plain_ms = timer(lambda: ref.wkv6_ref(r, k, v, w, u, s0), iters=1, warmup=1)
        sync(device)
        flops, nbytes, _ = work = roofline.wkv6_work(B, H, T, d, dtype)
        bound_ms, bound_by = roofline.bound(work)
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=None)
        say(f"[kernels] wkv6 {name}: B={B} H={H} T={T} d={d} {str(dtype).removeprefix('torch.')} "
            f"s0 {'nonzero' if carried else 'zero'} | max_abs_err={err:.3e} kernel={ms:.4f}ms "
            f"plain={plain_ms:.4f}ms library=none bound={bound_ms:.4f}ms ({bound_by}) "
            f"GFLOP={flops / 1e9:.3f} MB={nbytes / 1e6:.1f}")
        first = first or row
    return first


def gating_cases(full: bool):
    """(name, G, N, E, k, capacity, logit scale, expert skew, everyone wants
    expert 0). The first three are the shapes deepseek-moe-16b's path gives
    the kernels (its largest prefill, 8 rows of 2048 tokens in 16 groups; one
    group, as 8 rows of 128 tokens give; and a decode step of 8 rows) at the
    router's logit scale at full width (about 0.1); then groups of several
    tiles with N off every tile and drops, an odd shape whose popular experts
    drop picks, kimi-k2's routing widths, and every token wanting expert 0;
    last, deepseek-moe-16b's train step (4 x 2048 tokens in 8 groups) and
    kimi-k2's largest prefill (8 x 1024 tokens in 32 groups of 256) and a
    decode step of 8 rows."""
    if not full:
        return [("deepseek_prefill", 2, 32, 8, 2, 10, 0.1, 0.0, False),
                ("deepseek_prefill_g1", 1, 32, 8, 2, 10, 0.1, 0.0, False),
                ("deepseek_decode", 1, 2, 8, 2, 4, 0.1, 0.0, False),
                ("odd_drops", 3, 20, 40, 3, 3, 1.0, 1.0, False),
                ("kimi_routing", 2, 16, 40, 4, 4, 1.0, 0.0, False),
                ("everyone_expert_0", 1, 32, 8, 1, 5, 0.1, 0.0, True),
                ("deepseek_train", 2, 32, 8, 2, 10, 0.1, 0.0, False),
                ("kimi_prefill", 4, 16, 40, 4, 4, 0.1, 0.0, False),
                ("kimi_decode", 1, 2, 40, 4, 4, 0.1, 0.0, False)]
    return [("deepseek_prefill", 16, 1024, 64, 6, 120, 0.1, 0.0, False),
            ("deepseek_prefill_g1", 1, 1024, 64, 6, 120, 0.1, 0.0, False),
            ("deepseek_decode", 1, 8, 64, 6, 4, 0.1, 0.0, False),
            ("ragged_tiles_drops", 3, 1000, 64, 6, 94, 1.0, 1.0, False),
            ("odd_drops", 3, 100, 160, 8, 13, 1.0, 1.0, False),
            ("kimi_routing", 4, 256, 384, 8, math.ceil(8 * 256 / 384 * 1.25), 1.0, 0.0, False),
            ("everyone_expert_0", 2, 1024, 64, 6, 120, 0.1, 0.0, True),
            ("deepseek_train", 8, 1024, 64, 6, 120, 0.1, 0.0, False),
            ("kimi_prefill", 32, 256, 384, 8, math.ceil(8 * 256 / 384 * 1.25), 0.1, 0.0, False),
            ("kimi_decode", 1, 8, 384, 8, 4, 0.1, 0.0, False)]


def run_gating_cases(device, timer, full: bool) -> dict:
    g = torch.Generator(device=device).manual_seed(5)
    first = None
    for name, G, N, E, k, cap, scale, skew, all_zero in gating_cases(full):
        x = scale * torch.randn((G, N, E), generator=g, device=device)
        x += skew * torch.randn((E,), generator=g, device=device)
        if all_zero:
            x[..., 0] += 10.0
        got = ops.moe_gating(x, top_k=k, capacity=cap)
        sync(device)
        want = ref.moe_gating_ref(x, top_k=k, capacity=cap)
        sync(device)
        for part, a, b in zip(("idx", "pos"), got[::2], want[::2]):
            if not torch.equal(a, b):
                bad = (a != b).nonzero()[0].tolist()
                row = torch.softmax(x[bad[0], bad[1]], -1)
                raise AssertionError(f"moe_gating[{name}]: {part} differs at {bad}: kernel {a[tuple(bad)]}, "
                                     f"plain {b[tuple(bad)]}; probabilities {row[a[bad[0], bad[1]].long()].tolist()} "
                                     f"against {row[b[bad[0], bad[1]].long()].tolist()}")
        err = check_close(got[1], want[1], atol=1e-6, rtol=0.0, what=f"moe_gating[{name}] gate")
        pos = got[2]
        dropped = int((pos < 0).sum())
        if skew and not dropped:
            raise AssertionError(f"moe_gating[{name}]: no pick was dropped")
        if all_zero:
            first_rank = pos[..., 0]
            expect = torch.where(torch.arange(N, device=device) < cap, torch.arange(N, device=device), -1)
            if not (bool((got[0][..., 0] == 0).all()) and torch.equal(first_rank, expect.int().expand(G, N))):
                raise AssertionError(f"moe_gating[{name}]: expert 0 did not keep exactly slots 0..{cap - 1}")
        ms = timer(lambda: ops.moe_gating(x, top_k=k, capacity=cap), iters=50)
        plain_ms = timer(lambda: ref.moe_gating_ref(x, top_k=k, capacity=cap), iters=5, warmup=1)
        sync(device)
        _, nbytes, _ = work = roofline.moe_gating_work(G, N, E, k)
        bound_ms, bound_by = roofline.bound(work)
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=None)
        say(f"[kernels] moe_gating {name}: G={G} N={N} E={E} k={k} capacity={cap} logit scale={scale} "
            f"skew={skew} | idx and pos exact, {dropped} of {pos.numel()} picks dropped, gate max_abs_err="
            f"{err:.3e} kernel={ms:.4f}ms plain={plain_ms:.4f}ms library=none bound={bound_ms:.4g}ms "
            f"({bound_by}) bytes={nbytes}")
        first = first or row
    return first


def gating_launch_line() -> str:
    """Route and slots launches at deepseek-moe-16b's prefill group (1024
    tokens) and decode step (8), as the library reports them."""
    parts = []
    for what, N in (("prefill", 1024), ("decode", 8)):
        c = gating_kernel.launch_config(N, 64, 6)
        parts.append(f"{what} N={N}: {c['tiles']} tiles, " + ", ".join(
            f"{kernel} {c[kernel]['threads']} threads {c[kernel]['registers']} registers "
            f"{c[kernel]['smem_bytes']} B smem {c[kernel]['blocks_per_sm']} blocks per SM"
            for kernel in ("route", "slots") if kernel == "route" or c["tiles"] > 1))
    return "; ".join(parts)


# ---------------------------------------------------------------------------
# Phase 4: the main paths
# ---------------------------------------------------------------------------

# arch: (engine batch, prompt lengths, generated tokens, law S) at full size,
# and the same in the CPU rehearsal at smoke size
PATHS = {
    "nbi-100m": ((8, (128, 384, 512), 32, 128), (2, (8, 12, 16), 4, 12)),
    # 2304 > window 2048: those prompts wrap the ring cache
    "recurrentgemma-2b": ((8, (256, 1024, 2304), 32, 2100), (2, (6, 12, 20), 4, 12)),
    "rwkv6-7b": ((8, (128, 512, 1024), 32, 200), (2, (8, 16, 24), 4, 13)),
    # batches of 8 rows of these lengths split into whole groups of 1024
    # tokens (at the smoke size, 2 rows into groups of 32)
    "deepseek-moe-16b": ((8, (128, 1024, 2048), 32, 200), (2, (8, 16, 32), 4, 12)),
    # groups of 256 tokens (E 384, top-8): 8 rows of each length split into
    # whole groups; the law's 2 x 100 and 2 x 101 tokens are one group each
    "kimi-k2-1t-a32b": ((8, (128, 512, 1024), 32, 100), (2, (16, 32), 4, 12)),
    "minicpm3-4b": ((8, (128, 512, 2048), 32, 200), (2, (8, 12, 16), 4, 12)),
    "starcoder2-7b": ((8, (128, 1024, 2048), 32, 200), (2, (8, 12, 16), 4, 12)),
    "mistral-large-123b": ((8, (128, 1024), 32, 200), (2, (8, 16), 4, 12)),
    # the longest request, 384 + 32 tokens, within Whisper's 448-token
    # decoder context; every prefill batch encodes 8 x 1500 zero frames
    "whisper-small": ((8, (32, 128, 384), 32, 200), (2, (6, 8, 12), 4, 10)),
}
# paths served at full width and reduced depth: arch: layers (mistral-large-123b's
# 88 layers of bf16 weights, about 245 GB, do not fit one card; 8 take about 24 GB.
# kimi-k2-1t-a32b's 61 layers are about 1.03 T parameters; its leading dense
# layer and one MoE layer of 384 experts are 19.97 B, about 40 GB in bf16).
# minicpm3-4b (serving and continuous batching), deepseek-moe-16b and rwkv6-7b
# are cut to keep the script near 480 s with phase 5's data-parallel and
# eco-preemption legs: their decode is host-bound, so a path's time grows
# with its depth (minicpm3-4b's two phases took 116 s at 62 layers);
# codeqwen1.5-7b (continuous batching) and starcoder2-7b, 32 layers each,
# are cut for the mesh leg's full-width cases
REDUCED_DEPTH = {"mistral-large-123b": 8, "kimi-k2-1t-a32b": 2, "minicpm3-4b": 16, "deepseek-moe-16b": 8,
                 "rwkv6-7b": 8, "codeqwen1.5-7b": 8, "starcoder2-7b": 8}
# the visual-prefix path, through the model's functions (the engine feeds no
# patches, as the reference's): batch, text lengths, generated tokens, law's
# text length, at full size and in the CPU rehearsal
LLAVA_ARCH = "llava-next-mistral-7b"
LLAVA_RUN = {True: (8, (128, 512), 32, 64), False: (2, (8, 12), 4, 8)}
# continuous batching: arch: (slots, prompt lengths of the 16 requests, generated
# tokens) at full size and in the CPU rehearsal; f32 activations
CONTINUOUS = {
    "minicpm3-4b": ((8, (64, 200, 512, 1000), 32), (2, (5, 8, 12), 4)),
    "nbi-100m": ((8, (32, 100, 256, 500), 32), (2, (5, 8, 12), 4)),
    # full width, 8 of its 32 layers (REDUCED_DEPTH): 32 heads of 128, an
    # f32 cache of 8 x 1032 tokens (2.16 GB)
    "codeqwen1.5-7b": ((8, (64, 200, 512, 1000), 32), (2, (5, 8, 12), 4)),
}


# the graph-against-eager leg: decode steps each way in turns, then steps
# each way under the profiler, at full size and in the CPU rehearsal (4 in
# turns since the mesh engines' 9 legs joined phase 4's 12: the script's time)
GRAPH_LEG = {True: (4, 4), False: (2, 2)}
# traced runs of one batch before its kernel calls must equal the counters':
# the profiler at times loses a kernel's record (on an H100, one of the 16
# RMSNorm records of an 8 x 2048 prefill in one of four traced runs of it)
TRACE_TRIES = 3
# host seconds and empty kernels between the profiler's start and a traced
# run (profiled), and the empty kernel's name
PROFILER_LEAD_S = 0.1
PROFILER_LEAD_KERNELS = 256
LEAD_KERNEL = "spin_kernel"


def path_config(arch: str, full: bool):
    """The path's config: full width (and depth, unless REDUCED_DEPTH cuts
    it), or the smoke config in the CPU rehearsal."""
    if not full:
        return get_smoke_config(arch)
    cfg = get_config(arch)
    return cfg.replace(n_layers=REDUCED_DEPTH[arch]) if arch in REDUCED_DEPTH else cfg


def attention_counter(cfg) -> str:
    """The launch count of the K1 kernel (or instance) that takes ``cfg``'s
    prefill attention."""
    d, dv = ((cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim) if cfg.attention == "mla"
             else (cfg.resolved_head_dim,) * 2)
    names = {count: name for name, (module, count) in COUNTERS.items() if module is fa_kernel}
    return names[fa_kernel.launch_count(getattr(torch, cfg.dtype), d, dv)]


def norms_per_pass(cfg) -> int:
    """RMSNorms of one dense forward or decode step: ln1 and ln2 a layer (and
    MLA's q_ln and kv_ln), then the final norm."""
    return (4 if cfg.attention == "mla" else 2) * cfg.n_layers + 1


def zero_counters() -> None:
    for module, count in COUNTERS.values():
        setattr(module, count, 0)


def read_counters() -> dict:
    # an older tree's wrapper (chip_variants.py) may lack a count: zero_counters set it
    return {name: getattr(module, count, 0) for name, (module, count) in COUNTERS.items()}


def check_replays(what: str, stats: dict, device) -> None:
    """Hold an engine's decode replays to its decode steps on the card (each
    step of a warmed engine replays its graph), or to 0 on the CPU, which
    steps the same static buffers eagerly."""
    want = stats["decode_steps"] if device.type == "cuda" else 0
    say(f"[graph] {what}: {stats['decode_replays']} decode replays in {stats['decode_steps']} decode steps "
        f"(expected {want})")
    if stats["decode_replays"] != want:
        raise AssertionError(f"{what}: {stats['decode_replays']} decode replays, expected {want}")


def check_train_replays(what: str, replays: int, steps: int, device) -> None:
    """Hold a train run's graph replays to its steps less the warm-up on the
    card (the first step runs eagerly, then the step is captured and every
    later one replays), or to 0 on the CPU, which steps the same static
    buffers eagerly."""
    want = steps - 1 if device.type == "cuda" else 0
    say(f"[graph] {what}: {replays} train step replays in {steps} steps (expected {want})")
    if replays != want:
        raise AssertionError(f"{what}: {replays} train step replays, expected {want}")


def graph_seconds(seconds: dict) -> str:
    """A train graph's warm-up and capture wall seconds (none on the CPU)."""
    if not seconds:
        return "not measured (cpu: no capture)"
    return f"warm-up {seconds['warm_up'] * 1e3:.1f} ms, capture {seconds['capture'] * 1e3:.1f} ms"


def train_memory(device, held_before: int) -> str:
    """The peak allocated and the reserved memory of a train run: the static
    state, the graph's pool and the warm-up's blocks (returned before the
    capture)."""
    if device.type != "cuda":
        return "max_memory_allocated not measured (cpu)"
    return (f"max_memory_allocated {torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB "
            f"({held_before / 2**20:.1f} MiB held before the run), memory_reserved "
            f"{torch.cuda.memory_reserved(device) / 2**20:.1f} MiB (at most "
            f"{torch.cuda.max_memory_reserved(device) / 2**20:.1f} MiB)")


def check_launches(what: str, launches: dict, want: dict, device) -> None:
    """Hold the launches read around a main path to the exact counts ``want``
    (none on the CPU, which runs the plain versions)."""
    if device.type != "cuda":
        want = dict.fromkeys(want, 0)
    say(f"[launches] {what}: {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"{what}: kernel launches on the main path {launches} != expected {want}")


def dense_launches(cfg, prefills: int, decode_steps: int) -> dict:
    """Exact launches of a dense model's ``prefills`` prefill calls and
    ``decode_steps`` decode steps: L attentions a prefill, a pass's norms
    each."""
    want = dict.fromkeys(COUNTERS, 0)
    want.update({attention_counter(cfg): cfg.n_layers * prefills,
                 "rmsnorm": norms_per_pass(cfg) * (prefills + decode_steps)})
    return want


def memory_line(device, held_before: int) -> str:
    if device.type != "cuda":
        return "max_memory_allocated not measured (cpu)"
    peak = torch.cuda.max_memory_allocated(device)
    return (f"max_memory_allocated {peak / 2**20:.1f} MiB, of which {held_before / 2**20:.1f} MiB was held "
            f"before the engine or model was built: {(peak - held_before) / 2**20:.1f} MiB for weights, "
            "cache and activations")


def expected_launches(cfg, per_len: dict, batch: int, gen_len: int) -> dict:
    """Exact launches of each kernel (and of the gating's slots kernel) for
    the prefill batches of ``batch`` rows that ``per_len`` (prompt length:
    requests) gives, each with ``gen_len`` decode steps."""
    batches = {n: math.ceil(c / batch) for n, c in per_len.items()}
    prefill_batches = sum(batches.values())
    L, steps = cfg.n_layers, prefill_batches * (1 + gen_len)
    want = dict.fromkeys(COUNTERS, 0)
    fa = attention_counter(cfg)
    if cfg.family == "dense":
        want = dense_launches(cfg, prefill_batches, prefill_batches * gen_len)
    elif cfg.family == "rglru":
        n_super, tail = rg.griffin_layout(cfg)
        want.update({fa: n_super * prefill_batches, "lru_scan": (2 * n_super + tail) * prefill_batches,
                     "rmsnorm": (2 * L + 1) * steps})
    elif cfg.family == "rwkv6":
        want.update(wkv6=L * prefill_batches)
    elif cfg.family == "encdec":  # the encoder's attentions, then the decoder's self- and cross-attentions
        want.update({fa: (cfg.n_enc_layers + 2 * L) * prefill_batches})
    elif cfg.family == "moe":
        # groups of min(moe_group_tokens, rows x tokens a row) tokens; the
        # slots kernel runs when a group spans more than one tile
        def spans(n):
            return min(cfg.moe_group_tokens, batch * n) > gating_kernel.TILE

        routings = L - cfg.n_dense_layers
        want.update({fa: L * prefill_batches, "rmsnorm": (2 * L + 1) * steps, "moe_gating": routings * steps,
                     "moe_gating_slots": routings * sum(b * (spans(n) + gen_len * spans(1))
                                                        for n, b in batches.items())})
    return want


def free(device) -> None:
    """Return the card's cached memory between paths (the CPU rehearsal has
    nothing to return)."""
    if device.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()


def serve_path(arch: str, device, full: bool) -> dict:
    """Serve 16 greedy requests through ``arch`` with the launch counters set
    to 0 just before and read just after; then the law and the trace. Returns
    the launches of each kernel."""
    cfg = path_config(arch, full)
    batch, lengths, gen_len, law_S = PATHS[arch][0 if full else 1]
    max_seq = max(lengths) + gen_len
    # what earlier phases left allocated (library workspaces of the timed calls)
    held_before = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    engine = ServeEngine(cfg, batch=batch, max_seq=max_seq, seed=0, device=device)
    sync(device)
    build_peak = (f"{torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB peak" if device.type == "cuda"
                  else "peak not measured (cpu)")
    say(f"[serve] {shape_line(cfg, engine.model.cfg.vocab_size)} | engine batch={batch} "
        f"max_seq={max_seq} | built in {time.perf_counter() - t0:.2f}s, {build_peak}")
    rng = np.random.default_rng(0)
    requests = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
                for n in rng.choice(lengths, size=16)]
    engine.serve_requests(requests[:1], gen_len=2)  # warm-up: library handles, allocator
    sync(device)
    for key in engine.stats:
        engine.stats[key] = type(engine.stats[key])()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    zero_counters()
    t0 = time.perf_counter()
    outs = engine.serve_requests(requests, gen_len=gen_len)
    sync(device)
    wall = time.perf_counter() - t0
    launches = read_counters()

    per_len = {n: sum(len(r) == n for r in requests) for n in sorted({len(r) for r in requests})}
    prefill_batches = sum(math.ceil(c / batch) for c in per_len.values())
    say(f"[serve] {cfg.name}: {len(requests)} requests, prompt lengths {per_len}, {prefill_batches} "
        f"prefill batches, gen_len {gen_len}")
    check_launches(cfg.name, launches, expected_launches(cfg, per_len, batch, gen_len), device)
    check_replays(cfg.name, engine.stats, device)
    padded_vocab = engine.model.cfg.vocab_size
    for o in outs:
        if o.shape != (gen_len,) or o.min() < 0 or o.max() >= padded_vocab:
            raise AssertionError(f"{cfg.name}: bad generation {o.shape} {o.min()}..{o.max()}")
    s = engine.stats
    prefill_tps = s["prefill_tokens"] / s["prefill_s"]
    decode_tps = s["decode_tokens"] / s["decode_s"]
    memory = memory_line(device, held_before)
    say(f"[serve] {cfg.name} on {device_name(device)}: wall {wall:.3f}s | prefill {s['prefill_tokens']} "
        f"tok in {s['prefill_s']:.4f}s = {prefill_tps:.1f} tok/s | decode {s['decode_tokens']} tok in "
        f"{s['decode_s']:.4f}s = {decode_tps:.1f} tok/s | {memory}")

    free(device)  # the law's f32 activations cast whole weight stacks (kimi-k2's experts: 21 GiB)
    decode_equals_forward(engine.cfg, engine.params, device, S=law_S)
    free(device)
    prompts = requests[0][None].repeat(batch, 0)

    def run(steps):
        for key in engine.stats:
            engine.stats[key] = type(engine.stats[key])()
        engine.generate_batch(prompts, steps)
        return engine.stats["prefill_s"] * 1e3, engine.stats["decode_s"] * 1e3

    trace_one_batch(run, device, prompts.shape, gen_len=4)
    shortest = min(requests, key=len)
    graph_against_eager(cfg.name, engine, lambda: prime_batch(engine, shortest[None].repeat(batch, 0)), device, full)
    del engine, outs
    free(device)
    return launches


def prime_batch(engine, prompts: np.ndarray) -> None:
    """A batch of ``prompts`` prefilled into a ``ServeEngine``'s static
    cache, its greedy first tokens and its position fed to the decode graph."""
    logits, _ = engine._prefill_batch(prompts)
    engine._graph.feed(_whole(logits)[:, -1].argmax(-1)[:, None], prompts.shape[1])


def prime_slots(engine, requests: list) -> None:
    """A ``ContinuousBatchingEngine``'s static cache zeroed, then every slot
    filled by an insert of one of ``requests``, the first tokens and the
    slots' positions fed to the decode graph."""
    firsts = requests[:engine.batch]
    cache = engine._empty_cache()
    toks = [engine._insert(cache, b, r) for b, r in enumerate(firsts)]
    engine._graph.feed(torch.tensor(toks)[:, None], [len(r) for r in firsts])


def shape_line(cfg, padded_vocab: int) -> str:
    """The config's widths, as the log prints them."""
    moe_shape = (f" E={cfg.n_experts} k={cfg.top_k} shared={cfg.n_shared_experts} moe_F={cfg.moe_d_ff} "
                 f"dense layers={cfg.n_dense_layers} group={cfg.moe_group_tokens}"
                 if cfg.family == "moe" else "")
    mla = (f" MLA q_lora={cfg.q_lora_rank} kv_lora={cfg.kv_lora_rank} qk={cfg.qk_nope_dim}+{cfg.qk_rope_dim} "
           f"v={cfg.v_head_dim}" if cfg.attention == "mla" else "")
    encdec = f" encoder L={cfg.n_enc_layers} enc_len={cfg.enc_len}" if cfg.family == "encdec" else ""
    full = get_config(cfg.name) if cfg.name in REDUCED_DEPTH else None
    reduced = f" (reduced depth: {cfg.n_layers} of {full.n_layers} layers)" if full else ""
    return (f"{cfg.name}: family {cfg.family} L={cfg.n_layers}{reduced}{encdec} D={cfg.d_model} H={cfg.n_heads} "
            f"kv={cfg.n_kv_heads} hd={cfg.resolved_head_dim}{mla} F={cfg.d_ff}{moe_shape} V={padded_vocab} "
            f"{cfg.dtype} | {cfg.param_count() / 1e9:.3f}B parameters")


def trace_one_batch(run, device, shape: tuple, gen_len: int) -> None:
    """Where the time goes: torch.profiler over one batch with no decode step
    (prefill alone) and over the same batch with ``gen_len`` steps, each run
    by ``run(steps)``, which returns its (prefill ms, decode ms) by the host's
    clock; device busy time (the sum of kernel times) against the host's wall
    time, the port's kernels' share of the prefill's device time, and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    run(gen_len)  # warm the shapes
    runs = {}
    for steps in (0, gen_len):
        for attempt in range(1, TRACE_TRIES + 1):
            zero_counters()
            kernels, (pre_ms, dec_ms) = profiled(device, acts, lambda: run(steps))
            launches = read_counters()
            # the counts, replays included, against the kernels the trace shows by name
            if device.type != "cuda" or check_trace(f"{steps} decode steps", kernels, launches, attempt):
                break
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        runs[steps] = (pre_ms, dec_ms, busy_ms, kernels)
    say(f"[trace] traced in {time.perf_counter() - t0:.1f}s")
    if runs[gen_len][2] <= 0:
        say("[trace] the profiler recorded no kernel: device busy share not measured")
        return
    pre_wall, _, pre_busy, pre_kernels = runs[0]
    wall_pre, wall_dec, busy, kernels = runs[gen_len]
    dec_busy = busy - pre_busy
    B, P = shape
    say(f"[trace] prefill {B}x{P} tokens: wall {pre_wall:.3f}ms, device busy {pre_busy:.3f}ms "
        f"= {100 * pre_busy / pre_wall:.1f}%")
    ours = trace_shares(pre_kernels)
    say("[trace] prefill device time in the port's kernels: " + (", ".join(
        f"{name} {ms:.3f}ms ({100 * ms / pre_busy:.1f}%)" for name, ms in ours.items() if ms) or "none"))
    say(f"[trace] {gen_len} decode steps of {B} rows: wall {wall_dec:.3f}ms, device busy about "
        f"{dec_busy:.3f}ms = {100 * dec_busy / wall_dec:.1f}% (busy of the run with decode minus "
        f"the run without)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        dev = e.self_device_time_total / 1e3
        say(f"[trace]   {e.key[:72]:72s} calls {e.count:5d} device {dev:9.3f}ms "
            f"({100 * dev / busy:5.1f}%)")


def graph_against_eager(what: str, engine, prime, device, full: bool) -> None:
    """The engine's decode graph against the eager step on a copy of its
    static cache: ``engine.model.decode_fn``, or on a mesh the engine's
    ``make_serve_step`` under the rules and the gather of the whole logits
    (``engine._on.step``, the step the graph captured), over a copy of the
    static DTensor cache. ``prime()`` leaves a state in the static buffers
    (prefilled cache, first tokens, positions); from it each side takes
    GRAPH_LEG's steps in turns (a replay, then an eager step), feeding its
    own greedy tokens, which must be equal, as must every logit; then more
    steps each way under the profiler. Prints the largest logit difference,
    the median wall ms a step (host clock to the host's read of the token),
    the device ms a step and the busy share of each."""
    with torch.inference_mode() if engine.mesh is None else torch.no_grad():
        _graph_against_eager(what, engine, prime, device, full)


def _graph_against_eager(what: str, engine, prime, device, full: bool) -> None:
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    steps, traced = GRAPH_LEG[full]
    graph, params = engine._graph, engine.params
    on = engine._on
    decode = engine.model.decode_fn if on is None else on.step
    placed = (lambda t: t) if on is None else (lambda t: distribute(t, on.mesh, on.tokens))  # noqa: E731
    prime()
    eager = {"cache": map_defs(torch.clone, graph.cache), "tokens": graph.tokens.clone(), "pos": graph.pos.clone()}

    def replay():
        logits, _ = graph(params, graph.cache, graph.tokens, graph.pos)
        tok = logits[:, -1].argmax(-1)
        graph.feed(tok[:, None], graph.pos + 1)
        return logits, tok.cpu()

    def eager_step():
        logits, _ = decode(params, eager["cache"], eager["tokens"], eager["pos"])
        tok = logits[:, -1].argmax(-1)
        eager["tokens"], eager["pos"] = placed(tok[:, None]), eager["pos"] + 1
        return logits, tok.cpu()

    replays = graph.replays
    wall, worst, equal = {"replay": [], "eager": []}, 0.0, True
    for _ in range(steps):
        out = {}
        for which, step in (("replay", replay), ("eager", eager_step)):
            sync(device)
            t = time.perf_counter()
            out[which] = step()
            wall[which].append((time.perf_counter() - t) * 1e3)
        equal &= torch.equal(out["replay"][1], out["eager"][1])
        worst = max(worst, float((out["replay"][0].float() - out["eager"][0].float()).abs().max()))
    device_ms = dict.fromkeys(wall)
    for which, step in (("replay", replay), ("eager", eager_step)):
        if device.type != "cuda":  # no device time on the CPU
            continue
        with profile(activities=[ProfilerActivity.CUDA]) as prof:  # the kernels alone: no host op recorded
            for _ in range(traced):
                step()
        busy = sum(e.self_device_time_total for e in prof.key_averages() if str(e.device_type).endswith("CUDA"))
        device_ms[which] = busy / 1e3 / traced if busy > 0 else None
    want = (steps + traced) * (device.type == "cuda")
    med = {which: float(np.median(ms)) for which, ms in wall.items()}

    def dev(which):
        ms = device_ms[which]
        return "not measured" if ms is None else f"{ms:.3f} ms, busy {100 * ms / med[which]:.1f}%"

    eager_name = "decode_fn" if on is None else "mesh step (make_serve_step under the rules, the gather)"
    say(f"[graph] {what}: {steps} decode steps of {tuple(graph.tokens.shape)[0]} rows in turns, the graph's replay "
        f"against the eager {eager_name} on a copy of the static cache: greedy tokens equal {equal}, largest logit "
        f"difference {worst:.3e} | wall ms a step (median, host clock to the token's read): replay {med['replay']:.3f}, "
        f"eager {med['eager']:.3f}, eager / replay {med['eager'] / med['replay']:.2f} | device a step "
        f"({traced} profiled steps each): replay {dev('replay')}, eager {dev('eager')} | "
        f"{graph.replays - replays} replays (expected {want}) | {time.perf_counter() - t0:.1f}s")
    if not equal or worst != 0 or graph.replays - replays != want:
        raise AssertionError(f"{what}: the graph's replays disagree with the eager decode step")


@torch.inference_mode()
def decode_equals_forward(cfg, params, device, S: int) -> float:
    """Decode-step logits at position S equal a full forward over S+1 tokens
    (a visual-prefix config: its patches, then S - n_patches text tokens; an
    encoder-decoder: both against the same seeded audio frames).

    The law is checked with f32 activations over the engine's own weights: in
    bf16 the two sides round at different places (a scan against a step, the
    kernel's tiles against one-token attention), which is not what the law is
    about; the served bf16 path is held by phase 3's kernel cases instead.
    For MoE it holds only where no pick is dropped (routing per group depends
    on the group's other tokens): at capacity_factor E / k every group's
    capacity is at least its token count, so routing is per token."""
    law_cfg = cfg.replace(dtype="float32")
    if law_cfg.family == "moe":
        law_cfg = law_cfg.replace(capacity_factor=law_cfg.n_experts / law_cfg.top_k)
    model = build_model(law_cfg)
    cfg = model.cfg
    g = torch.Generator(device=device).manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, S - cfg.n_patches), generator=g, device=device)}
    if cfg.n_patches:
        batch["patches"] = torch.randn((2, cfg.n_patches, cfg.d_model), generator=g, device=device)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((2, cfg.enc_len, cfg.d_model), generator=g, device=device)
    last, cache = model.prefill_fn(params, batch)
    cache = pad_cache_to(cache, model.cache_defs_fn(2, S + 8))
    nxt = last[:, -1].argmax(-1)[:, None]
    step, _ = model.decode_fn(params, cache, nxt, S)
    del cache
    toks = torch.cat([batch["tokens"], nxt], dim=1)
    full = model.forward_fn(params, toks, patches=batch.get("patches"), frames=batch.get("frames"))[:, -1]
    sync(device)
    if step.shape != (2, 1, cfg.vocab_size) or not bool(torch.isfinite(step).all()):
        raise AssertionError(f"decode logits {tuple(step.shape)} not finite or misshapen")
    err = float((step[:, -1] - full).abs().max())
    say(f"[serve] {cfg.name} decode-equals-forward at S={S} (f32 activations): max abs err {err:.3e} "
        f"(tolerance 1e-3; logits up to {float(full.abs().max()):.3e})")
    if err > 1e-3:
        raise AssertionError(f"{cfg.name}: decode step disagrees with the full forward: {err}")
    return err


SMALL_MODELS = {  # card against CPU: small models with the kernels' real head widths
    "nbi-100m": (dict(n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64, d_ff=256), 40),
    "recurrentgemma-2b": (dict(d_model=256, n_heads=2, n_kv_heads=1, head_dim=256, lru_width=256,
                               d_ff=512, window=16), 40),
    "rwkv6-7b": (dict(d_model=128, n_heads=2, n_kv_heads=2, rwkv_head_size=64, d_ff=256), 40),
    # the real routing widths (64 experts, top-6) at the reference capacity
    # factor, in groups of 32 tokens with capacity 4: picks are dropped
    "deepseek-moe-16b": (dict(d_model=128, n_heads=2, n_kv_heads=2, head_dim=128, d_ff=256, moe_d_ff=64,
                              n_experts=64, top_k=6, moe_group_tokens=32), 32),
    # kimi-k2's routing widths (384 experts, top-8) in its groups of 256
    # tokens, capacity 7: picks are dropped
    "kimi-k2-1t-a32b": (dict(d_model=128, n_heads=4, n_kv_heads=2, head_dim=128, d_ff=256, moe_d_ff=64,
                             n_experts=384, top_k=8, moe_group_tokens=256), 128),
    # MLA at its real head widths (q, k 64 + 32, v 64): the card's f32 (96, 64) K1
    "minicpm3-4b": (dict(d_model=128, n_heads=2, n_kv_heads=2, d_ff=256, q_lora_rank=64, kv_lora_rank=32,
                         qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64), 40),
    "starcoder2-7b": (dict(d_model=128, n_heads=6, n_kv_heads=2, head_dim=64, d_ff=256), 40),
    "mistral-large-123b": (dict(d_model=128, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=256), 40),
    # 8 patch embeddings before the 40 text tokens
    LLAVA_ARCH: (dict(d_model=128, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=256), 40),
    # 2 + 2 layers of 2 heads of 64: the f32 (64, 64) K1 over a ragged
    # 100-frame encoder and cross-attention from 40 tokens over it
    "whisper-small": (dict(n_layers=2, n_enc_layers=2, d_model=128, n_heads=2, n_kv_heads=2, d_ff=256,
                           enc_len=100), 40),
}


def llava_path(device, full: bool) -> dict:
    """The visual prefix: batches of 1152 seeded patch embeddings (bf16, as
    the activations) and text of each length through ``Model.prefill_fn``,
    then greedy ``decode_fn`` steps, with the launch counters set to 0 just
    before and read just after; then the law (patches, then text) and the
    trace. Returns the launches of each kernel."""
    cfg = path_config(LLAVA_ARCH, full)
    batch, lengths, gen_len, law_text = LLAVA_RUN[full]
    P = cfg.n_patches
    max_seq = P + max(lengths) + gen_len
    held_before = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    sync(device)
    say(f"[serve] {shape_line(cfg, model.cfg.vocab_size)} | n_patches={P} | model functions, batch={batch} "
        f"max_seq={max_seq} | built in {time.perf_counter() - t0:.2f}s")
    g = torch.Generator(device=device).manual_seed(1)
    dt = getattr(torch, cfg.dtype)
    inputs = {n: {"tokens": torch.randint(0, cfg.vocab_size, (batch, n), generator=g, device=device),
                  "patches": torch.randn((batch, P, cfg.d_model), generator=g, device=device).to(dt)}
              for n in lengths}

    @torch.inference_mode()
    def generate(n: int, steps: int):
        """(prefill ms, decode ms, tokens) of one batch of text length n."""
        t0 = time.perf_counter()
        logits, cache = model.prefill_fn(params, inputs[n])
        cache = pad_cache_to(cache, model.cache_defs_fn(batch, max_seq))
        sync(device)
        t1 = time.perf_counter()
        tok = logits[:, -1].argmax(-1)[:, None]
        out = [tok]
        for i in range(steps):
            logits, cache = model.decode_fn(params, cache, tok, P + n + i)
            tok = logits[:, -1].argmax(-1)[:, None]
            out.append(tok)
        sync(device)
        return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3, torch.cat(out, dim=1)

    generate(lengths[0], 2)  # warm-up: library handles, allocator
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    zero_counters()
    runs = [generate(n, gen_len) for n in lengths]
    launches = read_counters()
    say(f"[serve] {cfg.name}: {len(lengths)} batches of {batch} x ({P} patches + text {lengths}), gen_len "
        f"{gen_len}")
    check_launches(cfg.name, launches, dense_launches(cfg, len(lengths), len(lengths) * gen_len), device)
    for *_, toks in runs:
        if toks.shape != (batch, 1 + gen_len) or int(toks.min()) < 0 or int(toks.max()) >= model.cfg.vocab_size:
            raise AssertionError(f"{cfg.name}: bad generation {tuple(toks.shape)}")
    pre_ms, dec_ms = sum(r[0] for r in runs), sum(r[1] for r in runs)
    pre_tok = batch * sum(P + n for n in lengths)
    memory = memory_line(device, held_before)
    say(f"[serve] {cfg.name} on {device_name(device)}: prefill {pre_tok} tok (patches and text) in "
        f"{pre_ms / 1e3:.4f}s = {pre_tok / pre_ms * 1e3:.1f} tok/s | decode {batch * gen_len * len(lengths)} tok "
        f"in {dec_ms / 1e3:.4f}s = {batch * gen_len * len(lengths) / dec_ms * 1e3:.1f} tok/s | {memory}")
    decode_equals_forward(cfg, params, device, S=P + law_text)
    free(device)
    trace_one_batch(lambda steps: generate(lengths[-1], steps)[:2], device, (batch, P + lengths[-1]), gen_len=4)
    del params, inputs
    free(device)
    return launches


def largest_gap(engine, requests, outs, device) -> float:
    """The largest gap between a chosen token's logit and its position's max
    logit in a full forward over the request's prompt and its tokens."""
    worst = 0.0
    with torch.inference_mode():
        for req, out in zip(requests, outs):
            seq = torch.as_tensor(np.concatenate([req, out[:-1]])[None], dtype=torch.long, device=device)
            logits = engine.model.forward_fn(engine.params, seq)[0, len(req) - 1:]
            chosen = logits.gather(-1, torch.as_tensor(out, dtype=torch.long, device=device)[:, None])[:, 0]
            worst = max(worst, float((logits.max(-1).values - chosen).max()))
    return worst


@torch.inference_mode()
def drive_staggered(engine, arrivals, gen_len: int):
    """Greedy decode through the engine's slots with request i written by
    ``engine._insert`` into slot s of the engine's static cache (zeroed
    first) just before decode step t, for each (t, s, prompt) of
    ``arrivals``, while the other slots keep decoding through the engine's
    decode graph (``engine._step``). Returns each request's ``gen_len``
    tokens and the decode steps."""
    B = engine.batch
    cache = engine._empty_cache()
    tok, pos = np.zeros(B, np.int64), np.zeros(B, np.int64)
    outs, slot_of = [[] for _ in arrivals], {}
    step = 0
    while len(slot_of) < len(arrivals) or any(len(o) < gen_len for o in outs):
        for i, (t, s, prompt) in enumerate(arrivals):
            if t == step:
                if any(slot_of.get(j) == s and len(outs[j]) < gen_len for j in slot_of):
                    raise AssertionError(f"staggered arrivals: slot {s} is busy at step {t}")
                tok[s], pos[s] = engine._insert(cache, s, prompt), len(prompt)
                outs[i].append(int(tok[s]))
                slot_of[i] = s
        nxt = engine._step(cache, tok, pos)
        for i, s in slot_of.items():
            if len(outs[i]) < gen_len:
                outs[i].append(int(nxt[s]))
                tok[s], pos[s] = nxt[s], pos[s] + 1
        step += 1
    return [np.asarray(o, np.int32) for o in outs], step


def continuous_path(arch: str, device, full: bool) -> dict:
    """Continuous batching on ``arch`` with f32 activations: 16 requests of
    mixed lengths through the engine's slots, with the launch counters set to
    0 just before and read just after (each insert a one-row prefill: L
    attentions and a forward's norms; each decode step a step's norms); every
    request's tokens against a full forward over its prompt and its tokens;
    decode steps and occupancy against the static bound ceil(R/B)·gen. Then
    inserts into a live cache beside a slot part-way through its generation
    (``engine.serve`` fills its slots together, so they finish together):
    request a decodes alone in slot 0, b joins slot 1 a quarter of the way
    through a's generation, c takes slot 0 as soon as a is done while b is
    still decoding; a's tokens must equal a
    run of a alone, and every token passes the same full-forward check.
    Returns the launches of each kernel."""
    slots, lengths, gen_len = CONTINUOUS[arch][0 if full else 1]
    cfg = path_config(arch, full).replace(dtype="float32")
    max_seq = max(lengths) + gen_len
    held_before = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    t0 = time.perf_counter()
    engine = ContinuousBatchingEngine(cfg, batch=slots, max_seq=max_seq, seed=0, device=device)
    sync(device)
    say(f"[continuous] {shape_line(cfg, engine.model.cfg.vocab_size)} (params {cfg.param_dtype}) | {slots} slots "
        f"max_seq={max_seq} | built in {time.perf_counter() - t0:.2f}s")
    rng = np.random.default_rng(1)
    requests = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
                for n in rng.choice(lengths, size=16)]
    engine.serve(requests[:1], gen_len=2)  # warm-up: library handles, allocator
    for key in engine.stats:
        engine.stats[key] = type(engine.stats[key])()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    zero_counters()
    t0 = time.perf_counter()
    outs = engine.serve(requests, gen_len=gen_len)
    sync(device)
    wall = time.perf_counter() - t0
    launches = read_counters()
    st = engine.stats
    bound = -(-len(requests) // slots) * gen_len
    occupancy = st["occupancy_sum"] / st["decode_steps"]
    say(f"[continuous] {cfg.name}: {st['requests']} requests (prompt lengths "
        f"{sorted(len(r) for r in requests)}), {st['decode_steps']} decode steps (static bound ceil(R/B)·gen = "
        f"{bound}), occupancy {occupancy:.4f}, {st['slot_tokens']} slot tokens")
    check_launches(f"{cfg.name} continuous batching", launches,
                   dense_launches(cfg, st["requests"], st["decode_steps"]), device)
    check_replays(f"{cfg.name} continuous batching", st, device)
    if st["requests"] != len(requests) or st["decode_steps"] > bound + 2:
        raise AssertionError(f"{cfg.name} continuous batching: {st} against the static bound {bound}")
    if any(out.shape != (gen_len,) for out in outs):
        raise AssertionError(f"{cfg.name} continuous batching: bad generation {[out.shape for out in outs]}")
    tokens = sum(len(r) for r in requests) + len(requests) * gen_len
    say(f"[continuous] {cfg.name} on {device_name(device)}: wall {wall:.3f}s for {len(requests)} requests | "
        f"{len(requests) * gen_len / wall:.1f} generated tok/s, {tokens / wall:.1f} prompt and generated tok/s "
        f"(inserts and decode on one clock) | {memory_line(device, held_before)}")
    worst = largest_gap(engine, requests, outs, device)
    say(f"[continuous] {cfg.name}: every chosen token against a full forward over its request (f32 "
        f"activations): largest gap to the position's max logit {worst:.3e} (tolerance 1e-3)")
    if worst > 1e-3:
        raise AssertionError(f"{cfg.name} continuous batching: a token is {worst} below the full forward's max")

    a, b, c = requests[:3]
    alone = engine.serve([a], gen_len=gen_len)[0]
    arrivals = [(0, 0, a), (max(1, gen_len // 4), 1, b), (gen_len - 1, 0, c)]
    for key in engine.stats:
        engine.stats[key] = type(engine.stats[key])()
    zero_counters()
    staggered, steps = drive_staggered(engine, arrivals, gen_len)
    sync(device)
    staggered_launches = read_counters()
    check_launches(f"{cfg.name} staggered inserts", staggered_launches, dense_launches(cfg, len(arrivals), steps),
                   device)
    check_replays(f"{cfg.name} staggered inserts", engine.stats, device)
    worst = largest_gap(engine, [a, b, c], staggered, device)
    say(f"[continuous] {cfg.name} staggered inserts (step, slot, prompt length) "
        f"{[(t, s, len(p)) for t, s, p in arrivals]}, {steps} decode steps: a's tokens equal a run of a alone: "
        f"{bool((staggered[0] == alone).all())}; largest gap to a full forward's max logit {worst:.3e} "
        "(tolerance 1e-3)")
    if not (staggered[0] == alone).all() or worst > 1e-3:
        raise AssertionError(f"{cfg.name}: an insert beside a decoding slot changed the tokens")
    launches = {name: n + staggered_launches[name] for name, n in launches.items()}

    graph_against_eager(f"{cfg.name} continuous batching", engine, lambda: prime_slots(engine, requests), device,
                        full)
    del engine, outs
    free(device)
    return launches


def liven(params: dict) -> dict:
    """Nonzero values for every leaf that the init leaves at zero (gates,
    biases, RWKV's mixes and bonus), so that each term of the small models is
    live."""
    g = torch.Generator().manual_seed(7)
    return map_defs(lambda t: t if bool(t.any()) else (0.3 * torch.randn(t.shape, generator=g)).to(t.dtype),
                    params)


@contextlib.contextmanager
def count_drops(dropped: list):
    """Append the number of dropped picks of every ops.moe_gating call made
    inside the block to ``dropped``."""
    real = ops.moe_gating

    def counting(logits, **kw):
        out = real(logits, **kw)
        dropped.append(int((out[2] < 0).sum()))
        return out

    ops.moe_gating = counting
    try:
        yield
    finally:
        ops.moe_gating = real


@torch.inference_mode()
def card_matches_cpu(arch: str) -> float:
    """A small f32 model with the kernels' head widths, on the card and on the
    CPU (plain versions) with the same weights, drawn on the host: prefill and
    one decode step agree."""
    overrides, P = SMALL_MODELS[arch]
    cfg = get_smoke_config(arch).replace(**overrides)
    model = build_model(cfg)
    host_params = liven(model.init(torch.Generator().manual_seed(3), "cpu"))
    gen = torch.Generator().manual_seed(4)
    host_batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, P), generator=gen)}
    if cfg.n_patches:
        host_batch["patches"] = torch.randn((2, cfg.n_patches, cfg.d_model), generator=gen)
    if cfg.family == "encdec":
        host_batch["frames"] = torch.randn((2, cfg.enc_len, cfg.d_model), generator=gen)
    S = cfg.n_patches + P
    outs = {}
    dropped = []  # picks the CPU run's routing dropped, per MoE layer call
    for name in ("cuda", "cpu"):
        params = map_defs(lambda t: t.to(name), host_params)
        # the counting wrapper reads on the host, which a capture forbids: the CPU's routings only
        with count_drops(dropped) if name == "cpu" else contextlib.nullcontext():
            last, cache = model.prefill_fn(params, {k: v.to(name) for k, v in host_batch.items()})
            if name == "cpu":  # the eager step
                step, _ = model.decode_fn(params, pad_cache_to(cache, model.cache_defs_fn(2, S + 8)),
                                          torch.full((2, 1), 7), S)
        if name == "cuda":  # a replay of the decode graph, captured after a first step from the same state
            graph = _DecodeGraph(model, 2, S + 8, torch.device(name))
            graph.tokens.fill_(7)
            graph.pos.fill_(S)
            for _ in range(2):
                fill_cache(graph.cache, cache)
                step, _ = graph(params, graph.cache, graph.tokens, graph.pos)
            if graph.replays != 1:
                raise AssertionError(f"{arch}: the card's decode step did not replay its graph")
        outs[name] = (last.cpu(), step.cpu())
    worst = max(float((a - b).abs().max()) for a, b in zip(outs["cuda"], outs["cpu"]))
    drops = f", {sum(dropped)} picks dropped over {len(dropped)} routings" if cfg.family == "moe" else ""
    say(f"[serve] small {cfg.family} model ({arch} smoke, {overrides}), card (decode by a graph's replay) against "
        f"CPU (eager): max abs logit err {worst:.3e} (tolerance 1e-4){drops}")
    if cfg.family == "moe" and not sum(dropped):
        raise AssertionError(f"{arch}: the small model dropped no pick, so it does not exercise capacity")
    if worst > 1e-4:
        raise AssertionError(f"{arch}: card and CPU disagree: {worst}")
    return worst


# ---------------------------------------------------------------------------
# Phase 5: training
# ---------------------------------------------------------------------------

# global batch, sequence, steps, warmup of the main train run, and batch,
# sequence and N of the resume check (2N straight against N + restore + N):
# at full size and in the CPU rehearsal
TRAIN_RUN = {True: ((8, 512, 30, 10), (4, 128, 3)), False: ((4, 32, 12, 4), (2, 16, 2))}
TRAIN_ARCH = "nbi-100m"
# the small model of the card-against-CPU train step: SMALL_MODELS' nbi-100m
# (head dim 64, so that K1 runs), one AdamW step at a constant lr
TRAIN_SMALL_LR = 1e-3
# a train path with no config of its own: name: (arch, overrides at full size,
# overrides in the CPU rehearsal). MoE with MLA attention (the reference has
# no such config): deepseek-moe-16b's published widths with MLA at
# minicpm3-4b's published ranks, the only MLA widths of the repo's configs
# (K1's bf16 (96, 64) kernel); in the rehearsal the MLA smoke ranks
MOE_MLA = "deepseek-moe-16b-mla"
TRAIN_VARIANTS = {MOE_MLA: ("deepseek-moe-16b",
                            dict(name=MOE_MLA, attention="mla", q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64,
                                 qk_rope_dim=32, v_head_dim=64),
                            dict(name=f"{MOE_MLA}-smoke", attention="mla", q_lora_rank=24, kv_lora_rank=16,
                                 qk_nope_dim=8, qk_rope_dim=8, v_head_dim=8))}
# the other families trained at full width: path: (layers, global batch,
# sequence); depth cut so that weights, gradients and AdamW state fit one card
# (deepseek-moe-16b: its leading dense layer and 3 MoE layers of 28; rwkv6-7b
# 4 of 32; recurrentgemma-2b 14 of 26, 4 super-layers and 2 tail pairs: all 26
# ran out of an H100 80GB's memory at 74.2 GiB, the AdamW update holding old and
# new weights and moments and two f32 gradient trees). RWKV-6's sequence is a
# multiple of 64 (the gradient's chunked form); MoE's 4 x 2048 tokens are 8
# groups of 1024. whisper-small trains at its full depth (12 + 12 layers) on
# 8 rows of 448 tokens, its published decoder context, each against 1500
# seeded audio frames. llava-next-mistral-7b, starcoder2-7b, codeqwen1.5-7b
# and mistral-large-123b take the most layers that launch/submit.py's
# train_memory_model puts at 61 GiB or less (8 of 32: 57.6 GiB; 5 of 32:
# 55.9; 6 of 32: 60.4), as minicpm3-4b (MLA) did (28 of 62: 60.7), so that
# what the earlier paths leave in the allocator still fits; mistral-large-123b's one
# layer (of 88) reads 61.6 GiB, most of it AdamW's state of its 805 M
# embedding and unembedding parameters, and its 8 rows run as its config's 8
# microbatches of one row under remat "selective"; llava's rows are 896 text
# tokens behind its 1152 seeded patch embeddings, 2048 positions a row. MoE
# with MLA (MOE_MLA) trains at deepseek-moe-16b's depth and batch (64.2 GiB
# by the model, under the GQA path's 65.3). The whole script took 591 s with
# these four paths on an H100 host where nbi-100m's step takes 128 ms; to
# keep it near 530 s three cuts were made, in this order: rwkv6-7b's 8
# layers to 4, the mesh leg's timed steps (MESH_TIMED_STEPS), minicpm3-4b's
# 28 layers to 16; with the train step's graph legs, minicpm3-4b's 16 to 8
# (the script took 578 s on a host where nbi-100m's eager step took 120 ms)
TRAIN_FAMILIES = {"deepseek-moe-16b": (4, 4, 2048), "rwkv6-7b": (4, 4, 2048), "recurrentgemma-2b": (14, 2, 2048),
                  "whisper-small": (12, 8, 448), "minicpm3-4b": (8, 4, 2048), LLAVA_ARCH: (8, 4, 896),
                  MOE_MLA: (4, 4, 2048), "starcoder2-7b": (5, 4, 2048),
                  "codeqwen1.5-7b": (6, 4, 2048), "mistral-large-123b": (1, 8, 2048)}
# steps and warmup of each family's run (one more step is traced), at full
# size and in the CPU rehearsal (smoke configs at 4 x 32 under their full
# configs' remat); 10 at full size until the train step's graph legs took the
# script to 784 s on an H100 host where nbi-100m's eager step took 147 ms
# (560 s is the aim on a host where it takes 128 ms); llava-next-mistral-7b
# keeps its 10: at 3e-4 its loss jumps after two steps and comes back below
# its first only at step 10 (10.94 -> 11.38 at step 8 on an H100; PERF.md)
TRAIN_FAMILY_RUN = {True: (8, 3), False: (3, 1)}
TRAIN_FAMILY_STEPS = {LLAVA_ARCH: 10}
# the family paths whose graph replays run against eager steps in turns at
# full width (train_graph_against_eager; nbi-100m's runs in train_path): a
# state that clones in under 4 GB
TRAIN_GRAPH_LEG = ("whisper-small",)
# train_graph_against_eager's steps in turns after the warm-up: at full
# width GRAPH_LEG's, for each path's small model (train_card_matches_cpu)
# two; then one step profiled each way: with GRAPH_LEG's 4 the small models'
# legs took 134 s of that script's 784 s, the profiler's records of
# host-bound steps of tens of thousands of kernels most of it
TRAIN_GRAPH_SMALL_STEPS = 2
TRAIN_GRAPH_TRACED = 1
# peak learning rate of each family's run (cosine warmup), and of the paths
# named here at full width: the widest dense configs (D 4096 to 12288, bf16
# weights) under a 3-step warmup jump to a loss above their first after two
# or three steps at 3e-4 and did not come back below it in 10
# (starcoder2-7b 11.30 -> 11.72, codeqwen1.5-7b 11.99 -> 13.01,
# mistral-large-123b 11.03 -> 22.52 on an H100; PERF.md), as Adam's first
# steps move every entry by about the lr; minicpm3-4b jumps too, and at 16
# layers ended above its first (11.54 -> 11.99)
TRAIN_FAMILY_LR = 3e-4
TRAIN_LR = {"starcoder2-7b": 5e-5, "codeqwen1.5-7b": 5e-5, "mistral-large-123b": 5e-5, "minicpm3-4b": 5e-5}
# arch: (overrides of the smoke config, (batch, sequence)) of the card-against-
# CPU train step: the kernels' real head widths, the families' remat "full"
TRAIN_SMALL_MODELS = {
    TRAIN_ARCH: (SMALL_MODELS[TRAIN_ARCH][0], (4, 64)),
    "deepseek-moe-16b": ({**SMALL_MODELS["deepseek-moe-16b"][0], "remat": "full"}, (4, 64)),
    "rwkv6-7b": ({**SMALL_MODELS["rwkv6-7b"][0], "remat": "full"}, (2, 128)),
    "recurrentgemma-2b": ({**SMALL_MODELS["recurrentgemma-2b"][0], "remat": "full"}, (2, 64)),
    "whisper-small": ({**SMALL_MODELS["whisper-small"][0], "remat": "full"}, (4, 64)),
    # f32 MLA at (96, 64): K1's f32 (96, 64) kernel in the forward and the recompute
    "minicpm3-4b": ({**SMALL_MODELS["minicpm3-4b"][0], "remat": "full"}, (4, 64)),
    # 64 text tokens a row behind the smoke config's 8 seeded patches
    LLAVA_ARCH: ({**SMALL_MODELS[LLAVA_ARCH][0], "remat": "full"}, (4, 64)),
    # SMALL_MODELS' deepseek-moe-16b routing (64 experts, top-6, groups of 32)
    # with f32 MLA at (96, 64): K1's f32 (96, 64) kernel, K2 (the latents'
    # norms too) and K5
    MOE_MLA: ({**SMALL_MODELS["deepseek-moe-16b"][0], "attention": "mla", "q_lora_rank": 64, "kv_lora_rank": 32,
               "qk_nope_dim": 64, "qk_rope_dim": 32, "v_head_dim": 64, "remat": "full"}, (4, 64)),
    # GQA at G 3 and G 1, head dim 64
    "starcoder2-7b": ({**SMALL_MODELS["starcoder2-7b"][0], "remat": "full"}, (4, 64)),
    "codeqwen1.5-7b": (dict(d_model=128, n_heads=2, n_kv_heads=2, head_dim=64, d_ff=256, remat="full"), (4, 64)),
    # the full config's remat "selective" over 2 microbatches of 2 rows
    "mistral-large-123b": ({**SMALL_MODELS["mistral-large-123b"][0], "remat": "selective", "microbatch": 2},
                           (4, 64)),
}


def train_arch(name: str) -> str:
    """The architecture of the train path ``name`` (TRAIN_VARIANTS' or its own)."""
    return TRAIN_VARIANTS[name][0] if name in TRAIN_VARIANTS else name


def train_config(name: str, full: bool):
    """The config of the train path ``name``: full width at TRAIN_FAMILIES'
    depth, or in the CPU rehearsal the smoke config at the kernels' head
    widths under the full config's remat (and the smoke config's
    microbatches)."""
    arch = train_arch(name)
    wide, smoke = TRAIN_VARIANTS[name][1:] if name in TRAIN_VARIANTS else ({}, {})
    if full:
        return get_config(arch).replace(n_layers=TRAIN_FAMILIES[name][0], **wide)
    return dryrun.kernel_widths(get_smoke_config(arch).replace(remat=get_config(arch).remat, **smoke))


def train_args(device, full: bool, *argv):
    return train_argparser().parse_args(
        ["--arch", TRAIN_ARCH, "--device", device.type, *map(str, argv), *([] if full else ["--smoke"])])


def train_path(device, full: bool, counts: list) -> dict:
    """Train nbi-100m through the launcher with the launch counters set to 0
    just before and read just after; then a step against its count and the
    step trace (rows of :func:`hold_count` appended to ``counts``), the card
    against the CPU and resume equivalence. Returns the launches of each
    kernel."""
    (batch, seq, steps, warmup), _ = TRAIN_RUN[full]
    cfg = get_config(TRAIN_ARCH) if full else get_smoke_config(TRAIN_ARCH)
    held_before = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    stamps = []
    zero_counters()
    t0 = time.perf_counter()
    result = train(train_args(device, full, "--steps", steps, "--global-batch", batch, "--seq", seq,
                              "--warmup", warmup, "--log-every", 1),
                   on_metrics=lambda m: stamps.append(time.perf_counter()))
    wall = time.perf_counter() - t0
    launches = read_counters()
    want = expected_train_launches(cfg, batch, seq, steps) if device.type == "cuda" else dict.fromkeys(COUNTERS, 0)
    say(f"[train] {cfg.name}: L={cfg.n_layers} D={cfg.d_model} H={cfg.n_heads} hd={cfg.resolved_head_dim} "
        f"F={cfg.d_ff} V={build_model(cfg).cfg.vocab_size} {cfg.dtype} remat={cfg.remat} | "
        f"{cfg.param_count() / 1e6:.1f}M parameters | {cfg.optimizer}, cosine warmup {warmup} | "
        f"{steps} steps of {batch} x {seq} tokens | launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"{cfg.name} training: kernel launches {launches} != expected {want}")
    check_train_replays(f"{cfg.name} training (the launcher)", result["replays"], steps, device)
    losses = [m["loss"] for m in result["metrics"]]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{cfg.name} training: the loss did not fall: {losses}")
    step_ms = np.diff(stamps[2:]) * 1e3  # the first replays warm up the allocator and library handles
    med = float(np.median(step_ms))
    say(f"[train] {cfg.name} on {device_name(device)}: wall {wall:.3f}s for {steps} steps | loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} | step 1 (warm-up and capture) {graph_seconds(result['graph_seconds'])}; "
        f"replayed step ms median {med:.3f} (min {step_ms.min():.3f}, max {step_ms.max():.3f}, steps 4 to {steps}) "
        f"= {batch * seq / med * 1e3:.1f} tok/s | {train_memory(device, held_before)}")
    free(device)
    trace_train_step(device, cfg if full else dryrun.kernel_widths(cfg), batch, seq, med, counts)
    free(device)
    if full:
        train_card_matches_cpu()
    resume_equivalence(device, full)
    free(device)
    return launches


def expected_train_launches(cfg, batch: int, seq: int, steps: int) -> dict:
    """Each step's forward through the kernels, once a microbatch
    (``cfg.microbatch`` of them, ``batch`` / microbatch rows each), twice under
    remat "full" and "selective" (the forward, then the backward's recompute
    of each wrapped layer: "selective" keeps the matmuls' outputs, but the
    kernels are autograd Functions outside them, so the recompute runs them
    again); every backward launches none. Dense and MoE: K1 and 2 norms a
    layer (4 with MLA's q_ln and kv_ln), and for MoE K5 a routing (and its
    slots kernel where a group spans more than one tile); RWKV-6: K4 a
    layer; Griffin: K3 a recurrent layer, K1 an attention layer, 2 norms a
    layer; then the final norm once; Whisper: K1 an encoder layer and twice
    a decoder layer (self- and cross-attention), no norm kernel (its norms
    are LayerNorms)."""
    if cfg.remat not in ("none", "full", "selective"):
        raise ValueError(f"no launch count for remat {cfg.remat!r}")
    r = 1 if cfg.remat == "none" else 2
    mb = max(1, cfg.microbatch)
    steps, batch = steps * mb, batch // mb  # a forward a microbatch
    L = cfg.n_layers
    want = dict.fromkeys(COUNTERS, 0)
    if cfg.family in ("dense", "moe"):
        norms = 4 if cfg.attention == "mla" else 2  # MLA's q_ln and kv_ln besides ln1 and ln2
        want.update({attention_counter(cfg): r * L * steps, "rmsnorm": (norms * r * L + 1) * steps})
    if cfg.family == "moe":
        routings = r * (L - cfg.n_dense_layers) * steps
        spans = min(cfg.moe_group_tokens, batch * seq) > gating_kernel.TILE
        want.update({"moe_gating": routings, "moe_gating_slots": routings * spans})
    elif cfg.family == "rwkv6":
        want.update(wkv6=r * L * steps)
    elif cfg.family == "encdec":
        want.update({attention_counter(cfg): r * (cfg.n_enc_layers + 2 * L) * steps})
    elif cfg.family == "rglru":
        n_super, tail = rg.griffin_layout(cfg)
        want.update({attention_counter(cfg): r * n_super * steps, "lru_scan": r * (2 * n_super + tail) * steps,
                     "rmsnorm": (2 * r * L + 1) * steps})
    return want


def family_train_path(name: str, device, full: bool, counts: list) -> dict:
    """Train the path ``name`` (:func:`train_config`) at full width and
    TRAIN_FAMILIES' depth through the launcher's pieces (the config's
    optimizer with cosine warmup from its peak lr, TRAIN_LR's or
    TRAIN_FAMILY_LR, the train state drawn on the card, the train step
    through its CUDA graph, :class:`TrainGraph`, the data pipeline) with the
    launch counters set to 0 just before the steps and read just after;
    every step after the first replays the graph, and the loss must fall.
    Then step ms (the warm-up's and capture's apart), tok/s and peak memory,
    one more step traced (a replay), and one more step (eager: a replay
    allocates nothing) counted on meta and run against the count
    (:func:`hold_count`, its row appended to ``counts``); whisper-small's
    replays against its eager steps in turns (:func:`train_graph_against_eager`)
    and, on the card, a small model's step against the CPU. A visual-prefix
    model's rows are ``seq`` text tokens behind its seeded patches: the
    count's step takes ``seq + n_patches`` positions
    (``Model.train_inputs``). Returns the launches of each kernel."""
    steps, warmup = TRAIN_FAMILY_RUN[full]
    steps = TRAIN_FAMILY_STEPS.get(name, steps) if full else steps
    _, batch, seq = TRAIN_FAMILIES[name] if full else (None, 4, 32)
    cfg = train_config(name, full)
    held_before = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = build_model(cfg)
    lr = TRAIN_LR.get(name, TRAIN_FAMILY_LR) if full else TRAIN_FAMILY_LR  # TRAIN_LR is for the full widths
    opt = make_optimizer(cfg.optimizer, lr=cosine_warmup(lr, warmup, steps))
    step = make_train_step(model, opt)
    graph = TrainGraph(step, init_train_state(model, opt, torch.Generator(device=device).manual_seed(0), device))
    loader = make_train_loader(model.cfg.vocab_size, batch, seq, seed=0)
    # contiguous: the pipeline's tokens are a view of a (rows, seq + 1) block
    batches = [{k: torch.from_numpy(v).to(device).contiguous() for k, v in next(loader).items()}
               for _ in range(steps + 1)]
    loader.close()
    add_frames(cfg, batches, device)
    add_patches(cfg, batches, device)
    positions = seq + cfg.n_patches
    sync(device)
    rows = f"{batch} x ({cfg.n_patches} patches + {seq} text tokens)" if cfg.n_patches else f"{batch} x {seq} tokens"
    micro = f" in {cfg.microbatch} microbatches" if cfg.microbatch > 1 else ""
    say(f"[train] {shape_line(cfg, model.cfg.vocab_size)} | remat={cfg.remat} {cfg.optimizer} lr {lr}, cosine "
        f"warmup {warmup} | {steps} steps of {rows}{micro} | state built in {time.perf_counter() - t0:.2f}s")
    zero_counters()
    losses, aux, stamps = [], [], [time.perf_counter()]
    for b in batches[:steps]:
        _, metrics = graph(graph.state, graph.feed(b))
        losses.append(float(metrics["loss"]))  # waits for the step
        aux.append(float(metrics.get("aux_loss", math.nan)))
        stamps.append(time.perf_counter())
    launches = read_counters()
    check_launches(f"{cfg.name} training", launches, expected_train_launches(cfg, batch, seq, steps), device)
    check_train_replays(f"{cfg.name} training", graph.replays, steps, device)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{cfg.name} training: the loss did not fall: {losses}")
    step_ms = np.diff(stamps[2:]) * 1e3  # the first replay warms up the graph's upload
    med = float(np.median(step_ms))
    aux_line = f" | aux_loss {aux[0]:.4f} -> {aux[-1]:.4f}" if cfg.family == "moe" else ""
    first = ", ".join(f"{x:.1f}" for x in np.diff(stamps[:3]) * 1e3)
    rate = (f"{batch * seq / med * 1e3:.1f} text tok/s, {batch * positions / med * 1e3:.1f} positions/s"
            if cfg.n_patches else f"{batch * seq / med * 1e3:.1f} tok/s")
    say(f"[train] {cfg.name} on {device_name(device)}: losses {[round(x, 4) for x in losses]}{aux_line} | "
        f"replayed step ms median {med:.3f} (min {step_ms.min():.3f}, max {step_ms.max():.3f}, steps 3 to {steps}; "
        f"steps 1 (warm-up and capture: {graph_seconds(graph.seconds)}) and 2: {first}) = {rate} | "
        f"{train_memory(device, held_before)}")

    def replay():
        float(graph(graph.state, graph.feed(batches[steps]))[1]["loss"])

    if full:  # the CPU rehearsal records no kernel (nbi-100m's trace rehearses profile_step)
        profile_step(device, replay, f"{cfg.name} {batch}x{positions}", med)
    state = graph.state
    del graph  # its pool goes: the eager step below needs the room
    free(device)
    state_copy(f"train {cfg.name} {batch}x{positions}", state, device, med)

    def one_step(b):
        nonlocal state
        state, metrics = step(state, b)
        float(metrics["loss"])

    counts.append(hold_count(f"train {cfg.name} {batch}x{positions}", model, "train", batch, positions,
                             (state, batches[0]), lambda: one_step(batches[0]), device,
                             expected_train_launches(cfg, batch, seq, 1), med))
    if name in TRAIN_GRAPH_LEG:
        train_graph_against_eager(f"train {cfg.name} {batch}x{positions}", step, state, batches, device,
                                  GRAPH_LEG[full][0])
    del state, batches, step
    free(device)
    if full:
        train_card_matches_cpu(name)
    return launches


# The count's peak against torch.cuda.max_memory_allocated around the same
# step: the count sees neither the allocator's rounding nor library
# workspaces (launch/submit.py's analytic memory model came within 0.98 to
# 1.01 of the same peaks)
COUNT_PEAK_RANGE = (0.85, 1.15)
# the dry-run leg's cell on a fake group of 256 ranks, and nbi-100m's
# prefill batch held against its count
DRYRUN_CELL = ("deepseek-moe-16b", "train_4k", "single")
COUNT_PREFILL = {True: (8, 512), False: (2, 32)}
PREFILL_TIMED = 5  # timed prefill calls, their median held beside the count


def hold_count(what: str, model, kind: str, batch: int, seq: int, card_args, run, device, want: dict,
               step_ms: float) -> dict:
    """Count one ``kind`` step of ``model`` on meta in this process (no mesh,
    no process group; :func:`repro_torch.analysis.opstats.count`), then
    ``run()`` the same step once on ``card_args`` with the launch counters
    set to 0 just before and read just after and the peak memory measured
    around it. The count's kernel calls must equal the launches (exactly;
    in the CPU rehearsal, which launches none, ``want``), its argument bytes
    the storages of ``card_args`` (exactly), and its peak the measured one
    within COUNT_PEAK_RANGE (the card only): the measured peak is what the
    step allocated above what was allocated before it, plus the arguments.
    Prints the roofline's terms under H100 beside ``step_ms``, the median
    step measured without the count. A train step's ``run()`` is an eager
    step (the function a :class:`TrainGraph` wraps), not a replay: a replay
    allocates nothing (its graph's pool was reserved at the capture), so the
    count's peak could not be held against it. Returns the row."""
    t0 = time.perf_counter()
    step, meta_args = dryrun.step_and_inputs(model, kind, batch, seq)
    stats, _ = count(step, *meta_args)
    count_s = time.perf_counter() - t0
    args_bytes = storage_bytes(card_args)
    cuda = device.type == "cuda"
    sync(device)
    held = torch.cuda.memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    zero_counters()
    run()
    sync(device)
    launches = {k: n for k, n in (read_counters() if cuda else want).items() if n}
    peak = torch.cuda.max_memory_allocated(device) - held + args_bytes if cuda else None
    cfg = model.cfg
    tokens = batch * (1 if kind == "decode" else seq)
    model_flops = (6 if kind == "train" else 2) * cfg.active_param_count() * tokens
    unit = roofline.unit_of(cfg.dtype)
    rep = roofline.roofline_report(
        per_device_flops=stats.flops, per_device_hbm_bytes=stats.hbm_bytes,
        per_device_wire_bytes=stats.collective_wire_bytes, chips=1, model_flops=model_flops, tokens=tokens,
        flops_by_unit=stats.flops_by_unit, wire_bytes_by_link=stats.wire_bytes_by_link, unit=unit)
    mfu = model_flops / (step_ms / 1e3 * roofline.H100.peak_flops[unit])
    # the count's own shares of the measured step: its compute at the peaks,
    # and its lower bound (neither can pass 1 on the card unless the count
    # or the peaks are wrong; the record's roofline_fraction_mfu, the
    # reference's 2·N·D over the lower bound, can: PERF.md §7)
    compute_share = rep["compute_s"] * 1e3 / step_ms
    bound_share = rep["step_time_lb_s"] * 1e3 / step_ms
    ratio = stats.peak_bytes / peak if peak else None
    say(f"[count] {what}: counted in {count_s:.2f}s | kernel calls {stats.kernel_calls} (launched {launches}) | "
        f"argument bytes {stats.argument_bytes} (on the {device.type}: {args_bytes}) | peak "
        f"{stats.peak_bytes / 2**20:.1f} MiB (measured "
        f"{'not measured (cpu)' if peak is None else f'{peak / 2**20:.1f} MiB'}"
        f"{'' if ratio is None else f', ratio {ratio:.4f}'}) | FLOPs {stats.flops:.4e} {stats.flops_by_unit} "
        f"by op {stats.flops_by_op} | HBM bytes {stats.hbm_bytes:.4e}")
    say(f"[count] {what} under H100 peaks (published, 700 W; {nvidia_smi_line() if cuda else 'cpu rehearsal'}): "
        f"compute "
        f"{rep['compute_s'] * 1e3:.3f}ms, memory {rep['memory_s'] * 1e3:.3f}ms, collective "
        f"{rep['collective_s'] * 1e3:.3f}ms, lower bound {rep['step_time_lb_s'] * 1e3:.3f}ms ({rep['bottleneck']}); "
        f"measured median step {step_ms:.3f}ms; counted compute at the peaks / step = {compute_share:.4f}, "
        f"lower bound / step = {bound_share:.4f}; model FLOPs {model_flops:.4e} / (step x {unit} peak) = "
        f"{mfu:.4f}")
    if stats.kernel_calls != launches:
        raise AssertionError(f"{what}: counted kernel calls {stats.kernel_calls} != launches {launches}")
    if stats.argument_bytes != args_bytes:
        raise AssertionError(f"{what}: counted argument bytes {stats.argument_bytes} != {args_bytes} on the card")
    if cuda and bound_share > 1:
        raise AssertionError(f"{what}: the count's lower bound {rep['step_time_lb_s'] * 1e3:.3f}ms under H100's "
                             f"peaks exceeds the measured step {step_ms:.3f}ms")
    if ratio is not None and not COUNT_PEAK_RANGE[0] <= ratio <= COUNT_PEAK_RANGE[1]:
        raise AssertionError(f"{what}: counted peak {stats.peak_bytes} is {ratio:.4f} of the measured {peak}, "
                             f"outside {COUNT_PEAK_RANGE}")
    return {"what": what, "count_s": count_s, "s": time.perf_counter() - t0, "peak_ratio": ratio,
            "lower_bound_ms": rep["step_time_lb_s"] * 1e3, "step_ms": step_ms, "mfu": mfu,
            "compute_share": compute_share, "bound_share": bound_share}


def prefill_count_path(device, full: bool) -> dict:
    """nbi-100m's prefill at COUNT_PREFILL's batch held against its count
    (:func:`hold_count`): seeded weights and tokens on the device, the
    model's prefill function as the engine calls it, its median over
    PREFILL_TIMED calls after one to warm up."""
    batch, seq = COUNT_PREFILL[full]
    cfg = get_config(TRAIN_ARCH) if full else dryrun.kernel_widths(get_smoke_config(TRAIN_ARCH))
    model = build_model(cfg)
    g = torch.Generator(device=device).manual_seed(0)
    params = model.init(g, device)
    inputs = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq), generator=g, device=device,
                                      dtype=torch.int32)}
    model.prefill_fn(params, inputs)  # warm up the library handles
    ms = []
    for _ in range(PREFILL_TIMED):
        sync(device)
        t0 = time.perf_counter()
        model.prefill_fn(params, inputs)
        sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    row = hold_count(f"prefill {cfg.name} {batch}x{seq}", model, "prefill", batch, seq, (params, inputs),
                     lambda: model.prefill_fn(params, inputs), device, dense_launches(cfg, 1, 0),
                     float(np.median(ms)))
    del params
    free(device)
    return row


@contextlib.contextmanager
def dryrun_cell(full: bool):
    """DRYRUN_CELL through ``python -m repro_torch.launch.dryrun`` in a
    subprocess (a fake process group of 256 ranks, apart from this process's
    groups; the CPU only), started on entry and run beside the block (one
    that times nothing: it shares the host's cores); in the
    CPU rehearsal the same cell's count at smoke size on a 2 x 2 mesh
    through ``count_cell``. On a clean exit of the block it waits for the
    cell: its status must be ``ok``, its wire bytes above zero and its K5
    routing calls one a MoE layer a forward (twice under remat "full"). The
    subprocess is killed if the block raises."""
    arch, shape, mesh = DRYRUN_CELL
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent / "src")}
    with tempfile.TemporaryDirectory() as out:
        if full:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape, "--mesh", mesh,
                   "--out", out, "--force"]
        else:
            # the smoke config's attention chunk of 16 would loop over 4096 tokens
            # in 256 chunks: the rehearsal's cell is 4 rows of 64
            cmd = [sys.executable, "-c", "import json, sys; from repro_torch.configs import get_config, "
                   "get_smoke_config; from repro_torch.launch import dryrun; "
                   f"dryrun.SHAPES[{shape!r}] = ('train', 64, 4); "
                   f"cfg = dryrun.kernel_widths(get_smoke_config({arch!r})"
                   f".replace(remat=get_config({arch!r}).remat)); "
                   f"rec = dryrun.count_cell({arch!r}, {shape!r}, cfg=cfg, spec='data=2,model=2'); "
                   "open(sys.argv[1] + '/cell.json', 'w').write(json.dumps(rec))", out]
        t0 = time.perf_counter()
        with open(Path(out) / "log.txt", "w") as log:
            proc = subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT, text=True)
            try:
                yield
                code = proc.wait(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        text = (Path(out) / "log.txt").read_text()
        say(f"[dryrun] {' '.join(cmd[1:]) if full else 'count_cell at smoke size'}: exit {code}, waited for "
            f"{time.perf_counter() - t0:.1f}s after its start (it ran beside the eco leg); "
            f"{text.strip().splitlines()[-2:]}")
        if code != 0:
            raise AssertionError(f"dry-run of {DRYRUN_CELL} failed: {text[-2000:]}")
        rec = json.loads(next(Path(out).glob("*__*.json" if full else "cell.json")).read_text())
    cfg = get_config(arch) if full else get_smoke_config(arch).replace(remat=get_config(arch).remat)
    routings = (2 if cfg.remat == "full" else 1) * (cfg.n_layers - cfg.n_dense_layers) * max(1, cfg.microbatch)
    rl = rec.get("roofline", {})
    say(f"[dryrun] {arch} {shape} on {rec.get('mesh')} ({rec.get('chips')} ranks of a fake group): status "
        f"{rec.get('status')}, counted in {rec.get('count_s')}s | per device: FLOPs "
        f"{rec.get('flops_per_device', 0):.4e}, HBM bytes {rec.get('hbm_bytes_per_device', 0):.4e}, wire bytes "
        f"{rec.get('collective_wire_bytes_per_device', 0):.4e} {rec.get('wire_bytes_by_link')}, peak "
        f"{rec.get('memory', {}).get('peak_bytes', 0) / 1e9:.2f} GB | kernel calls {rec.get('kernel_calls')} | "
        f"roofline: compute {rl.get('compute_s', 0):.4f}s, memory {rl.get('memory_s', 0):.4f}s, collective "
        f"{rl.get('collective_s', 0):.4f}s, bottleneck {rl.get('bottleneck')}, MFU at the lower bound "
        f"{rl.get('roofline_fraction_mfu', 0):.4f}")
    if rec.get("status") != "ok" or not rec.get("collective_wire_bytes_per_device", 0) > 0:
        raise AssertionError(f"dry-run of {DRYRUN_CELL}: status {rec.get('status')}, wire bytes "
                             f"{rec.get('collective_wire_bytes_per_device')}: {rec.get('error')}")
    if rec["kernel_calls"].get("moe_gating") != routings:
        raise AssertionError(f"dry-run of {DRYRUN_CELL}: K5 calls {rec['kernel_calls'].get('moe_gating')} != "
                             f"{routings} routings")


def add_patches(cfg, batches: list, device) -> None:
    """Seeded patch embeddings (B, n_patches, D) for each batch of a
    visual-prefix config, its labels then -100 on the patches: the data
    pipeline makes tokens only, as the reference's."""
    if not cfg.n_patches:
        return
    g = torch.Generator(device=device).manual_seed(9)
    for b in batches:
        B = b["tokens"].shape[0]
        b["patches"] = torch.randn((B, cfg.n_patches, cfg.d_model), generator=g, device=device).to(
            getattr(torch, cfg.dtype))
        b["labels"] = torch.cat([torch.full((B, cfg.n_patches), -100, dtype=b["labels"].dtype, device=device),
                                 b["labels"]], dim=1)


def add_frames(cfg, batches: list, device) -> None:
    """Seeded audio frames (B, enc_len, D) in the activations' dtype for each
    batch of an encoder-decoder config: the data pipeline makes tokens only,
    as the reference's."""
    if cfg.family != "encdec":
        return
    g = torch.Generator(device=device).manual_seed(6)
    for b in batches:
        b["frames"] = torch.randn((b["tokens"].shape[0], cfg.enc_len, cfg.d_model), generator=g,
                                  device=device).to(getattr(torch, cfg.dtype))


def trace_train_step(device, cfg, batch: int, seq: int, step_ms: float, counts: list) -> None:
    """One nbi-100m train step under torch.profiler, from a fresh state (the
    launcher's is gone): a replay of the step's graph (:class:`TrainGraph`,
    after its warm-up and a first replay), :func:`profile_step`; then one
    eager step held against its count on meta (:func:`hold_count`, its row
    appended to ``counts``; a replay allocates nothing) and the replays
    against eager steps in turns (:func:`train_graph_against_eager`)."""
    model = build_model(cfg)
    opt = make_optimizer(cfg.optimizer, lr=cosine_warmup(3e-4, 10, 30))
    step = make_train_step(model, opt)
    graph = TrainGraph(step, init_train_state(model, opt, torch.Generator(device=device).manual_seed(0), device))
    loader = make_train_loader(model.cfg.vocab_size, batch, seq, seed=0)
    batches = [{k: torch.from_numpy(v).to(device).contiguous() for k, v in next(loader).items()} for _ in range(4)]
    loader.close()
    for b in batches[:2]:
        float(graph(graph.state, graph.feed(b))[1]["loss"])
    profile_step(device, lambda: float(graph(graph.state, graph.feed(batches[2]))[1]["loss"]), f"{batch}x{seq}",
                 step_ms)
    state = graph.state
    del graph
    free(device)
    state_copy(f"train {cfg.name} {batch}x{seq}", state, device, step_ms)

    def one_step():
        nonlocal state
        state, metrics = step(state, batches[3])
        float(metrics["loss"])

    counts.append(hold_count(f"train {cfg.name} {batch}x{seq}", model, "train", batch, seq, (state, batches[3]),
                             one_step, device, expected_train_launches(cfg, batch, seq, 1), step_ms))
    train_graph_against_eager(f"train {cfg.name} {batch}x{seq}", step, state, batches, device,
                              GRAPH_LEG[device.type == "cuda"][0])


STATE_COPY_TIMED = 3


def state_copy(what: str, state: dict, device, step_ms: float) -> None:
    """What a :class:`TrainGraph`'s step pays that the eager step does not:
    the copy of each new leaf into its static leaf, every byte of the state
    read once and written once. Timed here outside the graph, each leaf
    copied into a scratch buffer of its dtype, the median of
    STATE_COPY_TIMED copies of the whole state by CUDA events, beside the
    bytes' time at H100's HBM rate and ``step_ms``, the median replayed
    step. Prints bytes alone on the CPU."""
    leaves = [t for _, t in tree_leaves(state)]
    moved = 2 * sum(t.numel() * t.element_size() for t in leaves)
    line = (f"[graph] {what}: the state's copy into the static leaves moves {moved / 1e9:.3f} GB a step "
            f"(at least {moved / roofline.H100.hbm_bw * 1e3:.3f} ms at H100's published HBM rate)")
    if device.type != "cuda":
        say(line)
        return
    largest = {}
    for t in leaves:
        largest[t.dtype] = max(largest.get(t.dtype, 0), t.numel())
    scratch = {dtype: torch.empty(n, dtype=dtype, device=device) for dtype, n in largest.items()}
    ms = []
    for _ in range(STATE_COPY_TIMED):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for t in leaves:
            scratch[t.dtype][:t.numel()].view(t.shape).copy_(t)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    del scratch
    med = float(np.median(ms))
    say(f"{line}; measured {med:.3f} ms on the card (median of {STATE_COPY_TIMED}, outside the graph), "
        f"{100 * med / step_ms:.1f}% of the replayed step ({step_ms:.3f} ms)")


def profile_step(device, run_step, what: str, step_ms: float) -> None:
    """``run_step()`` (one train step that waits for its loss: a replay of
    the step's graph, as users run it) under torch.profiler, with the launch
    counters set to 0 just before and read just after: on the card the
    port's kernels that the trace shows by name must equal the counts
    (:func:`check_trace`; a replay's counts are what its capture recorded,
    so the trace shows that the replay launched them), the step traced
    again, up to TRACE_TRIES times, where the profiler lost a record. Then
    device busy time against the host's wall time under the profiler and
    against ``step_ms``, the median step without it; each of the port's
    kernels' share of the step's device time, and the ops that take the
    most device time."""
    from torch.profiler import ProfilerActivity

    # the card's kernels only: recording every host op of a step of tens of
    # thousands of ops costs more than the step
    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else [ProfilerActivity.CPU]

    def timed():
        t0 = time.perf_counter()
        run_step()
        sync(device)
        return (time.perf_counter() - t0) * 1e3

    for attempt in range(1, TRACE_TRIES + 1):
        sync(device)
        zero_counters()
        kernels, wall_ms = profiled(device, acts, timed)
        if device.type != "cuda" or check_trace(f"train step {what}", kernels, read_counters(), attempt):
            break
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy <= 0:
        say(f"[trace] train step {what}: wall {wall_ms:.3f}ms under the profiler; no kernel recorded: "
            "device busy share not measured")
        return
    say(f"[trace] train step {what}: wall {wall_ms:.3f}ms under the profiler, device busy {busy:.3f}ms "
        f"= {100 * busy / wall_ms:.1f}%; {100 * busy / step_ms:.1f}% of the median step without the profiler "
        f"({step_ms:.3f}ms)")
    ours = trace_shares(kernels)
    say("[trace] train step device time in the port's kernels: " + (", ".join(
        f"{name} {ms:.3f}ms ({100 * ms / busy:.1f}%)" for name, ms in ours.items() if ms) or "none"))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        dev = e.self_device_time_total / 1e3
        say(f"[trace]   {e.key[:72]:72s} calls {e.count:5d} device {dev:9.3f}ms ({100 * dev / busy:5.1f}%)")


def train_graph_against_eager(what: str, step, state: dict, batches: list, device, steps: int) -> None:
    """A train step's graph (:class:`TrainGraph` over a clone of ``state``)
    against the eager ``step`` on another clone, in turns: the graph's
    warm-up and an eager step, then ``steps`` steps each way (replays on the
    card), then TRAIN_GRAPH_TRACED steps each way under the profiler
    (kernels only), the batches taken in turn from ``batches``. Every step's
    loss and metrics and the final states must be equal bit for bit, the
    replays as many as the steps after the warm-up (none on the CPU), the
    kernels' launches of each side equal, and on the card the port's
    kernels in the replays' trace equal their counts (:func:`check_trace`:
    the replays' counts are what the capture recorded; the traced steps
    run again each way, up to TRACE_TRIES times, where the profiler lost a
    record). Prints the median wall ms a step (host clock to the loss's
    read) and the device ms a step and busy share of each side (the eager
    step's median is the host's yardstick)."""
    from torch.profiler import ProfilerActivity

    t0 = time.perf_counter()
    traced = TRAIN_GRAPH_TRACED
    graph = TrainGraph(step, map_defs(torch.clone, state))
    eager = {"state": map_defs(torch.clone, state)}
    feed = itertools.cycle(batches)

    def replay(b):
        return graph(graph.state, graph.feed(b))[1]

    def eager_step(b):
        eager["state"], metrics = step(eager["state"], b)
        return metrics

    wall = {"replay": [], "eager": []}
    launches = {which: dict.fromkeys(COUNTERS, 0) for which in wall}
    equal = True
    for i in range(1 + steps):  # the graph's warm-up first
        b = next(feed)
        out = {}
        for which, run in (("replay", replay), ("eager", eager_step)):
            sync(device)
            zero_counters()
            t = time.perf_counter()
            out[which] = {k: v.clone() for k, v in run(b).items()}
            float(out[which]["loss"])
            if i:
                wall[which].append((time.perf_counter() - t) * 1e3)
            launches[which] = {k: n + launches[which][k] for k, n in read_counters().items()}
        equal &= all(torch.equal(out["replay"][k], out["eager"][k]) for k in out["eager"])
    device_ms = dict.fromkeys(wall)
    for attempt in range(1, TRACE_TRIES + 1):
        traced_batches = [next(feed) for _ in range(traced)]
        seen = True
        for which, run in (("replay", replay), ("eager", eager_step)):
            if device.type != "cuda":  # no device time on the CPU
                for b in traced_batches:
                    run(b)
                continue
            sync(device)
            zero_counters()
            # the kernels alone: no host op recorded
            kernels, _ = profiled(device, [ProfilerActivity.CUDA],
                                  lambda: [float(run(b)["loss"]) for b in traced_batches])
            counted = read_counters()
            launches[which] = {k: n + launches[which][k] for k, n in counted.items()}
            if which == "replay":  # the eager side's counts are the wrappers' own, at each launch
                seen &= check_trace(f"{what}, {traced} traced replay(s)", kernels, counted, attempt)
            busy = sum(e.self_device_time_total for e in kernels)
            device_ms[which] = busy / 1e3 / traced if busy > 0 else None
        if seen or device.type != "cuda":
            break
    same_state = all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_leaves(graph.state),
                                                                 tree_leaves(eager["state"]), strict=True))
    want = (steps + traced * attempt) * (device.type == "cuda")
    med = {which: float(np.median(ms)) for which, ms in wall.items()}

    def dev(which):
        ms = device_ms[which]
        return "not measured" if ms is None else f"{ms:.3f} ms, busy {100 * ms / med[which]:.1f}%"

    say(f"[graph] {what}: {steps} train steps in turns after the warm-up, the graph's replay against the eager "
        f"step from a clone of one state: losses and metrics equal {equal}, states equal {same_state} | wall ms a "
        f"step (median, host clock to the loss's read): replay {med['replay']:.3f}, eager {med['eager']:.3f}, "
        f"eager / replay {med['eager'] / med['replay']:.2f} | device a step ({traced} profiled steps each): "
        f"replay {dev('replay')}, eager {dev('eager')} | step 1: {graph_seconds(graph.seconds)} | "
        f"{graph.replays} replays (expected {want}) | launches "
        f"equal {launches['replay'] == launches['eager']} | {time.perf_counter() - t0:.1f}s")
    if not equal or not same_state or graph.replays != want or launches["replay"] != launches["eager"]:
        raise AssertionError(f"{what}: the train graph's replays disagree with the eager step")
    del graph, eager
    free(device)


def train_card_matches_cpu(path: str = TRAIN_ARCH) -> None:
    """One AdamW step of the train path ``path``'s small model (:data:`TRAIN_SMALL_MODELS`)
    from the same host-drawn weights and batch on the card and on the CPU
    (a visual-prefix model's batch with seeded patches, :func:`add_patches`).
    The card's launches, the counters set to 0 just before its step and read
    just after, must equal :func:`expected_train_launches` of one step. Then
    the small model's graph replays against its eager steps on the card
    (:func:`train_graph_against_eager`), from the same weights.

    Tolerances. Loss rtol 1e-5 and grad_norm rtol 1e-4: K1's 3xTF32 products
    keep about 22 bits (atol 2e-5 on attention outputs) and the f32 GEMMs
    sum in other orders. The clipped gradients, read from the new first
    moment m = 0.1 g, within 1e-4 of each leaf's largest. The new params:
    Adam's first step moves an entry by lr g / (|g| + eps) (plus the same
    weight decay on both), so each entry may differ by lr |f(g1) - f(g2)|,
    f(g) = g / (|g| + eps), from the two runs' own g, plus 1e-6: tight where
    a gradient is well above its rounding, loose only where it is at its
    noise floor, where the two runs' g may even differ in sign."""
    overrides, (batch, seq) = TRAIN_SMALL_MODELS[path]
    cfg = get_smoke_config(train_arch(path)).replace(**overrides)
    model = build_model(cfg)
    opt = make_optimizer("adamw", lr=TRAIN_SMALL_LR)
    host_params = model.init(torch.Generator().manual_seed(3), "cpu")
    if path != TRAIN_ARCH:
        host_params = liven(host_params)
    loader = make_train_loader(model.cfg.vocab_size, batch, seq, seed=5)
    host_batch = {k: torch.from_numpy(v) for k, v in next(loader).items()}
    add_frames(cfg, [host_batch], torch.device("cpu"))
    add_patches(cfg, [host_batch], torch.device("cpu"))
    outs = {}
    for name in ("cuda", "cpu"):
        params = map_defs(lambda t: t.to(name), host_params)
        state = {"params": params, "opt": opt.init(params), "step": torch.zeros((), dtype=torch.int32, device=name)}
        zero_counters()
        new_state, metrics = make_train_step(model, opt)(state, {k: v.to(name) for k, v in host_batch.items()})
        if name == "cuda":
            sync(torch.device(name))
            check_launches(f"small {path} train step", read_counters(),
                           expected_train_launches(cfg, batch, seq, 1), torch.device(name))
        outs[name] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                      {p: t.cpu() for p, t in tree_leaves(new_state["params"])},
                      {p: t.cpu() / 0.1 for p, t in tree_leaves(new_state["opt"]["m"])})
    (loss_c, gn_c, p_c, g_c), (loss_h, gn_h, p_h, g_h) = outs["cuda"], outs["cpu"]
    # the graph's replays against eager steps on the card, from the same weights
    cuda = torch.device("cuda")
    batches = [host_batch, *({k: torch.from_numpy(v) for k, v in next(loader).items()} for _ in range(2))]
    loader.close()
    add_frames(cfg, batches[1:], torch.device("cpu"))
    add_patches(cfg, batches[1:], torch.device("cpu"))
    params = map_defs(lambda t: t.to(cuda), host_params)
    train_graph_against_eager(f"small {path} train step", make_train_step(model, opt),
                              {"params": params, "opt": opt.init(params),
                               "step": torch.zeros((), dtype=torch.int32, device=cuda)},
                              [{k: v.to(cuda) for k, v in b.items()} for b in batches], cuda,
                              TRAIN_GRAPH_SMALL_STEPS)
    g_err = max(float((g_c[k] - g_h[k]).abs().max() / g_h[k].abs().max().clamp_min(1e-30)) for k in g_h)
    def adam_step(g):
        return g / (g.abs() + 1e-8)

    p_excess = max(float(((p_c[k] - p_h[k]).abs()
                          - TRAIN_SMALL_LR * (adam_step(g_c[k]) - adam_step(g_h[k])).abs()).max()) for k in p_h)
    p_err = max(float((p_c[k] - p_h[k]).abs().max()) for k in p_h)
    patches = f" behind {cfg.n_patches} seeded patches" if cfg.n_patches else ""
    say(f"[train] small {cfg.family} model ({path} smoke, {overrides}, remat {cfg.remat}, {batch} x {seq} "
        f"tokens{patches}), one AdamW step, card against CPU: "
        f"loss {loss_c:.7f} / {loss_h:.7f}, grad_norm {gn_c:.7f} / {gn_h:.7f}, clipped grads max err "
        f"{g_err:.3e} of each leaf's largest (tolerance 1e-4), params max abs err {p_err:.3e}, past the "
        f"Adam bound by at most {p_excess:.3e} (tolerance 1e-6)")
    if abs(loss_c - loss_h) > 1e-5 * abs(loss_h) or abs(gn_c - gn_h) > 1e-4 * abs(gn_h):
        raise AssertionError(f"train step: loss or grad_norm disagree: {loss_c} {loss_h} {gn_c} {gn_h}")
    if g_err > 1e-4 or p_excess > 1e-6:
        raise AssertionError(f"train step: gradients ({g_err}) or params ({p_excess}) disagree")


@contextlib.contextmanager
def deterministic(device):
    """torch.use_deterministic_algorithms on the card for the block (the
    embedding's backward accumulates with atomics otherwise)."""
    if device.type != "cuda":
        yield
        return
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def resume_equivalence(device, full: bool) -> None:
    """2N straight steps through the launcher equal N steps, a checkpoint, a
    fresh restore (a new train() call) and N more: the two final checkpoints'
    manifests and leaf files are identical, byte for byte. On the card each
    run replays its step's graph after the first step, so the resumed run's
    step N+1, an eager warm-up over the restored state, stands where the
    straight run replayed: its loss, and every later one, must equal the
    straight run's. Every step is inside the default warmup of 20, where the
    learning rate does not depend on ``--steps`` (as in the reference's own
    resume test)."""
    _, (batch, seq, n) = TRAIN_RUN[full]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, deterministic(device):
        def run(steps, name, every):
            return train(train_args(device, full, "--steps", steps, "--global-batch", batch, "--seq", seq,
                                    "--ckpt-dir", Path(tmp) / name, "--ckpt-every", every, "--log-every", 1))

        straight = run(2 * n, "straight", 2 * n)
        first = run(n, "split", n)
        resumed = run(2 * n, "split", n)
        for what, result, steps in (("straight", straight, 2 * n), ("split", first, n), ("resumed", resumed, n)):
            check_train_replays(f"resume equivalence, the {what} run", result["replays"], steps, device)
        losses = [[m["loss"] for m in r["metrics"][-n:]] for r in (straight, resumed)]
        if losses[0] != losses[1]:
            raise AssertionError(f"resume: steps {n + 1} to {2 * n} lost {losses[1]} after the restore, "
                                 f"{losses[0]} straight")
        dirs = [CheckpointManager(Path(tmp) / name) for name in ("straight", "split")]
        if [m.latest_step() for m in dirs] != [2 * n, 2 * n]:
            raise AssertionError(f"resume: latest steps {[m.latest_step() for m in dirs]}")
        a, b = (m.step_dir(2 * n) for m in dirs)
        manifests = [json.loads((d / "MANIFEST.json").read_text()) for d in (a, b)]
        if manifests[0]["leaves"] != manifests[1]["leaves"]:
            raise AssertionError("resume: the checkpoints' manifests (shapes, dtypes, crc32s) differ")
        differ = [r["keypath"] for r in manifests[0]["leaves"]
                  if not filecmp.cmp(a / r["file"], b / r["file"], shallow=False)]
        nbytes = sum((a / r["file"]).stat().st_size for r in manifests[0]["leaves"])
    if differ:
        raise AssertionError(f"resume: leaves differ: {differ}")
    how = "under torch.use_deterministic_algorithms" if device.type == "cuda" else "on the CPU"
    say(f"[train] resume equivalence ({how}): {2 * n} straight steps == {n} + checkpoint + restore + {n}, "
        f"{len(manifests[0]['leaves'])} leaves ({nbytes / 2**20:.1f} MiB) identical byte for byte; the resumed "
        f"run's eager warm-up (step {n + 1}) and its replays lost what the straight run's replays did "
        f"{losses[1]}, {time.perf_counter() - t0:.1f}s")


# The data-parallel leg: timed steps of each step in turns (after the N
# checked ones), and the error-feedback syncs of a constant
DP_TIMED_STEPS = {True: 10, False: 2}
EF_STEPS = 20
# the eco-preemption leg: the first instant of the default peak hours
# (17:00-20:00) on a Monday, and the --begin of the next eco window that the
# default config (weekdays 00:00-06:00) gives a job of an hour from there
ECO_PEAK_START = "2026-10-19T17:00:00"
ECO_BEGIN = "2026-10-20T00:00:00"
PLUGIN = Path(__file__).resolve().parent / "launchers" / "torch_h100.py"
# runs the plugin's __main__ under torch.use_deterministic_algorithms
DETERMINISTIC_RUN = ("import runpy, sys, torch; torch.use_deterministic_algorithms(True); "
                     "sys.argv = sys.argv[1:]; runpy.run_path(sys.argv[0], run_name='__main__')")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dp_path(device, full: bool) -> dict:
    """The data-parallel step in a process group of one rank: exact against
    the plain step (bitwise, same launches), both timed in turns, the
    compressed step, error feedback on a constant and the int8 payload and
    carry against the CPU's. Returns the exact DP run's launches."""
    _, (batch, seq, n) = TRAIN_RUN[full]
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH) if full else get_smoke_config(TRAIN_ARCH)
    model = build_model(cfg)
    opt = make_optimizer(cfg.optimizer, lr=cosine_warmup(3e-4, 10, 30))
    timed = DP_TIMED_STEPS[full]
    loader = make_train_loader(model.cfg.vocab_size, batch, seq, seed=0)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in next(loader).items()} for _ in range(n + 2 * timed)]
    loader.close()
    initialize(device, 0, 1, f"localhost:{free_port()}")
    try:
        groups = dp_groups()
        backend = torch.distributed.get_backend()
        plain = make_train_step(model, opt)
        exact = make_dp_train_step(model, opt, groups, compress=False)
        states, launches = {}, {}
        with deterministic(device):
            for name, step, state in (
                    ("plain", plain, init_train_state(model, opt, torch.Generator(device=device).manual_seed(0),
                                                      device)),
                    ("dp", exact, init_dp_state(model, opt, torch.Generator(device=device).manual_seed(0), device,
                                                compress=False))):
                zero_counters()
                for b in batches[:n]:
                    state, metrics = step(state, b)
                float(metrics["loss"])
                launches[name] = read_counters()
                states[name] = state
        differ = [p for (p, a), (_, b) in zip(tree_leaves(states["plain"]), tree_leaves(states["dp"]))
                  if not torch.equal(a, b)]
        if differ:
            raise AssertionError(f"DP step: the exact DP step differs from the plain step at {differ}")
        check_launches("DP step (exact)", launches["dp"], expected_train_launches(cfg, batch, seq, n), device)
        if launches["dp"] != launches["plain"]:
            raise AssertionError(f"DP step: launches {launches['dp']} != the plain step's {launches['plain']}")
        say(f"[dp] {cfg.name} in a {backend} group of one rank, {n} steps of {batch} x {seq}: the exact DP step "
            f"equals make_train_step bit for bit ({len(tree_leaves(states['dp']))} leaves of params and AdamW "
            f"state, under torch.use_deterministic_algorithms) | launches {launches['dp']}")

        ms = {"plain": [], "dp": []}
        rest = iter(batches[n:])
        for name in ("plain", "dp", "dp", "plain"):  # in turns
            step = plain if name == "plain" else exact
            for _ in range(timed // 2):
                sync(device)
                t = time.perf_counter()
                states[name], metrics = step(states[name], next(rest))
                float(metrics["loss"])
                ms[name].append((time.perf_counter() - t) * 1e3)
        say(f"[dp] step ms (host clock to the loss, {timed} steps each in turns plain, dp, dp, plain): DP exact "
            f"median {np.median(ms['dp']):.3f} (min {min(ms['dp']):.3f}) against the plain step's median "
            f"{np.median(ms['plain']):.3f} (min {min(ms['plain']):.3f})")

        state = init_dp_state(model, opt, torch.Generator(device=device).manual_seed(0), device, compress=True)
        step = make_dp_train_step(model, opt, groups, compress=True)
        losses = []
        for b in batches[:n]:
            state, metrics = step(state, b)
            losses.append(float(metrics["loss"]))
        carry = max(float(t.abs().max()) for _, t in tree_leaves(state["ef"]))
        if not all(math.isfinite(x) for x in losses) or not carry > 0:
            raise AssertionError(f"compressed DP step: losses {losses}, largest carry {carry}")
        say(f"[dp] compressed DP step ({n} steps): losses {[round(x, 4) for x in losses]}, largest carry "
            f"{carry:.3e}")

        g = {"w": torch.full((4, 64), 0.003, device=device)}
        e, total = init_ef_state(g), torch.zeros((4, 64), device=device)
        for _ in range(EF_STEPS):
            synced, e = ef_compressed_psum(g, e, groups["pod"], 1)
            total += synced["w"]
        mean_err = float(((total / EF_STEPS - 0.003).abs() / 0.003).max())
        if mean_err > 0.02:
            raise AssertionError(f"error feedback: the mean synced constant is off by {mean_err} (rtol 0.02)")

        # a gradient-like tree whose rows span six decades, on both devices
        rng = np.random.default_rng(7)
        x = rng.standard_normal((768, 2048)).astype(np.float32)
        x *= (10.0 ** rng.integers(-6, 3, (768, 1))).astype(np.float32)
        cpu_group = torch.distributed.new_group([0], backend="gloo")
        runs = {}
        for where, group in ((device, groups["pod"]), (torch.device("cpu"), cpu_group)):
            g = {"w": torch.from_numpy(x).to(where)}
            e, payload = init_ef_state(g), []
            for _ in range(EF_STEPS):
                payload.append(quant_int8(g["w"] + e["w"]))
                synced, e = ef_compressed_psum(g, e, group, 1)
            runs[where.type] = [(q.cpu(), s.cpu()) for q, s in payload], e["w"].cpu(), synced["w"].cpu()
        (pay_a, e_a, s_a), (pay_b, e_b, s_b) = runs[device.type], runs["cpu"]
        differ = [f"{what} at sync {i}" for i, ((qa, sa), (qb, sb)) in enumerate(zip(pay_a, pay_b))
                  for what, a, b in (("int8 payload", qa, qb), ("scales", sa, sb)) if not torch.equal(a, b)]
        differ += [what for what, a, b in (("carry", e_a, e_b), ("synced mean", s_a, s_b)) if not torch.equal(a, b)]
        if differ:
            raise AssertionError(f"error feedback: the card differs from the CPU: {differ[:8]}")
        say(f"[dp] error feedback: a constant 0.003 through {EF_STEPS} syncs, mean off by {mean_err:.2e} "
            f"(rtol 0.02); {EF_STEPS} syncs of a 768 x 2048 tree (rows over six decades): int8 payload, "
            f"scales, carry and synced mean on {device_name(device)} equal the CPU's bit for bit")
    finally:
        torch.distributed.destroy_process_group()
    del states, batches
    free(device)
    say(f"[dp] leg took {time.perf_counter() - t0:.1f}s")
    return launches["dp"]


# the mesh leg: timed steps of each step in turns (after the N checked ones;
# 6 before the script's time asked for a cut: TRAIN_FAMILIES)
MESH_TIMED_STEPS = {True: 2, False: 2}
MESH_SMALL_ARCHS = ("deepseek-moe-16b", "recurrentgemma-2b", "rwkv6-7b")
# MLA, the visual prefix and Whisper at full width, depth cut: arch: (layers
# of the train case, layers of the serve cases; None: the config's own). A
# train case holds two f32 AdamW states at once, the plain step's and the
# mesh step's (minicpm3-4b's 4 layers are 0.63 B parameters, llava's 1.14
# B); serving takes minicpm3-4b at its REDUCED_DEPTH, llava and whisper-small
# (12 + 12 layers) whole. Each trains on MESH_WIDE_TRAIN rows of tokens
# (llava's after its 1152 seeded patches, whisper-small's beside 1500
# seeded frames)
MESH_WIDE = {"minicpm3-4b": (4, REDUCED_DEPTH["minicpm3-4b"]), LLAVA_ARCH: (4, None), "whisper-small": (None, None)}
MESH_WIDE_TRAIN = (4, 64)
# the serving half: nbi-100m's engine batch, prompt length and generated
# tokens at full size and in the CPU rehearsal; the small and MESH_WIDE models' (4 rows of
# 32 tokens: deepseek-moe-16b's whole routing groups, two turns of
# recurrentgemma-2b's 16-slot ring); continuous batching's slots, prompt
# lengths of its 8 requests and generated tokens
MESH_SERVE_RUN = {True: ((8, 128, 16), (4, 32, 8), (4, (17, 32, 64, 100), 8)),
                  False: ((2, 12, 3), (4, 32, 2), (2, (5, 8, 12), 2))}
# the small deepseek-moe-16b served on the mesh with capacity 33 for its
# groups of 32 tokens (and 4 at decode, where a group is the step's 4 rows):
# no pick can be dropped (ROADMAP H6)
MESH_SERVE_CAPACITY_FACTOR = 11.0


def small_config(arch: str, full: bool):
    """TRAIN_SMALL_MODELS' config of ``arch`` in the full config's dtype and
    attention chunk (the backward's recompute chunk: the smoke configs' 8
    makes a small train step a host loop), or in the CPU rehearsal the
    smoke config under its remat."""
    if not full:
        return get_smoke_config(arch).replace(remat=TRAIN_SMALL_MODELS[arch][0].get("remat", "none"),
                                              dtype=get_config(arch).dtype)
    whole = get_config(arch)
    return get_smoke_config(arch).replace(**TRAIN_SMALL_MODELS[arch][0], dtype=whole.dtype,
                                          attn_chunk=whole.attn_chunk)


def wide_config(arch: str, full: bool, serve: bool):
    """:data:`MESH_WIDE`'s config of ``arch`` for its train or serve cases:
    full width at its depth, or in the CPU rehearsal the smoke config under
    the full config's remat and dtype."""
    whole = get_config(arch)
    if not full:
        return get_smoke_config(arch).replace(remat=whole.remat, dtype=whole.dtype)
    layers = MESH_WIDE[arch][serve]
    return whole.replace(n_layers=layers) if layers else whole


def mesh_configs(full: bool) -> list:
    """(name, config, (batch, seq)) of the mesh leg's training, FSDP forced
    on: nbi-100m at full width and depth (its smoke config in the rehearsal)
    at the resume check's shapes, TRAIN_SMALL_MODELS' deepseek-moe-16b,
    recurrentgemma-2b and rwkv6-7b at their shapes in the full configs'
    bf16, and :data:`MESH_WIDE`'s minicpm3-4b, llava-next-mistral-7b
    (seeded patches) and whisper-small (seeded frames) at full width, so
    that K1's bf16 kernels (d 64, 128, 256 and MLA's (96, 64)), K2, K3, K4
    and K5 all run."""
    _, (batch, seq, _) = TRAIN_RUN[full]
    nbi = (get_config(TRAIN_ARCH) if full else get_smoke_config(TRAIN_ARCH)).replace(fsdp=True)
    return [(TRAIN_ARCH, nbi, (batch, seq))] + [
        (f"{arch} small", small_config(arch, full).replace(fsdp=True), TRAIN_SMALL_MODELS[arch][1])
        for arch in MESH_SMALL_ARCHS] + [
        (arch, wide_config(arch, full, False).replace(fsdp=True), MESH_WIDE_TRAIN) for arch in MESH_WIDE]


def mesh_serve_configs(full: bool) -> list:
    """(name, config, (engine batch, prompt length, generated tokens)) of the
    mesh leg's serving: nbi-100m at full width and depth (f32), the small
    models of :func:`mesh_configs` without FSDP (deepseek-moe-16b with no
    dropped pick), and :data:`MESH_WIDE`'s at full width and their serving
    depth (llava-next-mistral-7b's text, as the engine feeds no patches: its
    prefix is :func:`mesh_prefix_path`'s)."""
    nbi_run, small_run, _ = MESH_SERVE_RUN[full]
    nbi = get_config(TRAIN_ARCH) if full else get_smoke_config(TRAIN_ARCH)
    small = [(f"{arch} small", small_config(arch, full), small_run) for arch in MESH_SMALL_ARCHS]
    small += [(arch, wide_config(arch, full, True), small_run) for arch in MESH_WIDE]
    small = [(name, cfg.replace(capacity_factor=MESH_SERVE_CAPACITY_FACTOR) if cfg.family == "moe" else cfg, run)
             for name, cfg, run in small]
    return [(TRAIN_ARCH, nbi, nbi_run)] + small


def mesh_continuous_configs(full: bool) -> list:
    """(name, config) of the mesh leg's continuous batching: nbi-100m at full
    width and depth, and minicpm3-4b at full width and its serving depth in
    f32 (its inserts through K1's f32 (96, 64) kernel on the local heads,
    its decode over the split latent cache)."""
    nbi = get_config(TRAIN_ARCH) if full else get_smoke_config(TRAIN_ARCH)
    return [(TRAIN_ARCH, nbi), ("minicpm3-4b", wide_config("minicpm3-4b", full, True).replace(dtype="float32"))]


def mesh_path(device, full: bool) -> dict:
    """The train step on a 1 x 1 device mesh in a process group of one rank
    against ``make_train_step``, for each of :func:`mesh_configs`: the same
    seeded state and batches, N steps each under
    ``torch.use_deterministic_algorithms``, then every leaf equal bit for bit
    and the mesh step's launches equal to the plain step's and to the exact
    count; both steps timed in turns. Then serving on the same mesh
    (:func:`mesh_serve_path`). Returns the launches of each mesh run
    ("train mesh <name>" or "serve mesh <name>": counts), the counters set
    to 0 just before its steps."""
    _, (_, _, n) = TRAIN_RUN[full]
    timed = MESH_TIMED_STEPS[full]
    t0 = time.perf_counter()
    initialize(device, 0, 1, f"localhost:{free_port()}")
    out = {}
    try:
        mesh = make_host_mesh(device)
        backend = torch.distributed.get_backend()
        for name, cfg, (batch, seq) in mesh_configs(full):
            t1 = time.perf_counter()
            model = build_model(cfg)
            opt = make_optimizer(cfg.optimizer, lr=cosine_warmup(3e-4, 10, 30))
            rules = rules_for(cfg, mesh, param_defs=model.param_defs, batch_size=batch,
                              extra_dims={"heads": cfg.n_heads})
            if rules["embed"] != "data" or rules["batch"] != "data":
                raise AssertionError(f"mesh leg {name}: rules {rules} do not shard embed and batch over data")
            placements = resolve_tree(mesh, train_state_logical(model, opt), rules)
            inputs = resolve_tree(mesh, model.train_input_logical(), rules)
            loader = make_train_loader(model.cfg.vocab_size, batch, seq, seed=0)
            batches = [{k: torch.from_numpy(v).to(device) for k, v in next(loader).items()}
                       for _ in range(n + 2 * timed)]
            loader.close()
            add_frames(cfg, batches, device)
            add_patches(cfg, batches, device)
            steps = {"plain": make_train_step(model, opt), "mesh": make_train_step(model, opt, rules, mesh)}
            feeds = {"plain": batches, "mesh": [distribute_tree(b, mesh, inputs) for b in batches]}
            states, launches = {}, {}
            with deterministic(device):
                for which in ("plain", "mesh"):
                    state = init_train_state(model, opt, torch.Generator(device=device).manual_seed(0), device)
                    if which == "mesh":
                        state = distribute_tree(state, mesh, placements)
                    zero_counters()
                    for b in feeds[which][:n]:
                        state, metrics = steps[which](state, b)
                    float(metrics["loss"])
                    launches[which] = read_counters()
                    states[which] = state
            differ = [p for (p, a), (_, b) in zip(tree_leaves(states["plain"]), tree_leaves(full_tree(states["mesh"])))
                      if not torch.equal(a, b)]
            if differ:
                raise AssertionError(f"mesh leg {name}: the mesh step differs from the plain step at {differ}")
            check_launches(f"mesh leg {name}", launches["mesh"], expected_train_launches(cfg, batch, seq, n), device)
            if launches["mesh"] != launches["plain"]:
                raise AssertionError(f"mesh leg {name}: launches {launches['mesh']} != the plain step's "
                                     f"{launches['plain']}")
            ms = {"plain": [], "mesh": []}
            rest = {k: iter(v[n:]) for k, v in feeds.items()}
            for which in ("plain", "mesh", "mesh", "plain"):  # in turns
                for _ in range(timed // 2):
                    sync(device)
                    t = time.perf_counter()
                    states[which], metrics = steps[which](states[which], next(rest[which]))
                    float(metrics["loss"])
                    ms[which].append((time.perf_counter() - t) * 1e3)
            say(f"[mesh] {name} ({cfg.n_layers} layers, D={cfg.d_model}, {cfg.dtype}, remat {cfg.remat}) on a 1 x 1 "
                f"mesh in a {backend} group of one rank, rules embed->{rules['embed']} batch->{rules['batch']}, "
                f"{n} steps of {batch} x {seq}: equals make_train_step bit for bit "
                f"({len(tree_leaves(states['plain']))} leaves, under torch.use_deterministic_algorithms) | "
                f"launches {launches['mesh']} | step ms (host clock to the loss, {timed} steps each in turns "
                f"plain, mesh, mesh, plain): mesh median {np.median(ms['mesh']):.3f} (min {min(ms['mesh']):.3f}) "
                f"against the plain step's median {np.median(ms['plain']):.3f} (min {min(ms['plain']):.3f}) | "
                f"{time.perf_counter() - t1:.1f}s")
            out[f"train mesh {name}"] = launches["mesh"]
            del states, feeds, batches, steps
            free(device)
        out.update(mesh_serve_path(device, full, mesh))
        out.update(mesh_prefix_path(device, full, mesh))
        for name, cfg in mesh_continuous_configs(full):
            out.update(mesh_continuous_path(device, full, mesh, name, cfg))
    finally:
        torch.distributed.destroy_process_group()
    say(f"[mesh] leg took {time.perf_counter() - t0:.1f}s")
    return out


def last_logits(engine) -> list:
    """The whole logits of the engine's latest decode step (recorded around
    its decode graph, which gathers them whole on a mesh; cloned, as the
    next replay overwrites them)."""
    seen = [None]
    decode = engine._decode

    def run(*args):
        logits, cache = decode(*args)
        seen[0] = logits.clone()
        return logits, cache

    engine._decode = run
    return seen


def mesh_serve_path(device, full: bool, mesh) -> dict:
    """``ServeEngine(mesh=)`` against ``ServeEngine()`` holding the same
    weights (the mesh engine's, drawn into their placements) for each of
    :func:`mesh_serve_configs` on the 1 x 1 mesh: greedy tokens and the last
    decode step's logits equal bit for bit, the launches of each engine's
    checked run (the counters set to 0 just before it) equal to the other's
    and to the exact count, each engine's decode replays to its decode steps
    (:func:`check_replays`); then each engine's decode step timed in turns
    plain, mesh, mesh, plain, and the mesh engine's graph against its eager
    mesh step (:func:`graph_against_eager`). Returns the mesh engines'
    launches ("serve mesh <name>": counts)."""
    out = {}
    for name, cfg, (batch, P, gen) in mesh_serve_configs(full):
        t1 = time.perf_counter()
        engines = {"mesh": ServeEngine(cfg, batch=batch, max_seq=P + gen, mesh=mesh, device=device)}
        engines["plain"] = ServeEngine(cfg, batch=batch, max_seq=P + gen, device=device)
        engines["plain"].params = full_tree(engines["mesh"].params)
        rules = engines["mesh"].rules
        prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(batch, P)).astype(np.int32)
        logits = {which: last_logits(e) for which, e in engines.items()}
        for e in engines.values():
            e.generate_batch(prompts[:, :4], 2)  # warm-up: library handles, allocator
        tokens, launches, dropped = {}, {}, []
        for which, e in engines.items():
            e.stats.update(decode_steps=0, decode_replays=0)
            zero_counters()
            with count_drops(dropped if which == "plain" else []):
                tokens[which] = e.generate_batch(prompts, gen)
            sync(device)
            launches[which] = read_counters()
            check_replays(f"serve {'mesh ' * (which == 'mesh')}{name}", e.stats, device)
        if not np.array_equal(tokens["mesh"], tokens["plain"]) or not torch.equal(logits["mesh"][0],
                                                                                   logits["plain"][0]):
            raise AssertionError(f"serve mesh {name}: the mesh engine's tokens or last logits differ from the "
                                 f"plain engine's: {tokens}")
        if cfg.family == "moe" and sum(dropped):
            raise AssertionError(f"serve mesh {name}: {sum(dropped)} picks dropped (expected none)")
        check_launches(f"serve mesh {name}", launches["mesh"], expected_launches(cfg, {P: batch}, batch, gen), device)
        if launches["mesh"] != launches["plain"]:
            raise AssertionError(f"serve mesh {name}: launches {launches['mesh']} != the plain engine's "
                                 f"{launches['plain']}")
        ms = {"plain": [], "mesh": []}
        for which in ("plain", "mesh", "mesh", "plain"):  # in turns
            e = engines[which]
            e.stats.update(decode_s=0.0, decode_tokens=0)
            e.generate_batch(prompts, gen)
            ms[which].append(e.stats["decode_s"] / gen * 1e3)
        graph_against_eager(f"serve mesh {name}", engines["mesh"], lambda: prime_batch(engines["mesh"], prompts),
                            device, full)
        # the plain engine's decode replays its graph, which runs no Python wrapper: its prefill's routings
        drops = f", {len(dropped)} prefill routings, none dropping a pick" if cfg.family == "moe" else ""
        say(f"[mesh] serve {name} ({cfg.n_layers} layers, D={cfg.d_model}, {cfg.dtype}) on a 1 x 1 mesh, rules "
            f"batch->{rules['batch']} kv_seq->{rules['kv_seq']}: {batch} x {P} prompts, {gen} greedy tokens, "
            f"tokens and last logits equal the meshless engine's bit for bit{drops} | launches {launches['mesh']} | "
            f"decode step ms (host clock, a generate_batch's decode time / {gen}, in turns plain, mesh, mesh, "
            f"plain): mesh {', '.join(f'{x:.3f}' for x in ms['mesh'])} against plain "
            f"{', '.join(f'{x:.3f}' for x in ms['plain'])}, ratio {np.mean(ms['mesh']) / np.mean(ms['plain']):.2f} | "
            f"{time.perf_counter() - t1:.1f}s")
        out[f"serve mesh {name}"] = launches["mesh"]
        del engines, logits
        free(device)
    return out


def mesh_prefix_path(device, full: bool, mesh) -> dict:
    """llava-next-mistral-7b's visual prefix (:data:`MESH_WIDE`'s config) on the 1 x 1 mesh:
    seeded patches and text through ``make_prefill_step(model, rules,
    mesh)``, then greedy ``make_serve_step`` steps, against the model's
    plain functions on the same weights: greedy tokens and the last logits
    equal bit for bit, the launches of each run (the counters set to 0 just
    before it) equal to the other's and to the exact count; then each run's
    decode steps timed in turns plain, mesh, mesh, plain. Returns the mesh
    run's launches ("serve mesh <name> prefix": counts)."""
    from repro_torch.parallel.sharding import placements_for, serve_rules
    from repro_torch.training import init_sharded_params, make_prefill_step, make_serve_step

    t1 = time.perf_counter()
    _, (batch, S, gen), _ = MESH_SERVE_RUN[full]
    name, cfg = LLAVA_ARCH, wide_config(LLAVA_ARCH, full, True)
    P, max_seq = cfg.n_patches, cfg.n_patches + S + gen
    model = build_model(cfg)
    rules = serve_rules(model, mesh, batch, max_seq)
    params = {"mesh": init_sharded_params(model, 0, mesh, resolve_tree(mesh, model.param_logical(), rules), device)}
    params["plain"] = full_tree(params["mesh"])
    g = torch.Generator(device=device).manual_seed(4)
    inputs = {"tokens": torch.randint(0, cfg.vocab_size, (batch, S), generator=g, device=device),
              "patches": torch.randn((batch, P, cfg.d_model), generator=g, device=device).to(getattr(torch, cfg.dtype))}
    feeds = {"plain": inputs, "mesh": distribute_tree(inputs, mesh, resolve_tree(mesh, model.prefill_input_logical(),
                                                                                   rules))}
    steps = {"plain": (model.prefill_fn, model.decode_fn),
             "mesh": (make_prefill_step(model, rules, mesh), make_serve_step(model, rules, mesh))}
    cache_pl = {"plain": None, "mesh": resolve_tree(mesh, model.cache_logical_fn(), rules)}
    tok_pl = placements_for(("batch", None), rules, mesh)

    @torch.no_grad()
    def generate(which: str, steps_: int):
        """(tokens, last logits, decode ms a step) of one run."""
        prefill, decode = steps[which]
        logits, cache = prefill(params[which], feeds[which])
        cache = pad_cache_to(cache, model.cache_defs_fn(batch, max_seq), cache_pl[which])
        whole = lambda t: t.full_tensor() if ops.is_dtensor(t) else t  # noqa: E731
        out = []
        sync(device)
        t = time.perf_counter()
        for i in range(steps_):
            tok = whole(logits)[:, -1].argmax(-1)[:, None]
            out.append(tok)
            if which == "mesh":
                tok = distribute(tok, mesh, tok_pl)
            logits, cache = decode(params[which], cache, tok, P + S + i)
        sync(device)
        return torch.cat(out, 1), whole(logits), (time.perf_counter() - t) * 1e3 / steps_

    for which in steps:
        generate(which, 2)  # warm-up: library handles, allocator
    runs, launches = {}, {}
    for which in steps:
        zero_counters()
        runs[which] = generate(which, gen)
        launches[which] = read_counters()
    if not torch.equal(runs["mesh"][0], runs["plain"][0]) or not torch.equal(runs["mesh"][1], runs["plain"][1]):
        raise AssertionError(f"serve mesh {name} prefix: the mesh steps' tokens or last logits differ from the plain "
                             f"functions': {runs['mesh'][0]} against {runs['plain'][0]}")
    check_launches(f"serve mesh {name} prefix", launches["mesh"], dense_launches(cfg, 1, gen), device)
    if launches["mesh"] != launches["plain"]:
        raise AssertionError(f"serve mesh {name} prefix: launches {launches['mesh']} != the plain functions' "
                             f"{launches['plain']}")
    ms = {"plain": [], "mesh": []}
    for which in ("plain", "mesh", "mesh", "plain"):  # in turns
        ms[which].append(generate(which, gen)[2])
    say(f"[mesh] serve {name} prefix ({cfg.n_layers} layers, D={cfg.d_model}, {cfg.dtype}) on a 1 x 1 mesh, rules "
        f"batch->{rules['batch']} kv_seq->{rules['kv_seq']}: {batch} x ({P} patches + {S} tokens) through "
        f"make_prefill_step, {gen} greedy make_serve_step steps: tokens and last logits equal the plain functions' "
        f"bit for bit | launches {launches['mesh']} | decode step ms (host clock, in turns plain, mesh, mesh, "
        f"plain): mesh {', '.join(f'{x:.3f}' for x in ms['mesh'])} against plain "
        f"{', '.join(f'{x:.3f}' for x in ms['plain'])}, ratio {np.mean(ms['mesh']) / np.mean(ms['plain']):.2f} | "
        f"{time.perf_counter() - t1:.1f}s")
    del params, feeds
    free(device)
    return {f"serve mesh {name} prefix": launches["mesh"]}


def mesh_continuous_path(device, full: bool, mesh, name: str, cfg) -> dict:
    """``ContinuousBatchingEngine(mesh=)`` against the meshless one holding the
    same weights, for ``cfg`` on the 1 x 1 mesh, checked and timed as
    :func:`mesh_serve_path` checks and times its engines (a serve call's
    time over its decode steps, inserts included), then its graph against its
    eager mesh step with every slot filled. Returns the mesh engine's
    launches ("serve mesh continuous <name>": counts)."""
    t1 = time.perf_counter()
    _, _, (slots, lengths, gen) = MESH_SERVE_RUN[full]
    max_seq = max(lengths) + gen
    engines = {"mesh": ContinuousBatchingEngine(cfg, batch=slots, max_seq=max_seq, mesh=mesh, device=device)}
    engines["plain"] = ContinuousBatchingEngine(cfg, batch=slots, max_seq=max_seq, device=device)
    engines["plain"].params = full_tree(engines["mesh"].params)
    rng = np.random.default_rng(3)
    requests = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32) for n in rng.choice(lengths, size=8)]
    logits = {which: last_logits(e) for which, e in engines.items()}
    for e in engines.values():
        e.serve(requests[:1], 2)  # warm-up
    outs, launches, ms = {}, {}, {"plain": [], "mesh": []}
    for which, e in engines.items():
        for key in e.stats:
            e.stats[key] = type(e.stats[key])()
        zero_counters()
        outs[which] = e.serve(requests, gen)
        sync(device)
        launches[which] = read_counters()
    st = engines["mesh"].stats
    check_replays(f"serve mesh continuous {name}", st, device)
    if any(not np.array_equal(a, b) for a, b in zip(outs["mesh"], outs["plain"])) or not torch.equal(
            logits["mesh"][0], logits["plain"][0]):
        raise AssertionError(f"serve mesh continuous {name}: the mesh engine's tokens or last logits differ")
    check_launches(f"serve mesh continuous {name}", launches["mesh"],
                   dense_launches(cfg, st["requests"], st["decode_steps"]), device)
    if launches["mesh"] != launches["plain"]:
        raise AssertionError(f"serve mesh continuous {name}: launches {launches['mesh']} != the plain "
                             f"engine's {launches['plain']}")
    for which in ("plain", "mesh", "mesh", "plain"):  # in turns
        e = engines[which]
        for key in e.stats:
            e.stats[key] = type(e.stats[key])()
        sync(device)
        t = time.perf_counter()
        e.serve(requests, gen)
        sync(device)
        ms[which].append((time.perf_counter() - t) * 1e3 / e.stats["decode_steps"])
    graph_against_eager(f"serve mesh continuous {name}", engines["mesh"],
                        lambda: prime_slots(engines["mesh"], requests), device, full)
    say(f"[mesh] serve continuous {name} ({cfg.n_layers} layers, {cfg.dtype}) on a 1 x 1 mesh: {slots} slots, "
        f"{len(requests)} requests of lengths {sorted(len(r) for r in requests)}, {st['decode_steps']} decode steps: "
        f"tokens and last logits equal the meshless engine's bit for bit | launches {launches['mesh']} | serve ms a "
        f"decode step (host clock, inserts included, in turns plain, mesh, mesh, plain): mesh "
        f"{', '.join(f'{x:.3f}' for x in ms['mesh'])} against plain {', '.join(f'{x:.3f}' for x in ms['plain'])} | "
        f"{time.perf_counter() - t1:.1f}s")
    del engines, logits
    free(device)
    return {f"serve mesh continuous {name}": launches["mesh"]}


def eco_path(device, full: bool) -> None:
    """Eco-preemption through the launcher plugin, in subprocesses with an
    empty NBI-Slurm config (the default peak and eco windows): a run started
    at the first instant of peak hours stops after one step with
    "eco-preempt", saves step 1 and prints the next eco window's --begin; the
    rerun without the flag resumes to N steps, bitwise equal to N straight
    steps (the rerun and the straight run in this process)."""
    _, (batch, seq, n) = TRAIN_RUN[full]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        config = Path(tmp) / "nbislurm.config"
        config.write_text("")
        env = {**os.environ, "NBISLURM_CONFIG": str(config),
               "PYTHONPATH": str(PLUGIN.parent.parent / "src")}
        ckpt, straight = Path(tmp) / "eco", Path(tmp) / "straight"
        argv = ["--steps", n, "--global-batch", batch, "--seq", seq, "--log-every", 1]
        t = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", DETERMINISTIC_RUN, str(PLUGIN), "train", "--arch", TRAIN_ARCH,
                              "--device", device.type, *map(str, argv), "--ckpt-dir", str(ckpt),
                              *([] if full else ["--smoke"]), "--eco-preempt", "--now", ECO_PEAK_START],
                             env=env, capture_output=True, text=True, timeout=600)
        if out.returncode:
            raise AssertionError(f"eco leg: the plugin exited {out.returncode}:\n{out.stdout[-2000:]}\n"
                                 f"{out.stderr[-3000:]}")
        say(f"[eco] the plugin's process: {time.perf_counter() - t:.1f}s")
        log = out.stdout
        begins = [line.split("--begin=", 1)[1].strip() for line in log.splitlines() if "--begin=" in line]
        manager = CheckpointManager(ckpt)
        stopped = json.loads((manager.step_dir(1) / "MANIFEST.json").read_text())["extra"].get("stopped") \
            if manager.all_steps() == [1] else None
        if "[train] step 1/" not in log or "[train] step 2/" in log or stopped != "eco-preempt" \
                or begins != [ECO_BEGIN]:
            raise AssertionError(f"eco leg: expected one step, stopped 'eco-preempt', --begin={ECO_BEGIN}; got "
                                 f"steps {manager.all_steps()}, stopped {stopped!r}, begins {begins}:\n{log}")
        say(f"[eco] started at {ECO_PEAK_START} (peak) through {PLUGIN.name}: stopped after step 1 with "
            f"'{stopped}', saved step 1, resubmit with --begin={begins[0]}")
        with deterministic(device):
            rerun = train(train_args(device, full, *argv, "--ckpt-dir", ckpt))
            train(train_args(device, full, *argv, "--ckpt-dir", straight))
        if rerun["completed_steps"] != n or len(rerun["metrics"]) != n - 1 or manager.latest_step() != n:
            raise AssertionError(f"eco leg: the rerun did not resume from step 1 to {n}: {rerun}")
        a, b = manager.step_dir(n), CheckpointManager(straight).step_dir(n)
        manifests = [json.loads((d / "MANIFEST.json").read_text()) for d in (a, b)]
        differ = [r["keypath"] for r in manifests[0]["leaves"]
                  if not filecmp.cmp(a / r["file"], b / r["file"], shallow=False)]
        if manifests[0]["leaves"] != manifests[1]["leaves"] or differ:
            raise AssertionError(f"eco leg: the resumed run differs from {n} straight steps at {differ}")
    say(f"[eco] 1 step, eco-preempt, resume to {n} == {n} straight steps, "
        f"{len(manifests[0]['leaves'])} leaves identical byte for byte; leg took {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse-cpu", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    full = not args.rehearse_cpu
    t_script = time.perf_counter()

    if full:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        device = torch.device("cuda", 0)
        smi = nvidia_smi_line()
        say(f"[device] {smi}")
        say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} | "
            f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()} | "
            f"{torch.cuda.get_device_properties(0).total_memory} bytes of device memory")
        t0 = time.perf_counter()
        lib = _build.library_path()
        say(f"[build] {lib.name} in {time.perf_counter() - t0:.2f}s")
        for r in _build.ptxas_report():
            say(f"[build] {r['source']}: {r['kernel']} | registers {r['registers']} | static smem "
                f"{r['smem_bytes']} B | spills {r['spill_store_bytes']}/{r['spill_load_bytes']} B")
        for line in _build.ptxas_warnings():
            say(f"[build] ptxas: {line}")
        for dtype in fa_kernel.DTYPES:
            say(f"[build] flash_attention {str(dtype).removeprefix('torch.')} block (rows, keys a tile, stages, "
                f"dynamic smem, threads, blocks a cluster, clusters resident): " + ", ".join(
                    f"d={d} dv={dv}: {tuple(fa_kernel.launch_config(dtype, d, dv).values())}"
                    for d, dv in fa_kernel.HEAD_DIM_PAIRS))
        configs = {(d, dtype): wkv_kernel.launch_config(d, dtype)
                   for d in wkv_kernel.HEAD_SIZES for dtype in wkv_kernel.DTYPES}
        say("[build] wkv6 threads, dynamic smem and blocks per SM: " + ", ".join(
            f"d={d} {str(dtype).removeprefix('torch.')}: {c['threads']} threads {c['smem_bytes']} B "
            f"{c['blocks_per_sm']} blocks" for (d, dtype), c in configs.items()))
        say(f"[build] moe_gating {gating_launch_line()}")
        for name, rows, D, dtype in norm_cases(full):
            say(f"[build] rmsnorm {name} ({rows} x {D} {str(dtype).removeprefix('torch.')}): "
                f"{norm_launch_line(rows, D, dtype)}")
        for name, B, T, W, dtype in lru_cases(full):
            say(f"[build] lru_scan {name} ({B} x {T} x {W} {str(dtype).removeprefix('torch.')}): "
                f"{lru_launch_line(B, T, W, dtype)}")
    else:
        device = torch.device("cpu")
        # smoke sizes: one thread runs them as fast as many, and does not stall
        # behind other processes on a loaded host
        torch.set_num_threads(1)
        say("[device] rehearsal on the CPU: plain versions, smoke sizes, no kernel is built")

    timer = Timer(device)
    t0 = time.perf_counter()
    attention = run_attention_cases(device, timer, full)
    results = {**{name: attention[case] for name, case in ATTN_JSON_CASE.items()},
               "rmsnorm": run_norm_cases(device, timer, full)["prefill_rows"],
               "lru_scan": run_lru_cases(device, timer, full),
               "wkv6": run_wkv_cases(device, timer, full),
               "moe_gating": run_gating_cases(device, timer, full)}
    say(f"[kernels] phase 3 took {time.perf_counter() - t0:.1f}s")
    free(device)
    by_path = {}
    for arch in PATHS:
        t0 = time.perf_counter()
        by_path[arch] = serve_path(arch, device, full)
        if full:
            card_matches_cpu(arch)
        say(f"[serve] {arch} phase took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    by_path[LLAVA_ARCH] = llava_path(device, full)
    if full:
        card_matches_cpu(LLAVA_ARCH)
    say(f"[serve] {LLAVA_ARCH} phase took {time.perf_counter() - t0:.1f}s")
    for arch in CONTINUOUS:
        t0 = time.perf_counter()
        by_path[f"continuous {arch}"] = continuous_path(arch, device, full)
        say(f"[continuous] {arch} phase took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    counts = []  # hold_count's rows: the dry-run leg's train paths
    by_path["train"] = train_path(device, full, counts)
    say(f"[train] {TRAIN_ARCH} phase took {time.perf_counter() - t0:.1f}s")
    for name in TRAIN_FAMILIES:
        t1 = time.perf_counter()
        by_path[f"train {name}"] = family_train_path(name, device, full, counts)
        say(f"[train] {name} phase took {time.perf_counter() - t1:.1f}s")
    t1 = time.perf_counter()
    counts.append(prefill_count_path(device, full))
    say(f"[count] the dry-run leg's steps took {time.perf_counter() - t1 + sum(r['s'] for r in counts[:-1]):.1f}s "
        f"in this process ({len(counts)} steps held against their counts, peak ratios "
        f"{[None if r['peak_ratio'] is None else round(r['peak_ratio'], 4) for r in counts]}, lower bound / step "
        f"{[round(r['bound_share'], 4) for r in counts]}); its dry-run cell runs beside the eco leg")
    by_path[f"train dp {TRAIN_ARCH}"] = dp_path(device, full)
    by_path.update(mesh_path(device, full))
    with dryrun_cell(full):  # the dry-run leg's cell, counted in a subprocess beside the untimed eco leg
        eco_path(device, full)
    say(f"[train] phase 5 took {time.perf_counter() - t0:.1f}s")
    say(f"[time] chip_smoke.py took {time.perf_counter() - t_script:.1f}s")

    kernels = [
        {"name": name, **KERNEL_INFO[name], "launches": sum(n[name] for n in by_path.values()),
         **results[name], "launches_by_path": {arch: n[name] for arch, n in by_path.items()}}
        for name in KERNEL_INFO
    ]
    # of moe_gating's launches, the calls that also ran its slots kernel
    kernels[list(KERNEL_INFO).index("moe_gating")]["slots_launches"] = sum(
        n["moe_gating_slots"] for n in by_path.values())
    # of rmsnorm's launches, those of its generic path (phases 4-5 require none)
    kernels[list(KERNEL_INFO).index("rmsnorm")]["generic_launches"] = sum(
        n["rmsnorm_generic"] for n in by_path.values())
    if not full:
        say(json.dumps({"kernels": kernels}))
        say(json.dumps({"ok": True, "rehearsal": "cpu"}))
        return 0
    say(nvidia_smi_line())  # the card's name and power limit, as nvidia-smi gives them
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
