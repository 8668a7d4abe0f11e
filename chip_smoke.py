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
   greedy requests through nbi-100m, recurrentgemma-2b, rwkv6-7b,
   deepseek-moe-16b, kimi-k2-1t-a32b (full width, 2 of its 61 layers: 384
   experts, top-8, groups of 256), minicpm3-4b (MLA), starcoder2-7b,
   mistral-large-123b (full width, 8 of its 88 layers) and whisper-small
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
   a small model of each family, then trace one batch with torch.profiler
   (device busy share, each of the port's kernels' share of the prefill's
   device time, and the ops that take the most device time); then
   continuous batching (``ContinuousBatchingEngine``, 8 slots, 16 requests
   of mixed lengths) on minicpm3-4b at full width, on nbi-100m and on
   codeqwen1.5-7b at full width and depth, with f32 activations: exact
   launches per insert and decode step (each insert's attentions through the
   f32 tensor-core (3xTF32) kernel of its heads: the MLA kernel at (96, 64),
   the d 64 kernel, the d 128 kernel; none through the FMA kernel), every chosen
   token within 1e-3 of the max logit of a full forward over its request,
   and decode steps against the static bound; then inserts into the live
   cache beside a slot part-way through its generation, with the same
   checks, exact launches, and the first request's tokens equal to a run of
   it alone;
5. training: train nbi-100m at full width and depth through
   ``repro_torch.launch.train`` (global batch 8 x 512 tokens, 30 AdamW steps
   with cosine warmup, the port's data pipeline, seeded weights drawn on the
   card) with the launch counters set to 0 just before and read just after:
   every forward's 12 attentions through the f32 tensor-core (3xTF32)
   flash-attention kernel and its 25 norms through the RMSNorm kernel, the
   backward (the plain path recomputed) through neither; the loss must fall.
   Then train tok/s, step ms and peak memory, one step traced with
   torch.profiler (device busy share, K1's and K2's shares, top ops), one
   train step of a small model on the card against the CPU, and resume
   equivalence: 2N straight steps against N steps, a checkpoint, a fresh
   restore and N more, bitwise under ``torch.use_deterministic_algorithms``.
   Then train deepseek-moe-16b (4 of 28 layers), rwkv6-7b (8 of 32),
   recurrentgemma-2b (14 of 26) and whisper-small (all 12 + 12 layers, 8
   rows of 448 tokens against 8 x 1500 seeded audio frames, which the data
   pipeline does not make) at full width for 10 steps each through the
   launcher's pieces (the config's optimizer with cosine warmup, the train
   state drawn on the card, the train step, the data pipeline), with the
   counts set to 0 just before and read just after: under remat "full"
   every forward kernel runs twice a step (the forward, then the backward's
   recompute of each layer), K5 (route and slots) per MoE routing, K4 per
   RWKV-6 layer, K3 per recurrent layer, K1 per attention layer (Whisper's
   encoder, self- and cross-attentions), K2 per RMSNorm, and no backward
   launches one; the loss must fall. Then each
   family's step ms, tok/s, peak memory, one traced step and a small
   model's train step on the card against the CPU.

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

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa_kernel  # noqa: E402
from repro_torch.kernels import moe_gating as gating_kernel  # noqa: E402
from repro_torch.kernels import rglru_scan as lru_kernel  # noqa: E402
from repro_torch.kernels import rmsnorm as rn_kernel  # noqa: E402
from repro_torch.kernels import rwkv6_scan as wkv_kernel  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data import make_train_loader  # noqa: E402
from repro_torch.launch.serve import ContinuousBatchingEngine, ServeEngine, device_name, pad_cache_to  # noqa: E402
from repro_torch.launch.train import build_argparser as train_argparser  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import rglru as rg  # noqa: E402
from repro_torch.models.common import map_defs, tree_leaves  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.optim import cosine_warmup, make_optimizer  # noqa: E402
from repro_torch.training import init_train_state, make_train_step  # noqa: E402

# Published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet):
# dense rates without sparsity, f32 outside the tensor cores, TF32 on them.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12, "tf32": 495e12}
PEAK_BYTES_PER_S = 3.35e12

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
    # K1 has six kernels: f32 on the FMA units (the f32 head-dim pairs other
    # than (64, 64), (96, 64) and (128, 128)), bf16 on the tensor cores, bf16
    # at (96, 64), and f32 at (64, 64), at (96, 64) and at (128, 128) on the
    # tensor cores as 3xTF32
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:111",
    ),
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
    # the f32 (3xTF32) kernel at (d, dv) = (128, 128), 16-key tiles
    "flash_attention_tf32_d128": dict(
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
COUNTERS = {"flash_attention": (fa_kernel, "launches"), "flash_attention_bf16": (fa_kernel, "bf16_launches"),
            "flash_attention_bf16_mla": (fa_kernel, "bf16_mla_launches"),
            "flash_attention_tf32": (fa_kernel, "tf32_launches"),
            "flash_attention_tf32_mla": (fa_kernel, "tf32_mla_launches"),
            "flash_attention_tf32_d128": (fa_kernel, "tf32_d128_launches"), "rmsnorm": (rn_kernel, "launches"),
            "rmsnorm_generic": (rn_kernel, "generic_launches"),
            "lru_scan": (lru_kernel, "launches"), "wkv6": (wkv_kernel, "launches"),
            "moe_gating": (gating_kernel, "launches"), "moe_gating_slots": (gating_kernel, "slots_launches")}
# the phase-3 case whose numbers stand for each attention kernel in the JSON
# line: a shape a main path gives it (the FMA kernel, on no main path: f32 at
# Griffin's d 256)
ATTN_JSON_CASE = {"flash_attention": "d256_f32", "flash_attention_bf16": "deepseek_prefill",
                  "flash_attention_bf16_mla": "mla_prefill", "flash_attention_tf32": "nbi100m_prefill",
                  "flash_attention_tf32_mla": "mla_f32_insert", "flash_attention_tf32_d128": "codeqwen_f32_insert"}
# a part of each kernel's name as the profiler shows it; a kernel goes to the
# first name it matches
TRACE_NAMES = {"flash_attention": "flash_attn_f32_kernel",
               "flash_attention_bf16_mla": "flash_attn_bf16_mla_kernel",
               "flash_attention_bf16": "flash_attn_bf16_kernel",
               "flash_attention_tf32_mla": "flash_attn_tf32_mla_kernel",
               "flash_attention_tf32_d128": "flash_attn_tf32_d128_kernel",
               "flash_attention_tf32": "flash_attn_tf32_kernel", "rmsnorm": "rmsnorm_",
               "lru_scan": "lru_scan_kernel", "wkv6": "wkv6_kernel", "moe_gating": "moe_gating_"}


def trace_shares(kernels) -> dict:
    """Device ms of each of the port's kernels among the profiler's kernel
    entries, each entry counted once, under the first name it matches."""
    ms = dict.fromkeys(TRACE_NAMES, 0.0)
    for e in kernels:
        name = next((n for n, part in TRACE_NAMES.items() if part in e.key), None)
        if name:
            ms[name] += e.self_device_time_total / 1e3
    return ms


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


def bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    """The least time for the work in ms, and which of operations and bytes
    sets it; ``dtype`` picks the peak rate (``"tf32"``: the tensor cores' TF32
    rate)."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


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
    tiles, 32 query heads over 8 KV heads as mistral's), and edges of the bf16 kernel's TMA boxes and 64-key tiles
    at full size; last, the shapes the train paths and kimi-k2's serving give
    the bf16 kernel (deepseek-moe-16b's 4 x 2048, recurrentgemma-2b's MQA
    d 256 under its window at 2 x 2048, kimi-k2's 64 over 8 heads at 8 x
    1024); then whisper-small's bf16 d 64 kernel as its prefill batch of 8
    gives it: the encoder over 1500 frames (ragged against the 128-row blocks
    and the 64-key tiles), cross-attention from 384 prompt tokens over them,
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
            ("gqa_bf16", 1, 8, 2, 24, 24, 16, 16, bf16, True, 0, 0.0),
            ("ragged", 1, 4, 4, 13, 13, 16, 16, f32, True, 0, 0.0),
            ("window", 1, 4, 4, 24, 24, 16, 16, f32, True, 8, 0.0),
            ("logit_cap", 1, 4, 4, 16, 16, 16, 16, f32, True, 0, 30.0),
            ("non_causal", 1, 4, 4, 10, 20, 16, 16, f32, False, 0, 0.0),
            ("ragged_non_causal_bf16", 1, 4, 4, 13, 40, 16, 16, bf16, False, 0, 0.0),
            ("mqa_d256_window_bf16", 1, 4, 1, 23, 23, 16, 16, bf16, True, 8, 0.0),
            ("deepseek_train", 2, 4, 4, 32, 32, 16, 16, bf16, True, 0, 0.0),
            ("griffin_train", 2, 4, 1, 16, 16, 16, 16, bf16, True, 8, 0.0),
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
        ("gqa_bf16_s2048", 1, 32, 8, 2048, 2048, 128, 128, bf16, True, 0, 0.0),
        ("ragged_s300", 2, 12, 12, 300, 300, 64, 64, f32, True, 0, 0.0),
        ("window_128", 2, 12, 12, 512, 512, 64, 64, f32, True, 128, 0.0),
        ("logit_cap_30", 2, 12, 12, 512, 512, 64, 64, f32, True, 0, 30.0),
        ("non_causal_sq200_skv512", 2, 12, 12, 200, 512, 64, 64, f32, False, 0, 0.0),
        ("ragged_non_causal_bf16", 2, 16, 16, 333, 1000, 128, 128, bf16, False, 0, 0.0),
        ("mqa_d256_window_bf16", 2, 10, 1, 2300, 2300, 256, 256, bf16, True, 2048, 0.0),
        ("deepseek_train", 4, 16, 16, 2048, 2048, 128, 128, bf16, True, 0, 0.0),
        ("griffin_train", 2, 10, 1, 2048, 2048, 256, 256, bf16, True, 2048, 0.0),
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


def valid_pairs(Sq: int, Skv: int, causal: bool, window: int, device) -> int:
    """(q, k) pairs the mask keeps: the work a causal or windowed call needs."""
    q_pos = torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Skv, device=device)[None, :]
    keep = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        keep &= k_pos <= q_pos
    if window > 0:
        keep &= q_pos - k_pos < window
    return int(keep.sum())


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
        pairs = B * Hq * valid_pairs(Sq, Skv, causal, window, device)
        flops = pairs * (2 * d + 2 * dv)  # q·k and p·v per kept pair, at the real (not the tiles') widths
        nbytes = (q.numel() + k.numel() + v.numel() + got.numel()) * q.element_size()
        bound_ms, bound_by = bound(flops, nbytes, dtype)
        bounds = ""
        if dtype == torch.float32:
            # the same function as three TF32 products on the tensor cores;
            # the tensor-core kernel is held against this bound
            tf32_ms, tf32_by = bound(3 * flops, nbytes, "tf32")
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
        nbytes = (2 * x.numel()) * x.element_size() + w.numel() * w.element_size()
        bound_ms, bound_by = bound(4 * x.numel(), nbytes, dtype)
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
        nbytes = 3 * a.numel() * a.element_size() + 2 * h0.numel() * 4  # a, b in; h out; h0 in, h_final out
        bound_ms, bound_by = bound(2 * a.numel(), nbytes, torch.float32)
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
        # r, k, v, w in and y out; u in; s0 in and S_final out
        nbytes = 5 * r.numel() * r.element_size() + u.numel() * 4 + 2 * s0.numel() * 4
        # the sequential form: about 5 f32 operations per state element per token
        bound_ms, bound_by = bound(5 * B * H * T * d * d, nbytes, torch.float32)
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=None)
        say(f"[kernels] wkv6 {name}: B={B} H={H} T={T} d={d} {str(dtype).removeprefix('torch.')} "
            f"s0 {'nonzero' if carried else 'zero'} | max_abs_err={err:.3e} kernel={ms:.4f}ms "
            f"plain={plain_ms:.4f}ms library=none bound={bound_ms:.4f}ms ({bound_by}) "
            f"GFLOP={5 * B * H * T * d * d / 1e9:.3f} MB={nbytes / 1e6:.1f}")
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
        nbytes = x.numel() * 4 + 3 * G * N * k * 4  # logits in; idx, gate, pos out
        # softmax (max, subtract, exp, add, divide) and k rounds of compares per logit
        bound_ms, bound_by = bound((5 + k) * x.numel(), nbytes, torch.float32)
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=None)
        say(f"[kernels] moe_gating {name}: G={G} N={N} E={E} k={k} capacity={cap} logit scale={scale} "
            f"skew={skew} | idx and pos exact, {dropped} of {pos.numel()} picks dropped, gate max_abs_err="
            f"{err:.3e} kernel={ms:.4f}ms plain={plain_ms:.4f}ms library=none bound={bound_ms:.4f}ms "
            f"({bound_by}) MB={nbytes / 1e6:.2f}")
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
# layer and one MoE layer of 384 experts are 19.97 B, about 40 GB in bf16)
REDUCED_DEPTH = {"mistral-large-123b": 8, "kimi-k2-1t-a32b": 2}
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
    # full width and depth: 32 layers of 32 heads of 128, about 16 GB of bf16
    # weights and an f32 cache of 8 x 1032 tokens (8.65 GB)
    "codeqwen1.5-7b": ((8, (64, 200, 512, 1000), 32), (2, (5, 8, 12), 4)),
}


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
    # by kernel_kind, not launch_count: chip_variants.py runs this with older
    # trees' wrappers
    kind, mla = fa_kernel.kernel_kind(getattr(torch, cfg.dtype), d, dv), (d, dv) == fa_kernel.MLA_HEAD_DIMS
    if kind == fa_kernel.BF16 and mla:
        return "flash_attention_bf16_mla"
    if kind == fa_kernel.F32_TF32 and mla:
        return "flash_attention_tf32_mla"
    if kind == fa_kernel.F32_TF32 and (d, dv) == (128, 128):
        return "flash_attention_tf32_d128"
    return {fa_kernel.BF16: "flash_attention_bf16", fa_kernel.F32_TF32: "flash_attention_tf32",
            fa_kernel.F32_SIMT: "flash_attention"}[kind]


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
    del engine, outs
    free(device)
    return launches


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
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    run(gen_len)  # warm the shapes
    runs = {}
    for steps in (0, gen_len):
        with profile(activities=acts) as prof:
            pre_ms, dec_ms = run(steps)
        kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        runs[steps] = (pre_ms, dec_ms, busy_ms, kernels)
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
    ``engine._insert`` into slot s of the live cache just before decode step
    t, for each (t, s, prompt) of ``arrivals``, while the other slots keep
    decoding. Returns each request's ``gen_len`` tokens and the decode steps."""
    B, device = engine.batch, engine.device
    cache = {n: torch.zeros(d.shape, dtype=d.dtype, device=device)
             for n, d in engine.model.cache_defs_fn(B, engine.max_seq).items()}
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
        logits, _ = engine.model.decode_fn(engine.params, cache, torch.as_tensor(tok[:, None], device=device),
                                           torch.as_tensor(pos, device=device))
        nxt = logits[:, -1].argmax(-1).cpu().numpy()
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
    zero_counters()
    staggered, steps = drive_staggered(engine, arrivals, gen_len)
    sync(device)
    staggered_launches = read_counters()
    check_launches(f"{cfg.name} staggered inserts", staggered_launches, dense_launches(cfg, len(arrivals), steps),
                   device)
    worst = largest_gap(engine, [a, b, c], staggered, device)
    say(f"[continuous] {cfg.name} staggered inserts (step, slot, prompt length) "
        f"{[(t, s, len(p)) for t, s, p in arrivals]}, {steps} decode steps: a's tokens equal a run of a alone: "
        f"{bool((staggered[0] == alone).all())}; largest gap to a full forward's max logit {worst:.3e} "
        "(tolerance 1e-3)")
    if not (staggered[0] == alone).all() or worst > 1e-3:
        raise AssertionError(f"{cfg.name}: an insert beside a decoding slot changed the tokens")
    launches = {name: n + staggered_launches[name] for name, n in launches.items()}
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
        with count_drops(dropped if name == "cpu" else []):
            last, cache = model.prefill_fn(params, {k: v.to(name) for k, v in host_batch.items()})
            cache = pad_cache_to(cache, model.cache_defs_fn(2, S + 8))
            nxt = torch.full((2, 1), 7, device=name)
            step, _ = model.decode_fn(params, cache, nxt, S)
        outs[name] = (last.cpu(), step.cpu())
    worst = max(float((a - b).abs().max()) for a, b in zip(outs["cuda"], outs["cpu"]))
    drops = f", {sum(dropped)} picks dropped over {len(dropped)} routings" if cfg.family == "moe" else ""
    say(f"[serve] small {cfg.family} model ({arch} smoke, {overrides}), card against CPU: "
        f"max abs logit err {worst:.3e} (tolerance 1e-4){drops}")
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
# the other families trained at full width: arch: (layers, global batch,
# sequence); depth cut so that weights, gradients and AdamW state fit one card
# (deepseek-moe-16b: its leading dense layer and 3 MoE layers of 28; rwkv6-7b
# 8 of 32; recurrentgemma-2b 14 of 26, 4 super-layers and 2 tail pairs: all 26
# ran out of an H100 80GB's memory at 74.2 GiB, the AdamW update holding old and
# new weights and moments and two f32 gradient trees). RWKV-6's sequence is a
# multiple of 64 (the gradient's chunked form); MoE's 4 x 2048 tokens are 8
# groups of 1024. whisper-small trains at its full depth (12 + 12 layers) on
# 8 rows of 448 tokens, its published decoder context, each against 1500
# seeded audio frames
TRAIN_FAMILIES = {"deepseek-moe-16b": (4, 4, 2048), "rwkv6-7b": (8, 4, 2048), "recurrentgemma-2b": (14, 2, 2048),
                  "whisper-small": (12, 8, 448)}
# steps and warmup of each family's run (one more step is traced), at full
# size and in the CPU rehearsal (smoke configs at 4 x 32 under their full
# configs' remat)
TRAIN_FAMILY_RUN = {True: (10, 3), False: (3, 1)}
# arch: (overrides of the smoke config, (batch, sequence)) of the card-against-
# CPU train step: the kernels' real head widths, the families' remat "full"
TRAIN_SMALL_MODELS = {
    TRAIN_ARCH: (SMALL_MODELS[TRAIN_ARCH][0], (4, 64)),
    "deepseek-moe-16b": ({**SMALL_MODELS["deepseek-moe-16b"][0], "remat": "full"}, (4, 64)),
    "rwkv6-7b": ({**SMALL_MODELS["rwkv6-7b"][0], "remat": "full"}, (2, 128)),
    "recurrentgemma-2b": ({**SMALL_MODELS["recurrentgemma-2b"][0], "remat": "full"}, (2, 64)),
    "whisper-small": ({**SMALL_MODELS["whisper-small"][0], "remat": "full"}, (4, 64)),
}


def train_args(device, full: bool, *argv):
    return train_argparser().parse_args(
        ["--arch", TRAIN_ARCH, "--device", device.type, *map(str, argv), *([] if full else ["--smoke"])])


def train_path(device, full: bool) -> dict:
    """Train nbi-100m through the launcher with the launch counters set to 0
    just before and read just after; then the step trace, the card against
    the CPU and resume equivalence. Returns the launches of each kernel."""
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
    losses = [m["loss"] for m in result["metrics"]]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{cfg.name} training: the loss did not fall: {losses}")
    step_ms = np.diff(stamps[2:]) * 1e3  # the first steps warm up the allocator and library handles
    med = float(np.median(step_ms))
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        memory = (f"max_memory_allocated {peak / 2**20:.1f} MiB ({held_before / 2**20:.1f} MiB held before "
                  f"the run)")
    else:
        memory = "max_memory_allocated not measured (cpu)"
    say(f"[train] {cfg.name} on {device_name(device)}: wall {wall:.3f}s for {steps} steps | loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} | step ms median {med:.3f} (min {step_ms.min():.3f}, max "
        f"{step_ms.max():.3f}, steps 4 to {steps}) = {batch * seq / med * 1e3:.1f} tok/s | {memory}")
    free(device)
    trace_train_step(device, cfg, batch, seq, med)
    free(device)
    if full:
        train_card_matches_cpu()
    resume_equivalence(device, full)
    free(device)
    return launches


def expected_train_launches(cfg, batch: int, seq: int, steps: int) -> dict:
    """Each step's forward through the kernels, twice under remat "full" (the
    forward, then the backward's recompute of each wrapped layer); every
    backward launches none. Dense and MoE: K1 and 2 norms a layer, and for
    MoE K5 a routing (and its slots kernel where a group spans more than one
    tile); RWKV-6: K4 a layer; Griffin: K3 a recurrent layer, K1 an attention
    layer, 2 norms a layer; then the final norm once; Whisper: K1 an encoder
    layer and twice a decoder layer (self- and cross-attention), no norm
    kernel (its norms are LayerNorms)."""
    if cfg.remat not in ("none", "full"):
        raise ValueError(f"no launch count for remat {cfg.remat!r}")
    r = 2 if cfg.remat == "full" else 1
    L = cfg.n_layers
    want = dict.fromkeys(COUNTERS, 0)
    if cfg.family in ("dense", "moe"):
        want.update({attention_counter(cfg): r * L * steps, "rmsnorm": (2 * r * L + 1) * steps})
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


def family_train_path(arch: str, device, full: bool) -> dict:
    """Train ``arch`` at full width and TRAIN_FAMILIES' depth through the
    launcher's pieces (the config's optimizer with cosine warmup, the train
    state drawn on the card, the train step, the data pipeline) with the
    launch counters set to 0 just before the steps and read just after; the
    loss must fall. Then step ms, tok/s and peak memory, one more step traced
    and, on the card, a small model's step against the CPU. Returns the
    launches of each kernel."""
    steps, warmup = TRAIN_FAMILY_RUN[full]
    if full:
        layers, batch, seq = TRAIN_FAMILIES[arch]
        cfg = get_config(arch).replace(n_layers=layers)
    else:
        batch, seq = 4, 32
        cfg = get_smoke_config(arch).replace(remat=get_config(arch).remat)
    held_before = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = build_model(cfg)
    opt = make_optimizer(cfg.optimizer, lr=cosine_warmup(3e-4, warmup, steps))
    state = init_train_state(model, opt, torch.Generator(device=device).manual_seed(0), device)
    step = make_train_step(model, opt)
    loader = make_train_loader(model.cfg.vocab_size, batch, seq, seed=0)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in next(loader).items()} for _ in range(steps + 1)]
    loader.close()
    add_frames(cfg, batches, device)
    sync(device)
    say(f"[train] {shape_line(cfg, model.cfg.vocab_size)} | remat={cfg.remat} {cfg.optimizer}, cosine warmup "
        f"{warmup} | {steps} steps of {batch} x {seq} tokens | state built in {time.perf_counter() - t0:.2f}s")
    zero_counters()
    losses, aux, stamps = [], [], [time.perf_counter()]
    for b in batches[:steps]:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))  # waits for the step
        aux.append(float(metrics.get("aux_loss", math.nan)))
        stamps.append(time.perf_counter())
    launches = read_counters()
    check_launches(f"{cfg.name} training", launches, expected_train_launches(cfg, batch, seq, steps), device)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{cfg.name} training: the loss did not fall: {losses}")
    step_ms = np.diff(stamps[2:]) * 1e3  # the first two steps warm up the allocator and library handles
    med = float(np.median(step_ms))
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        memory = (f"max_memory_allocated {peak / 2**20:.1f} MiB ({held_before / 2**20:.1f} MiB held before "
                  f"the run)")
    else:
        memory = "max_memory_allocated not measured (cpu)"
    aux_line = f" | aux_loss {aux[0]:.4f} -> {aux[-1]:.4f}" if cfg.family == "moe" else ""
    first = ", ".join(f"{x:.1f}" for x in np.diff(stamps[:3]) * 1e3)
    say(f"[train] {cfg.name} on {device_name(device)}: losses {[round(x, 4) for x in losses]}{aux_line} | "
        f"step ms median {med:.3f} (min {step_ms.min():.3f}, max {step_ms.max():.3f}, steps 3 to {steps}; "
        f"steps 1 and 2: {first}) = {batch * seq / med * 1e3:.1f} tok/s | {memory}")

    def traced():
        nonlocal state
        state, metrics = step(state, batches[steps])
        float(metrics["loss"])

    if full:  # the CPU rehearsal records no kernel (nbi-100m's trace rehearses profile_step)
        profile_step(device, traced, f"{cfg.name} {batch}x{seq}", med)
    del state, batches, step
    free(device)
    if full:
        train_card_matches_cpu(arch)
    return launches


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


def trace_train_step(device, cfg, batch: int, seq: int, step_ms: float) -> None:
    """One nbi-100m train step (after two warm-up steps) under torch.profiler,
    from a fresh state (the launcher's is gone): :func:`profile_step`."""
    model = build_model(cfg)
    opt = make_optimizer(cfg.optimizer, lr=cosine_warmup(3e-4, 10, 30))
    state = init_train_state(model, opt, torch.Generator(device=device).manual_seed(0), device)
    step = make_train_step(model, opt)
    loader = make_train_loader(model.cfg.vocab_size, batch, seq, seed=0)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in next(loader).items()} for _ in range(3)]
    loader.close()
    for b in batches[:2]:
        state, metrics = step(state, b)
    float(metrics["loss"])
    profile_step(device, lambda: float(step(state, batches[2])[1]["loss"]), f"{batch}x{seq}", step_ms)


def profile_step(device, run_step, what: str, step_ms: float) -> None:
    """``run_step()`` (one train step that waits for its loss) under
    torch.profiler: device busy time against the host's wall time under the
    profiler and against ``step_ms``, the median step without it; each of the
    port's kernels' share of the step's device time, and the ops that take
    the most device time."""
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    # the card's kernels only: recording every host op of a step of tens of
    # thousands of ops costs more than the step
    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_step()
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
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


def train_card_matches_cpu(arch: str = TRAIN_ARCH) -> None:
    """One AdamW step of ``arch``'s small model (:data:`TRAIN_SMALL_MODELS`)
    from the same host-drawn weights and batch on the card and on the CPU.

    Tolerances. Loss rtol 1e-5 and grad_norm rtol 1e-4: K1's 3xTF32 products
    keep about 22 bits (atol 2e-5 on attention outputs) and the f32 GEMMs
    sum in other orders. The clipped gradients, read from the new first
    moment m = 0.1 g, within 1e-4 of each leaf's largest. The new params:
    Adam's first step moves an entry by lr g / (|g| + eps) (plus the same
    weight decay on both), so each entry may differ by lr |f(g1) - f(g2)|,
    f(g) = g / (|g| + eps), from the two runs' own g, plus 1e-6: tight where
    a gradient is well above its rounding, loose only where it is at its
    noise floor, where the two runs' g may even differ in sign."""
    overrides, (batch, seq) = TRAIN_SMALL_MODELS[arch]
    cfg = get_smoke_config(arch).replace(**overrides)
    model = build_model(cfg)
    opt = make_optimizer("adamw", lr=TRAIN_SMALL_LR)
    host_params = model.init(torch.Generator().manual_seed(3), "cpu")
    if arch != TRAIN_ARCH:
        host_params = liven(host_params)
    loader = make_train_loader(model.cfg.vocab_size, batch, seq, seed=5)
    host_batch = {k: torch.from_numpy(v) for k, v in next(loader).items()}
    loader.close()
    add_frames(cfg, [host_batch], torch.device("cpu"))
    outs = {}
    for name in ("cuda", "cpu"):
        params = map_defs(lambda t: t.to(name), host_params)
        state = {"params": params, "opt": opt.init(params), "step": torch.zeros((), dtype=torch.int32, device=name)}
        new_state, metrics = make_train_step(model, opt)(state, {k: v.to(name) for k, v in host_batch.items()})
        outs[name] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                      {p: t.cpu() for p, t in tree_leaves(new_state["params"])},
                      {p: t.cpu() / 0.1 for p, t in tree_leaves(new_state["opt"]["m"])})
    (loss_c, gn_c, p_c, g_c), (loss_h, gn_h, p_h, g_h) = outs["cuda"], outs["cpu"]
    g_err = max(float((g_c[k] - g_h[k]).abs().max() / g_h[k].abs().max().clamp_min(1e-30)) for k in g_h)
    def adam_step(g):
        return g / (g.abs() + 1e-8)

    p_excess = max(float(((p_c[k] - p_h[k]).abs()
                          - TRAIN_SMALL_LR * (adam_step(g_c[k]) - adam_step(g_h[k])).abs()).max()) for k in p_h)
    p_err = max(float((p_c[k] - p_h[k]).abs().max()) for k in p_h)
    say(f"[train] small {cfg.family} model ({arch} smoke, {overrides}, remat {cfg.remat}, {batch} x {seq} "
        f"tokens), one AdamW step, card against CPU: "
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
    manifests and leaf files are identical, byte for byte. Every step is
    inside the default warmup of 20, where the learning rate does not depend
    on ``--steps`` (as in the reference's own resume test)."""
    _, (batch, seq, n) = TRAIN_RUN[full]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, deterministic(device):
        def run(steps, name, every):
            return train(train_args(device, full, "--steps", steps, "--global-batch", batch, "--seq", seq,
                                    "--ckpt-dir", Path(tmp) / name, "--ckpt-every", every, "--log-every", 100))

        run(2 * n, "straight", 2 * n)
        run(n, "split", n)
        run(2 * n, "split", n)
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
        f"{len(manifests[0]['leaves'])} leaves ({nbytes / 2**20:.1f} MiB) identical byte for byte, "
        f"{time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse-cpu", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    full = not args.rehearse_cpu

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
            f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
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
                f"dynamic smem, threads): " + ", ".join(
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
    by_path["train"] = train_path(device, full)
    say(f"[train] {TRAIN_ARCH} phase took {time.perf_counter() - t0:.1f}s")
    for arch in TRAIN_FAMILIES:
        t1 = time.perf_counter()
        by_path[f"train {arch}"] = family_train_path(arch, device, full)
        say(f"[train] {arch} phase took {time.perf_counter() - t1:.1f}s")
    say(f"[train] phase 5 took {time.perf_counter() - t0:.1f}s")

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
