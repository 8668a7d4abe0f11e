"""MoE gating on the card: the wrapper of ``csrc/moe_gating.cu``.

The kernels replace the Pallas TPU kernel ``repro/kernels/moe_gating.py``
(``moe_gating_pallas`` / ``_gating_kernel``); their plain version is
:func:`repro_torch.kernels.ref.moe_gating_ref`. Each group's N tokens are cut
into tiles of :data:`TILE` tokens, one block per (group, tile), so that a
call's rows spread over every SM. The route kernel computes idx and gate a
warp per row and counts each tile's picks per (rank, expert); a group of one
tile (a decode step) gets its slots in the same launch. When a group has more
tiles, the slots kernel turns the counts (a scratch tensor (G, T, k, E)
int32, allocated per call) into each tile's first slots and gives every pick
its slot. Each slots block reads all T counts of its group, so a group costs
T² k E loads: 98304 at deepseek-moe-16b's prefill group (N 1024, T 16, k 6,
E 64), 1.1e8 at a group of 30000 tokens at k 8 (T 469), which no served path
gives. :func:`launch_config` reads both launches back from the library.

The wrapper checks what the kernels take and raises on anything else,
allocates the outputs, and launches on PyTorch's current stream without
synchronising.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_EXPERTS = 384  # kimi-k2's routed experts
MAX_TOP_K = 32  # one pick per lane of a warp
INT_MAX = 2**31 - 1
TILE = 64  # tokens a block; the library's TILE, which launch_config reports

# Calls that launched the kernels since import (one per call, whether it
# launched one kernel or two), and of those the calls that also launched the
# slots kernel. chip_smoke.py sets both to 0 around the main path and reads
# them to show that every MoE layer's routing came here.
launches = 0
slots_launches = 0


def _check_sizes(N: int, E: int, top_k: int) -> None:
    if E > MAX_EXPERTS or not 1 <= top_k <= min(E, MAX_TOP_K):
        raise ValueError(f"moe_gating: E {E} and top_k {top_k} need E <= {MAX_EXPERTS} and "
                         f"1 <= top_k <= min(E, {MAX_TOP_K})")
    if N * top_k > INT_MAX:
        raise ValueError(f"moe_gating: a group of {N} tokens at top_k {top_k} has more picks than "
                         f"the kernels count in int32")


def launch_config(N: int, E: int, top_k: int) -> dict:
    """The launches for groups of ``N`` tokens over ``E`` experts at
    ``top_k``, as the library reports them: tiles a group, and per kernel
    threads and dynamic shared memory per block, registers per thread and
    blocks resident per SM on the current device. The slots kernel runs only
    when a group has more than one tile. Builds the library, so it needs the
    card."""
    _check_sizes(N, E, top_k)
    out = (ctypes.c_int * 9)()
    _build.check(_build.library().repro_moe_gating_config(N, E, top_k, out), "moe_gating config")
    keys = ("threads", "smem_bytes", "registers", "blocks_per_sm")
    return {"tiles": out[0], "route": dict(zip(keys, out[1:5])), "slots": dict(zip(keys, out[5:9]))}


def check_inputs(logits, top_k: int, capacity: int) -> None:
    """The checks of what the kernels take that do not depend on the device
    (the ``meta`` route of :mod:`repro_torch.kernels.ops` makes them too)."""
    if logits.dtype != torch.float32:
        raise TypeError(f"moe_gating: logits must be float32, got {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("moe_gating: logits must be contiguous")
    if logits.dim() != 3 or 0 in logits.shape:
        raise ValueError(f"moe_gating: logits {tuple(logits.shape)} must be a non-empty (G, N, E)")
    G, N, E = logits.shape
    _check_sizes(N, E, top_k)
    if capacity < 0:
        raise ValueError(f"moe_gating: capacity {capacity} < 0")
    if G * -(-N // TILE) > INT_MAX:
        raise ValueError(f"moe_gating: {G} groups of {-(-N // TILE)} tiles are more blocks than a grid holds")


def outputs(logits, top_k: int) -> tuple:
    """What a call allocates on the logits' device: idx, gate and pos
    (G, N, k), and the slots kernel's per-tile histogram (None where a group
    is one tile and the slots kernel does not run)."""
    G, N, E = logits.shape
    tiles = -(-N // TILE)
    idx = torch.empty((G, N, top_k), dtype=torch.int32, device=logits.device)
    gate = torch.empty((G, N, top_k), dtype=torch.float32, device=logits.device)
    pos = torch.empty((G, N, top_k), dtype=torch.int32, device=logits.device)
    hist = torch.empty((G, tiles, top_k, E), dtype=torch.int32, device=logits.device) if tiles > 1 else None
    return idx, gate, pos, hist


def launch_counts(N: int) -> tuple:
    """The counts a call on groups of N tokens adds one to: ``launches``, and
    ``slots_launches`` where a group spans more than one tile."""
    return ("launches", "slots_launches") if N > TILE else ("launches",)


def moe_gating(logits, *, top_k: int, capacity: int, renormalise: bool = True):
    """logits: (G, N, E) f32, contiguous, on CUDA, with 1 <= top_k <= E,
    top_k <= 32, E <= 384, capacity >= 0 and N·top_k within int32. Returns
    (idx (G, N, k) int32, gate (G, N, k) f32, pos (G, N, k) int32)."""
    if logits.device.type != "cuda":
        raise ValueError(f"moe_gating: logits on {logits.device}, the kernel needs a CUDA device")
    check_inputs(logits, top_k, capacity)
    G, N, E = logits.shape
    idx, gate, pos, hist = outputs(logits, top_k)
    lib = _build.library()
    with torch.cuda.device(logits.device):
        err = lib.repro_moe_gating_fwd(
            logits.data_ptr(), idx.data_ptr(), gate.data_ptr(), pos.data_ptr(),
            None if hist is None else hist.data_ptr(), G, N, E, top_k, capacity, int(renormalise),
            torch.cuda.current_stream(logits.device).cuda_stream,
        )
    _build.check(err, "moe_gating")
    for name in launch_counts(N):
        globals()[name] += 1
    return idx, gate, pos
