"""MoE gating on the card: the wrapper of ``csrc/moe_gating.cu``.

The kernel replaces the Pallas TPU kernel ``repro/kernels/moe_gating.py``
(``moe_gating_pallas`` / ``_gating_kernel``); its plain version is
:func:`repro_torch.kernels.ref.moe_gating_ref`. The wrapper checks what the
kernel takes and raises on anything else, allocates the outputs, and launches
on PyTorch's current stream without synchronising.
"""

from __future__ import annotations

import torch

from . import _build

MAX_EXPERTS = 384  # kimi-k2's routed experts
MAX_TOP_K = 32  # one pick per lane of a warp
MAX_SMEM_BYTES = 232448  # what a Hopper block may opt into

# Kernel launches since import. chip_smoke.py sets it to 0 around the
# main path and reads it to show that every MoE layer's routing came here.
launches = 0


def moe_gating(logits, *, top_k: int, capacity: int, renormalise: bool = True):
    """logits: (G, N, E) f32, contiguous, on CUDA, with 1 <= top_k <= E,
    top_k <= 32, E <= 384, capacity >= 0 and N·top_k + top_k·E int32 of
    shared memory within a block's 232,448 bytes. Returns (idx (G, N, k)
    int32, gate (G, N, k) f32, pos (G, N, k) int32)."""
    global launches
    if logits.device.type != "cuda":
        raise ValueError(f"moe_gating: logits on {logits.device}, the kernel needs a CUDA device")
    if logits.dtype != torch.float32:
        raise TypeError(f"moe_gating: logits must be float32, got {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("moe_gating: logits must be contiguous")
    if logits.dim() != 3 or 0 in logits.shape:
        raise ValueError(f"moe_gating: logits {tuple(logits.shape)} must be a non-empty (G, N, E)")
    G, N, E = logits.shape
    if E > MAX_EXPERTS or not 1 <= top_k <= min(E, MAX_TOP_K):
        raise ValueError(f"moe_gating: E {E} and top_k {top_k} need E <= {MAX_EXPERTS} and "
                         f"1 <= top_k <= min(E, {MAX_TOP_K})")
    if capacity < 0:
        raise ValueError(f"moe_gating: capacity {capacity} < 0")
    if 4 * top_k * (N + E) > MAX_SMEM_BYTES:
        raise ValueError(f"moe_gating: a group of {N} tokens with top_k {top_k} needs more shared "
                         f"memory than a block has")
    idx = torch.empty((G, N, top_k), dtype=torch.int32, device=logits.device)
    gate = torch.empty((G, N, top_k), dtype=torch.float32, device=logits.device)
    pos = torch.empty((G, N, top_k), dtype=torch.int32, device=logits.device)
    lib = _build.library()
    with torch.cuda.device(logits.device):
        err = lib.repro_moe_gating_fwd(
            logits.data_ptr(), idx.data_ptr(), gate.data_ptr(), pos.data_ptr(),
            G, N, E, top_k, capacity, int(renormalise),
            torch.cuda.current_stream(logits.device).cuda_stream,
        )
    _build.check(err, "moe_gating")
    launches += 1
    return idx, gate, pos
