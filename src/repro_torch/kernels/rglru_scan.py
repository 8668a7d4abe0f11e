"""RG-LRU linear recurrence on the card: the wrapper of ``csrc/rglru_scan.cu``.

The kernel replaces the Pallas TPU kernel ``repro/kernels/rglru_scan.py``
(``lru_pallas`` / ``_lru_kernel``); its plain version is
:func:`repro_torch.kernels.ref.lru_ref`, which it matches to the bit in f32
and in bf16 (the product and the sum rounded separately, in t order).

Streaming a and b from device memory and h back bounds it, so the design
keeps enough bytes in flight on every SM: one block per (batch row, tile of
WT channels) with one thread per channel, WT the largest of 128, 64, 32, 16
that gives every SM a block, and a ring of shared-memory stages filled
ahead of the chain, sized from B·W so that the card holds about 4 MB of a
and b in flight while every block stays resident at once. The ring is
filled by 16-byte ``cp.async`` where the rows of a and b start on 16-byte
boundaries, by 4-byte ``cp.async`` where they start on 4-byte ones, and by
plain loads otherwise (bf16 at odd W). :func:`launch_config` reads the launch
back from the library.

The wrapper checks what the kernel takes and raises on anything else,
allocates the outputs, and launches on PyTorch's current stream without
synchronising.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

DTYPES = (torch.float32, torch.bfloat16)
# bytes a copy into the ring: the copy path the library takes
COPY_PATHS = {16: "cp.async 16 B", 4: "cp.async 4 B", 2: "loads 2 B"}


def launch_config(B: int, T: int, W: int, dtype, misalign: int = 0) -> dict:
    """The kernel's launch for a (B, T, W) call in ``dtype`` whose inputs a
    and b start ``misalign`` bytes past a 16-byte boundary (their addresses
    OR-ed, modulo 16; 0 for fresh allocations), as the library reports it
    on the current device: channels a block (``tile``), time steps a ring
    stage (``steps``), ring ``stages`` (``stages - 1`` in flight), threads
    and dynamic shared memory a block, ``blocks``, blocks resident per SM,
    bytes a copy and its ``path``, the device's ``sms``, and the bytes of a
    and b in flight across the card. Builds the library, so it needs the
    card."""
    out = (ctypes.c_int * 9)()
    lib = _build.library()
    _build.check(lib.repro_lru_scan_config(B, T, W, int(dtype == torch.bfloat16), misalign % 16, out),
                 "lru_scan config")
    keys = ("tile", "steps", "stages", "threads", "smem_bytes", "blocks", "blocks_per_sm", "copy_bytes", "sms")
    c = dict(zip(keys, out))
    c["path"] = COPY_PATHS[c["copy_bytes"]]
    elt = 2 if dtype == torch.bfloat16 else 4
    c["in_flight_bytes"] = 2 * B * W * elt * min((c["stages"] - 1) * c["steps"], T)
    return c


# Kernel launches since import. chip_smoke.py sets it to 0 around the
# main path and reads it to show that every prefill scan came here.
launches = 0


def lru_scan(a, b, h0):
    """h_t = a_t ⊙ h_{t-1} + b_t. a, b: (B, T, W) on one CUDA device,
    contiguous, one dtype (f32 or bf16); h0: (B, W) f32 on the same device.
    Any T and W. Returns (h_seq (B, T, W) in a's dtype, h_final (B, W) f32)."""
    global launches
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"lru_scan: {name} is on {t.device}, the kernel needs all on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"lru_scan: {name} must be contiguous")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(f"lru_scan: a is {a.dtype}, b is {b.dtype}; both must be one of {DTYPES}")
    if h0.dtype != torch.float32:
        raise TypeError(f"lru_scan: h0 must be float32, got {h0.dtype}")
    if a.dim() != 3 or b.shape != a.shape or h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"lru_scan: shapes a {tuple(a.shape)}, b {tuple(b.shape)}, h0 {tuple(h0.shape)} do not agree")
    B, T, W = a.shape
    if B == 0 or W == 0:
        raise ValueError(f"lru_scan: empty input {tuple(a.shape)}")
    h_seq = torch.empty_like(a)
    h_out = torch.empty_like(h0)
    lib = _build.library()
    with torch.cuda.device(a.device):
        err = lib.repro_lru_scan_fwd(
            a.data_ptr(), b.data_ptr(), h0.data_ptr(), h_seq.data_ptr(), h_out.data_ptr(),
            B, T, W, int(a.dtype == torch.bfloat16),
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    _build.check(err, "lru_scan")
    launches += 1
    return h_seq, h_out
