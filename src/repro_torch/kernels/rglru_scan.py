"""RG-LRU linear recurrence on the card: the wrapper of ``csrc/rglru_scan.cu``.

The kernel replaces the Pallas TPU kernel ``repro/kernels/rglru_scan.py``
(``lru_pallas`` / ``_lru_kernel``); its plain version is
:func:`repro_torch.kernels.ref.lru_ref`. The wrapper checks what the kernel
takes and raises on anything else, allocates the outputs, and launches on
PyTorch's current stream without synchronising.
"""

from __future__ import annotations

import torch

from . import _build

DTYPES = (torch.float32, torch.bfloat16)

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
