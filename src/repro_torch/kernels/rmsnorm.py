"""RMSNorm forward on the card: the wrapper of ``csrc/rmsnorm.cu``.

The kernel replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py``
(``rmsnorm_pallas`` / ``_rmsnorm_kernel``); its plain version is
:func:`repro_torch.kernels.ref.rmsnorm_ref`. The wrapper checks what the kernel
takes and raises on anything else, allocates the output, and launches on
PyTorch's current stream without synchronising.
"""

from __future__ import annotations

import torch

from . import _build

DTYPES = (torch.float32, torch.bfloat16)
MAX_D = 12288  # the widest assigned architecture (mistral-large-123b)

# Kernel launches since import. chip_smoke.py sets it to 0 around the
# main path and reads it to show that every norm came here.
launches = 0


def rmsnorm(x, weight, eps: float = 1e-6):
    """x: (..., D) contiguous on CUDA, f32 or bf16; weight: (D,) on the same
    device (any float dtype, read as f32). Returns x's shape and dtype."""
    global launches
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, weight on {weight.device}; the kernel needs both on one CUDA device")
    if x.dtype not in DTYPES:
        raise TypeError(f"rmsnorm: dtype {x.dtype} not in {DTYPES}")
    if not x.is_contiguous():
        raise ValueError("rmsnorm: x must be contiguous")
    D = x.shape[-1] if x.dim() else 0
    if weight.shape != (D,) or not 0 < D <= MAX_D:
        raise ValueError(f"rmsnorm: x {tuple(x.shape)} and weight {tuple(weight.shape)} need D in 1..{MAX_D}")
    rows = x.numel() // D
    out = torch.empty_like(x)
    if rows == 0:
        return out
    w = weight.float().contiguous()
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.repro_rmsnorm_fwd(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, D,
            int(x.dtype == torch.bfloat16), float(eps),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(err, "rmsnorm")
    launches += 1
    return out
