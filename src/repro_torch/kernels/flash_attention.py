"""Flash attention forward on the card: the wrapper of ``csrc/flash_attention.cu``.

The kernel replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` / ``_attn_kernel``); its plain version is
:func:`repro_torch.kernels.ref.attention_ref`. The wrapper checks what the
kernel takes and raises on anything else, allocates the output, and launches
on PyTorch's current stream without synchronising.
"""

from __future__ import annotations

import torch

from . import _build

DTYPES = (torch.float32, torch.bfloat16)
# (d, dv) pairs the kernel is compiled for
HEAD_DIM_PAIRS = ((64, 64), (128, 128), (64, 128), (128, 64), (256, 256))
BQ = BK = 64  # query rows and keys per tile, as in the kernel

# Kernel launches since import. chip_smoke.py sets it to 0 around the
# main path and reads it to show that every prefill attention came here.
launches = 0


def _validate(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}, the kernel needs CUDA")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not in {DTYPES}")
    B, Hq, Sq, d = q.shape
    Bk, Hkv, Skv, dk = k.shape
    if (Bk, Hkv, Skv) != tuple(v.shape[:3]) or Bk != B or dk != d:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not agree"
        )
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: Hq={Hq} is not a multiple of Hkv={Hkv}")
    if (d, v.shape[3]) not in HEAD_DIM_PAIRS:
        raise ValueError(f"flash_attention: head dims (d, dv)=({d}, {v.shape[3]}) not in {HEAD_DIM_PAIRS}")
    if min(B, Hq, Sq, Skv) <= 0:
        raise ValueError(f"flash_attention: empty input q {tuple(q.shape)}, k {tuple(k.shape)}")


def dynamic_smem_bytes(d: int, dv: int) -> int:
    """Shared memory one block asks for at launch: f32 Q and K tiles padded by
    one float, the V tile and the P tile (``smem_bytes`` in the source)."""
    return 4 * (BQ * (d + 1) + BK * (d + 1) + BK * dv + BQ * (BK + 1))


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, logit_cap: float = 0.0):
    """q: (B,Hq,Sq,d); k: (B,Hkv,Skv,d); v: (B,Hkv,Skv,dv), all on one CUDA
    device, contiguous, f32 or bf16, (d, dv) in ``HEAD_DIM_PAIRS``. Returns
    (B,Hq,Sq,dv) in q's dtype. Query head h reads KV head h // (Hq // Hkv);
    positions start at 0 for both q and k, as in the reference."""
    global launches
    _validate(q, k, v)
    B, Hq, Sq, d = q.shape
    Hkv, Skv, dv = v.shape[1], v.shape[2], v.shape[3]
    out = torch.empty((B, Hq, Sq, dv), dtype=q.dtype, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, Sq, Skv, d, dv, int(q.dtype == torch.bfloat16),
            int(causal), int(window), float(logit_cap),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(err, "flash_attention")
    launches += 1
    return out
