"""RWKV-6 WKV recurrence on the card: the wrapper of ``csrc/rwkv6_scan.cu``.

The kernel replaces the Pallas TPU kernel ``repro/kernels/rwkv6_scan.py``
(``wkv6_pallas`` / ``_wkv_kernel``); its plain version is
:func:`repro_torch.kernels.ref.wkv6_ref`. It runs the recurrence in its
sequential form, token by token with the f32 state in registers, on the FMA
units: three FP instructions per state element and token, which bound it.
The sequential form stays because its FMA bound is within 1.5x of the byte
bound at the serving shapes, while the TPU's chunked form does C times more
arithmetic in its pairwise term and would need split operands to meet the
f32 limit on the tensor cores.

The layout: one block per (b, h); S in four row groups, one warp per row
group spanning all columns (two columns a thread at d 64), so that the r, k
and w a warp reads are broadcasts; partial y summed across row groups in
shared memory; inputs staged 16 tokens at a time by ``cp.async`` into two
stages, converted to f32 once; y written in 16-byte stores.
:func:`launch_config` reads the launch back from the library.

The wrapper checks what the kernel takes and raises on anything else,
allocates the outputs, and launches on PyTorch's current stream without
synchronising.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

DTYPES = (torch.float32, torch.bfloat16)
HEAD_SIZES = (16, 32, 64)


def launch_config(d: int, dtype) -> dict:
    """The kernel's launch at head size ``d`` for ``dtype`` inputs, as the
    library reports it: threads and dynamic shared memory per block, blocks
    resident per SM on the current device, tokens per chunk and row groups of
    S. Builds the library, so it needs the card."""
    out = (ctypes.c_int * 5)()
    _build.check(_build.library().repro_wkv6_config(d, int(dtype == torch.bfloat16), out), "wkv6 config")
    return dict(zip(("threads", "smem_bytes", "blocks_per_sm", "chunk", "parts"), out))


# Kernel launches since import. chip_smoke.py sets it to 0 around the
# main path and reads it to show that every RWKV-6 prefill came here.
launches = 0


def wkv6(r, k, v, w, u, s0):
    """r, k, w: (B, H, T, d); v: (B, H, T, d), all contiguous, one dtype (f32
    or bf16); u: (H, d) any float dtype (read as f32); s0: (B, H, d, d) f32;
    all on one CUDA device, with d = dk = dv in ``HEAD_SIZES``. Any T.
    Returns (y (B, H, T, d) in r's dtype, S_final (B, H, d, d) f32)."""
    global launches
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u), ("s0", s0)):
        if t.device.type != "cuda" or t.device != r.device:
            raise ValueError(f"wkv6: {name} is on {t.device}, the kernel needs all on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"wkv6: {name} must be contiguous")
        if name in ("r", "k", "v", "w") and t.data_ptr() % 16:
            raise ValueError(f"wkv6: {name} must start on a 16-byte boundary (the kernel copies 16 bytes at a time)")
    if r.dtype not in DTYPES or any(t.dtype != r.dtype for t in (k, v, w)):
        raise TypeError(f"wkv6: r, k, v, w are {r.dtype}, {k.dtype}, {v.dtype}, {w.dtype}; "
                        f"they must share one of {DTYPES}")
    if s0.dtype != torch.float32:
        raise TypeError(f"wkv6: s0 must be float32, got {s0.dtype}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"wkv6: r, k, v, w must share one 4-D shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    B, H, T, d = r.shape
    if d not in HEAD_SIZES:
        raise ValueError(f"wkv6: head size {d} not in {HEAD_SIZES} (dk = dv)")
    if u.shape != (H, d) or s0.shape != (B, H, d, d):
        raise ValueError(f"wkv6: u {tuple(u.shape)} or s0 {tuple(s0.shape)} does not fit r {tuple(r.shape)}")
    if B == 0 or H == 0:
        raise ValueError(f"wkv6: empty input {tuple(r.shape)}")
    y = torch.empty_like(r)
    s_out = torch.empty_like(s0)
    uf = u.float().contiguous()
    if uf.data_ptr() % 16:  # the kernel reads u four floats at a time
        uf = uf.clone()
    lib = _build.library()
    with torch.cuda.device(r.device):
        err = lib.repro_wkv6_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), uf.data_ptr(),
            s0.data_ptr(), y.data_ptr(), s_out.data_ptr(), B, H, T, d,
            int(r.dtype == torch.bfloat16), torch.cuda.current_stream(r.device).cuda_stream,
        )
    _build.check(err, "wkv6")
    launches += 1
    return y, s_out
