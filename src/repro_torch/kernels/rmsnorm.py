"""RMSNorm forward on the card: the wrapper of ``csrc/rmsnorm.cu``.

The kernel replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py``
(``rmsnorm_pallas`` / ``_rmsnorm_kernel``); its plain version is
:func:`repro_torch.kernels.ref.rmsnorm_ref`.

Reading x once and writing y once bounds it, so its vector path reads each
row once, in 16-byte vectors, into registers: a team of 1 to 16 warps a row
(sized from D, and wider for a few rows), at most 8 vectors a thread, a row
a team (narrow rows a few), the weight read through L1. A D that is not a
multiple of the vector width (8 bf16 or 4 f32 values), or an x or y off a
16-byte boundary, takes the generic path instead (a kernel too, counted in
``generic_launches`` besides ``launches``). :func:`launch_config` reads a
call's launch back from the library.

The wrapper checks what the kernel takes and raises on anything else,
allocates the output, and launches on PyTorch's current stream without
synchronising.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

DTYPES = (torch.float32, torch.bfloat16)
MAX_D = 12288  # the widest assigned architecture (mistral-large-123b)
VEC_BYTES = 16  # a vector path load or store
PATHS = ("generic", "vector")  # the library's path codes

# Kernel launches since import, on either path, and those of the generic
# path alone. chip_smoke.py sets both to 0 around the main path and reads
# them to show that every norm came here, through the vector path.
launches = 0
generic_launches = 0


def takes_vector_path(D: int, dtype, misalign: int = 0) -> bool:
    """Whether a call at width D in ``dtype`` whose x and y addresses, OR-ed,
    sit ``misalign`` bytes past a 16-byte boundary takes the vector path (the
    library's rule)."""
    return D % (VEC_BYTES // (torch.finfo(dtype).bits // 8)) == 0 and misalign % VEC_BYTES == 0


def launch_config(rows: int, D: int, dtype, misalign: int = 0) -> dict:
    """The kernel's launch for ``rows`` rows of D in ``dtype`` whose x and y
    addresses, OR-ed, sit ``misalign`` bytes past a 16-byte boundary (0 for
    fresh allocations), as the library reports it on the current device: the
    ``path``, warps a row (``team_warps``), 16-byte vectors a thread
    (``vectors_per_thread``, 0 on the generic path), threads and teams a
    block, ``blocks``, blocks resident per SM, the device's ``sms``, rows a
    team at most, the device's ``l2_bytes`` and ``stream_x`` (x, larger than
    L2, loaded past L1). Builds the library, so it needs the card."""
    fn = _build.library().repro_rmsnorm_config
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 11)()
    _build.check(fn(rows, D, int(dtype == torch.bfloat16), misalign % VEC_BYTES, out), "rmsnorm config")
    keys = ("path", "team_warps", "vectors_per_thread", "threads", "teams", "blocks", "blocks_per_sm", "sms",
            "rows_per_team", "l2_bytes", "stream_x")
    c = dict(zip(keys, out))
    c["path"] = PATHS[c["path"]]
    return c


def rmsnorm(x, weight, eps: float = 1e-6):
    """x: (..., D) contiguous on CUDA, f32 or bf16; weight: (D,) on the same
    device (any float dtype, read as f32). Returns x's shape and dtype."""
    global launches, generic_launches
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
    if w.data_ptr() % VEC_BYTES:  # the kernels read w in 16-byte vectors
        w = w.clone()
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.repro_rmsnorm_fwd(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, D,
            int(x.dtype == torch.bfloat16), float(eps),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(err, "rmsnorm")
    launches += 1
    if not takes_vector_path(D, x.dtype, x.data_ptr() | out.data_ptr()):
        generic_launches += 1
    return out
