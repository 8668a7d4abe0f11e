"""Flash attention forward on the card: the wrapper of ``csrc/flash_attention.cu``.

The kernels replace the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` / ``_attn_kernel``); their plain version is
:func:`repro_torch.kernels.ref.attention_ref`. They are bound by operations at
the serving shapes (deepseek-moe-16b's 8 × 2048 prefill needs 137 GFLOP
against 268 MB), so the design follows the unit that does them:

- bf16 runs on the tensor cores. A block of 128 query rows has a producer
  warpgroup that streams 64-key K and V tiles by TMA into a ring of
  mbarrier-guarded stages (2 at d 256, else 4) and two consumer warpgroups
  that compute S = Q·Kᵀ and O += P·V with ``wgmma``, P taken from registers.
  P is split into bf16 hi and lo parts and both are multiplied with V: one
  bf16 rounding of P would put some outputs outside the card's limit (atol
  1e-3, rtol 2⁻⁷ against the plain version), the split keeps 16 bits of P.
- bf16 at MLA's (d, dv) = (96, 64) has a kernel of its own
  (``flash_attn_bf16_mla_kernel``) whose softmax runs while the tensor cores
  work: the same block of 128 query rows, with 128-key tiles in a ring of 3
  stages; each consumer warpgroup issues S of a tile with P·V of the one
  before, and the two consumers take turns issuing their products (named
  barriers), so that one warpgroup's softmax runs under the other's
  products. Its Q and K tiles are 128 columns wide: the TMA load of the
  second 64-column box fills columns 96..127 with zeros, Q·Kᵀ stops at
  column 96 and the scale is 96**-0.5. q and k are not padded on the host.
- f32 at (d, dv) = (64, 64), nbi-100m's heads, runs on the tensor cores too,
  as 3×TF32: every operand is split into TF32 hi and lo parts and each
  product is hi·hi + hi·lo + lo·hi in f32 (about 22 bits; one TF32 product
  keeps 11 and misses the f32 limit of atol 2e-5). Blocks as in bf16; the
  producer's three idle warps split each K and V tile in shared memory and
  write Vᵀ, since TF32 operands of ``wgmma`` must be K-major.
- f32 at MLA's (96, 64), minicpm3-4b's heads in f32 activations (the
  continuous-batching engine's inserts), runs the same 3×TF32 block as a
  kernel of its own (``flash_attn_tf32_mla_kernel``) at 32-key tiles: the
  d 64 layout (64-key tiles) would take 295,992 bytes of shared memory at
  d 96, past the 232,448 a block may opt into; at 32 keys it takes 197,688.
  Q and K are exactly three 32-column panels. It is bound by operations
  (three TF32 products: 0.0388 ms at one 1000-token insert of 40 heads) and
  takes 0.203 ms there on an H100 80GB HBM3 at 700 W, against 0.430 ms on
  the FMA units and 0.30 ms for SDPA (PERF.md).
- f32 at (128, 128), codeqwen1.5-7b's heads in f32 activations (its
  continuous-batching inserts), runs the same 3×TF32 block as a kernel of
  its own (``flash_attn_tf32_d128_kernel``) at 16-key tiles: Q and Q_lo take
  128 KB, so the ring fits only at 16 keys (32 keys would take 295,992
  bytes). K and V come split: a first kernel (``tf32_split_kv_kernel``)
  writes K_hi, K_lo and Vᵀ_hi, Vᵀ_lo once per call into a scratch tensor the
  wrapper allocates (:func:`workspace_floats`), and the block loads them by
  TMA into three stages (230,456 bytes), so that no block repeats the split
  of a tile and the splitting warps leave the ring's path. Vᵀ's rows of 16
  keys are 64 bytes, kept with the 64-byte swizzle, and P·V runs each
  64-column half of O in turn. Bound by operations: 0.0497 ms at one
  1000-token insert of 32 heads.
- f32 at the other pairs of ``HEAD_DIM_PAIRS`` ((64, 128), (128, 64),
  (256, 256)) stays on the FMA units: 64-row blocks, f32 tiles in shared
  memory.

The wrapper checks what the kernels take and raises on anything else,
allocates the output, and launches on PyTorch's current stream without
synchronising.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

DTYPES = (torch.float32, torch.bfloat16)
# (d, dv) pairs the kernels are compiled for
HEAD_DIM_PAIRS = ((64, 64), (128, 128), (64, 128), (128, 64), (256, 256), (96, 64))
# MLA's prefill pair (minicpm3-4b: q, k 64 + 32 wide, v 64); its bf16 launches
# have their own count
MLA_HEAD_DIMS = (96, 64)
# f32 (128, 128), codeqwen1.5-7b's heads: its tensor-core launches have their
# own count
D128_HEAD_DIMS = (128, 128)
# the f32 pairs of the tensor-core (3×TF32) kernels; other f32 pairs run on
# the FMA units
TF32_HEAD_DIM_PAIRS = ((64, 64), MLA_HEAD_DIMS, D128_HEAD_DIMS)
# query rows per block and keys per tile, as in the kernels: the f32 FMA
# kernel, the bf16 kernel, the f32 tensor-core kernels (TF32_MLA_BK keys a
# tile at MLA's pair, TF32_D128_BK at (128, 128)) in a ring of TF32_STAGES;
# (TF32_D128_STAGES at (128, 128), whose K and V come split, and whose
# scratch pads Vᵀ's keys to SPLIT_KEYS); the bf16 MLA kernel takes MLA_BK
# keys a tile into a ring of MLA_STAGES
BQ = {torch.float32: 64, torch.bfloat16: 128}
BQ_TF32 = 128
BK = 64
TF32_MLA_BK = 32
TF32_D128_BK = 16
TF32_STAGES = 2
TF32_D128_STAGES = 3
SPLIT_KEYS = 32
MLA_BK = 128
MLA_STAGES = 3
# the C entry's kernel codes (``Kind`` in the source)
F32_SIMT, BF16, F32_TF32 = 0, 1, 2

# Launches since import, one count per kernel: the f32 kernel on the FMA
# units, the bf16 kernel (at every pair but MLA's), the bf16 MLA kernel at
# (96, 64), the f32 tensor-core kernels at (64, 64), (96, 64) and (128, 128).
# chip_smoke.py sets them to 0 around the main path and reads them to show
# that every prefill attention came here.
launches = 0
bf16_launches = 0
bf16_mla_launches = 0
tf32_launches = 0
tf32_mla_launches = 0
tf32_d128_launches = 0


def kernel_kind(dtype: torch.dtype, d: int, dv: int) -> int:
    """Which kernel takes these inputs: ``F32_SIMT``, ``BF16`` or ``F32_TF32``."""
    if dtype == torch.bfloat16:
        return BF16
    return F32_TF32 if (d, dv) in TF32_HEAD_DIM_PAIRS else F32_SIMT


def launch_count(dtype: torch.dtype, d: int, dv: int) -> str:
    """The name of the launch count that a call at (dtype, d, dv) adds one to."""
    kind, mla = kernel_kind(dtype, d, dv), (d, dv) == MLA_HEAD_DIMS
    if kind == BF16:
        return "bf16_mla_launches" if mla else "bf16_launches"
    if kind == F32_TF32:
        names = {MLA_HEAD_DIMS: "tf32_mla_launches", D128_HEAD_DIMS: "tf32_d128_launches"}
        return names.get((d, dv), "tf32_launches")
    return "launches"


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
    if kernel_kind(q.dtype, d, v.shape[3]) != F32_SIMT:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention: {name} must start on 16 bytes (a TMA tensor map's base)")


def tiles(dtype: torch.dtype, d: int, dv: int) -> tuple[int, int]:
    """(query rows a block, keys a tile) of the kernel that takes these inputs."""
    kind = kernel_kind(dtype, d, dv)
    if kind == BF16:
        return BQ[dtype], MLA_BK if (d, dv) == MLA_HEAD_DIMS else BK
    if kind == F32_TF32:
        return BQ_TF32, {MLA_HEAD_DIMS: TF32_MLA_BK, D128_HEAD_DIMS: TF32_D128_BK}.get((d, dv), BK)
    return BQ[dtype], BK


def stages(d: int, dv: int) -> int:
    """K and V tiles in flight in the ring of the bf16 kernel that takes (d, dv)."""
    if (d, dv) == MLA_HEAD_DIMS:
        return MLA_STAGES
    return 2 if d + dv >= 512 else 4


def tf32_stages(d: int, dv: int) -> int:
    """Stages of the ring of the f32 tensor-core kernel that takes (d, dv)."""
    return TF32_D128_STAGES if (d, dv) == D128_HEAD_DIMS else TF32_STAGES


def workspace_floats(dtype: torch.dtype, B: int, Hkv: int, Skv: int, d: int, dv: int) -> int:
    """f32 of scratch the kernel that takes these inputs needs besides its
    output (``tf32_workspace_floats`` in the source, which checks what it is
    given against this sum): at f32 (128, 128), K_hi
    and K_lo (K's shape) and Vᵀ_hi and Vᵀ_lo (dv rows of Skv keys rounded up
    to SPLIT_KEYS) a KV head; else none."""
    if kernel_kind(dtype, d, dv) != F32_TF32 or (d, dv) != D128_HEAD_DIMS:
        return 0
    keys_pad = -(-Skv // SPLIT_KEYS) * SPLIT_KEYS
    return 2 * B * Hkv * (Skv * d + dv * keys_pad)


def dynamic_smem_bytes(d: int, dv: int, dtype: torch.dtype = torch.float32) -> int:
    """Shared memory one block of the kernel that takes (d, dv, dtype) asks
    for at launch (``smem_bytes``, ``mla_smem_bytes`` and ``Tf32Tiles::SMEM``
    in the source). bf16:
    the Q tile, the ring of K and V tiles of :func:`tiles`' keys (Q and K in
    whole 64-column panels: d 96 takes 128), one barrier per stage for full
    and for empty and one for Q, and 1024 bytes of slack to align the tiles to
    their swizzle pattern. f32 on the tensor cores: the Q tile (split in place
    into Q_hi) and Q_lo, two stages of five tiles of :func:`tiles`' keys (K
    split in place, K_lo, V, Vᵀ_hi, Vᵀ_lo), three barriers per stage and one
    for Q, and the slack; at (128, 128), whose K and V come split, three
    stages of four tiles (K_hi, K_lo, Vᵀ_hi, Vᵀ_lo) and two barriers a stage.
    f32 on the FMA units: Q and K tiles padded by one float, the V tile and
    the P tile."""
    kind = kernel_kind(dtype, d, dv)
    if kind == BF16:
        (bq, bk), n, dp = tiles(dtype, d, dv), stages(d, dv), -(-d // 64) * 64
        return 1024 + 2 * (bq * dp + n * bk * (dp + dv)) + 8 * (2 * n + 1)
    if kind == F32_TF32:
        (bq, bk), n = tiles(dtype, d, dv), tf32_stages(d, dv)
        if (d, dv) == D128_HEAD_DIMS:
            return 1024 + 4 * (2 * bq * d + n * bk * (2 * d + 2 * dv)) + 8 * (2 * n + 1)
        return 1024 + 4 * (2 * bq * d + n * bk * (2 * d + 3 * dv)) + 8 * (3 * n + 1)
    return 4 * (BQ[dtype] * (d + 1) + BK * (d + 1) + BK * dv + BQ[dtype] * (BK + 1))


def launch_config(dtype: torch.dtype, d: int, dv: int) -> dict:
    """The block of the kernel that takes (d, dv, dtype), as the library
    reports it: query rows ``bq``, keys a tile ``bk``, ring ``stages`` (1:
    none), ``smem_bytes`` of dynamic shared memory, ``threads``. Builds the
    library, so it needs the CUDA toolkit."""
    out = (ctypes.c_int * 5)()
    _build.check(_build.library().repro_flash_attention_config(kernel_kind(dtype, d, dv), d, dv, out),
                 "flash_attention config")
    return dict(zip(("bq", "bk", "stages", "smem_bytes", "threads"), out))


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, logit_cap: float = 0.0):
    """q: (B,Hq,Sq,d); k: (B,Hkv,Skv,d); v: (B,Hkv,Skv,dv), all on one CUDA
    device, contiguous, f32 or bf16, (d, dv) in ``HEAD_DIM_PAIRS``. Returns
    (B,Hq,Sq,dv) in q's dtype. Query head h reads KV head h // (Hq // Hkv);
    positions start at 0 for both q and k, as in the reference."""
    _validate(q, k, v)
    B, Hq, Sq, d = q.shape
    Hkv, Skv, dv = v.shape[1], v.shape[2], v.shape[3]
    out = torch.empty((B, Hq, Sq, dv), dtype=q.dtype, device=q.device)
    kind = kernel_kind(q.dtype, d, dv)
    n_ws = workspace_floats(q.dtype, B, Hkv, Skv, d, dv)
    # freed after the launch: the allocator reuses it only in stream order
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device) if n_ws else None
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, Sq, Skv, d, dv, kind,
            int(causal), int(window), float(logit_cap),
            ws.data_ptr() if ws is not None else None, n_ws,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(err, "flash_attention")
    globals()[launch_count(q.dtype, d, dv)] += 1
    return out
