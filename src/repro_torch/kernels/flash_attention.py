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
- f32 at (128, 64) and (64, 128) are instances of that block at their
  widths, K and V split the same way, at 32-key tiles (Vᵀ's rows of 32 keys
  under the 128-byte swizzle), which were 1.4× faster than 16 there on an
  H100 (PERF.md): ``flash_attn_tf32_d128_dv64_kernel`` has one 64-column
  half of O and two stages (230,440 bytes; three do not fit),
  ``flash_attn_tf32_d64_dv128_kernel`` Q and K of two 32-column panels and
  three stages (214,072 bytes).
- f32 at (256, 256), Griffin's heads, does not fit one block: Q and Q_lo
  alone would take 256 KB at 128 rows. A cluster of two blocks splits the
  head dims (``flash_attn_tf32_d256_kernel``): each block is the (128, 128)
  block over its 128 columns of Q, K, V and O, with two stages; each
  consumer warpgroup sums its partial S over its columns, stores it into the
  peer block's shared memory (two slots a warpgroup, by the tile's parity)
  and arrives on the peer's barrier, then adds the peer's partial, so that
  both blocks hold the same S, softmax and P and each multiplies P by its
  own half of V (214,088 bytes). The launch checks that the card can hold a
  cluster of two such blocks (:func:`launch_config`'s
  ``clusters_resident``) and raises if not.

Every f32 pair runs on the tensor cores: no f32 kernel is left on the FMA
units.

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
# f32 (128, 128), codeqwen1.5-7b's heads
D128_HEAD_DIMS = (128, 128)
# f32 (256, 256): a cluster of two blocks splits the head dims
D256_HEAD_DIMS = (256, 256)
# the f32 pairs of the tensor-core (3×TF32) kernels: every pair
TF32_HEAD_DIM_PAIRS = HEAD_DIM_PAIRS
# the f32 pairs whose K and V are split once a call into scratch
# (``tf32_split_kv_kernel``) and read at TF32_PRESPLIT_BK keys a tile
PRESPLIT_HEAD_DIM_PAIRS = (D128_HEAD_DIMS, (64, 128), (128, 64), D256_HEAD_DIMS)
# query rows per block and keys per tile, as in the kernels: the bf16 kernel,
# the f32 tensor-core kernels (TF32_MLA_BK keys a tile at MLA's pair,
# TF32_PRESPLIT_BK where K and V come split, but TF32_MIXED_BK at (64, 128)
# and (128, 64)) in a ring of TF32_STAGES (PRESPLIT_STAGES where K and V come
# split, one fewer where those do not fit in MAX_SMEM, CLUSTER_STAGES at
# (256, 256) beside the cluster's exchange slots; the scratch pads Vᵀ's keys
# to SPLIT_KEYS); the bf16 MLA kernel takes MLA_BK keys a tile into a ring of
# MLA_STAGES
BQ = 128
BK = 64
TF32_MLA_BK = 32
TF32_PRESPLIT_BK = 16
TF32_MIXED_BK = 32
TF32_STAGES = 2
PRESPLIT_STAGES = 3
CLUSTER_STAGES = 2
SPLIT_KEYS = 32
MAX_SMEM = 232448
MLA_BK = 128
MLA_STAGES = 3
# consumer warpgroups of a block (64 query rows each)
CONSUMERS = 2
# the C entry's kernel codes (``Kind`` in the source)
BF16, F32_TF32 = 1, 2

# Launches since import, one count per kernel: the bf16 kernel (at every pair
# but MLA's), the bf16 MLA kernel at (96, 64), the f32 tensor-core kernels at
# (64, 64), (96, 64), (128, 128), (128, 64), (64, 128) and (256, 256).
# chip_smoke.py sets them to 0 around the main path and reads them to show
# that every prefill attention came here.
bf16_launches = 0
bf16_mla_launches = 0
tf32_launches = 0
tf32_mla_launches = 0
tf32_d128_launches = 0
tf32_d128_dv64_launches = 0
tf32_d64_dv128_launches = 0
tf32_d256_launches = 0
# the f32 launch counts by pair
TF32_COUNTS = {(64, 64): "tf32_launches", MLA_HEAD_DIMS: "tf32_mla_launches", D128_HEAD_DIMS: "tf32_d128_launches",
               (128, 64): "tf32_d128_dv64_launches", (64, 128): "tf32_d64_dv128_launches",
               D256_HEAD_DIMS: "tf32_d256_launches"}


def kernel_kind(dtype: torch.dtype, d: int, dv: int) -> int:
    """Which kernel takes these inputs: ``BF16`` or ``F32_TF32``."""
    return BF16 if dtype == torch.bfloat16 else F32_TF32


def launch_count(dtype: torch.dtype, d: int, dv: int) -> str:
    """The name of the launch count that a call at (dtype, d, dv) adds one to
    (a pair outside ``HEAD_DIM_PAIRS``, as the CPU's smoke widths, names the
    count of its dtype's first kernel: no kernel takes it)."""
    if kernel_kind(dtype, d, dv) == BF16:
        return "bf16_mla_launches" if (d, dv) == MLA_HEAD_DIMS else "bf16_launches"
    return TF32_COUNTS.get((d, dv), "tf32_launches")


def check_inputs(q, k, v) -> None:
    """The checks of what the kernels take that do not depend on the device
    (the ``meta`` route of :mod:`repro_torch.kernels.ops` makes them too):
    one device, one dtype in ``DTYPES``, 4-D contiguous tensors whose shapes
    agree, (d, dv) in ``HEAD_DIM_PAIRS``, nothing empty."""
    for name, t in (("q", q), ("k", k), ("v", v)):
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


def _validate(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}, the kernel needs CUDA")
    check_inputs(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must start on 16 bytes (a TMA tensor map's base)")


def tiles(dtype: torch.dtype, d: int, dv: int) -> tuple[int, int]:
    """(query rows a block, keys a tile) of the kernel that takes these inputs."""
    if kernel_kind(dtype, d, dv) == BF16:
        return BQ, MLA_BK if (d, dv) == MLA_HEAD_DIMS else BK
    if (d, dv) in PRESPLIT_HEAD_DIM_PAIRS:
        return BQ, TF32_MIXED_BK if d != dv else TF32_PRESPLIT_BK
    return BQ, TF32_MLA_BK if (d, dv) == MLA_HEAD_DIMS else BK


def stages(d: int, dv: int) -> int:
    """K and V tiles in flight in the ring of the bf16 kernel that takes (d, dv)."""
    if (d, dv) == MLA_HEAD_DIMS:
        return MLA_STAGES
    return 2 if d + dv >= 512 else 4


def tf32_stages(d: int, dv: int) -> int:
    """Stages of the ring of the f32 tensor-core kernel that takes (d, dv)."""
    if (d, dv) == D256_HEAD_DIMS:
        return CLUSTER_STAGES
    if (d, dv) not in PRESPLIT_HEAD_DIM_PAIRS:
        return TF32_STAGES
    return PRESPLIT_STAGES if _tf32_smem(d, dv, PRESPLIT_STAGES) <= MAX_SMEM else PRESPLIT_STAGES - 1


def cluster_blocks(dtype: torch.dtype, d: int, dv: int) -> int:
    """Blocks of a cluster of the kernel that takes these inputs: two at f32
    (256, 256), each with half of the head dims, else one."""
    return 2 if kernel_kind(dtype, d, dv) == F32_TF32 and (d, dv) == D256_HEAD_DIMS else 1


def workspace_floats(dtype: torch.dtype, B: int, Hkv: int, Skv: int, d: int, dv: int) -> int:
    """f32 of scratch the kernel that takes these inputs needs besides its
    output (``tf32_workspace_floats`` in the source, which checks what it is
    given against this sum): where f32 K and V come split
    (``PRESPLIT_HEAD_DIM_PAIRS``), K_hi and K_lo (K's shape) and Vᵀ_hi and
    Vᵀ_lo (dv rows of Skv keys rounded up to SPLIT_KEYS) a KV head; else
    none."""
    if kernel_kind(dtype, d, dv) != F32_TF32 or (d, dv) not in PRESPLIT_HEAD_DIM_PAIRS:
        return 0
    keys_pad = -(-Skv // SPLIT_KEYS) * SPLIT_KEYS
    return 2 * B * Hkv * (Skv * d + dv * keys_pad)


def dynamic_smem_bytes(d: int, dv: int, dtype: torch.dtype = torch.float32) -> int:
    """Shared memory one block of the kernel that takes (d, dv, dtype) asks
    for at launch (``smem_bytes``, ``mla_smem_bytes`` and ``Tf32Tiles::SMEM``
    in the source). bf16: the Q tile, the ring of K and V tiles of
    :func:`tiles`' keys (Q and K in whole 64-column panels: d 96 takes 128),
    one barrier per stage for full and for empty and one for Q, and 1024 bytes
    of slack to align the tiles to their swizzle pattern. f32 on the tensor
    cores, with a block's columns (all of them, or at (256, 256) half of d
    and of dv): the Q tile (split in place into Q_hi) and Q_lo, two stages of
    five tiles of :func:`tiles`' keys (K split in place, K_lo, V, Vᵀ_hi, Vᵀ_lo)
    and three barriers per stage and one for Q, and the slack; where K and V
    come split, the stages hold four tiles (K_hi, K_lo, Vᵀ_hi, Vᵀ_lo) and two
    barriers a stage (three stages, or two where three do not fit); at (256,
    256) besides, the cluster's exchange slots (two a consumer warpgroup of
    64 rows by the tile's keys) and a barrier each."""
    (bq, bk) = tiles(dtype, d, dv)
    if kernel_kind(dtype, d, dv) == BF16:
        n, dp = stages(d, dv), -(-d // 64) * 64
        return 1024 + 2 * (bq * dp + n * bk * (dp + dv)) + 8 * (2 * n + 1)
    return _tf32_smem(d, dv, tf32_stages(d, dv))


def _tf32_smem(d: int, dv: int, n: int) -> int:
    """``Tf32Tiles::SMEM`` of the f32 kernel at (d, dv) with a ring of n stages."""
    (bq, bk), c = tiles(torch.float32, d, dv), cluster_blocks(torch.float32, d, dv)
    dl, dvl = d // c, dv // c
    if (d, dv) not in PRESPLIT_HEAD_DIM_PAIRS:
        return 1024 + 4 * (2 * bq * dl + n * bk * (2 * dl + 3 * dvl)) + 8 * (3 * n + 1)
    slots = CONSUMERS * 2 if c > 1 else 0
    return 1024 + 4 * (2 * bq * dl + n * bk * (2 * dl + 2 * dvl) + slots * 64 * bk) + 8 * (2 * n + 1 + slots)


def launch_config(dtype: torch.dtype, d: int, dv: int) -> dict:
    """The block of the kernel that takes (d, dv, dtype), as the library
    reports it: query rows ``bq``, keys a tile ``bk``, ring ``stages``,
    ``smem_bytes`` of dynamic shared memory, ``threads``, blocks a
    ``cluster`` and ``clusters_resident``, the clusters the card holds at
    once (0 without a cluster). Builds the library, so it needs the CUDA
    toolkit and a card."""
    out = (ctypes.c_int * 7)()
    _build.check(_build.library().repro_flash_attention_config(kernel_kind(dtype, d, dv), d, dv, out),
                 "flash_attention config")
    return dict(zip(("bq", "bk", "stages", "smem_bytes", "threads", "cluster", "clusters_resident"), out))


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
