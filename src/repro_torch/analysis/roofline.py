"""Three-term roofline under an NVIDIA H100's peaks (the port of
``repro.analysis.roofline``), and the work of each of the port's kernels.

    compute term    = Σ_unit FLOPs(unit) / peak FLOP/s(unit)
    memory term     = HBM bytes / HBM bandwidth
    collective term = Σ_link wire bytes(link) / bandwidth(link)

all per device and per step. FLOPs are split by the unit that runs them: bf16
products on the tensor cores, f32 products outside them (the port's f32
GEMMs run without TF32) and K1's f32 attention as three TF32 products on the
tensor cores. Wire bytes are split by link: NVLink inside a node (``link``,
collectives over the mesh's ``model`` axis) and the network across nodes
(``net``, over ``data`` and ``pod``; :mod:`repro_torch.launch.mesh` lays a
job out this way). With one unit and one link the report is the reference's
formula. The counts come from :mod:`repro_torch.analysis.opstats`;
``MODEL_FLOPS`` = 6·N·D for a train step (N the active parameters for MoE),
2·N·D for a forward.

The work functions give each kernel's (FLOPs, bytes, unit) from its inputs'
shapes: each input read once and each output written once, and, where the
work depends on the data, what these inputs need (the pairs a causal or
windowed mask keeps). ``chip_smoke.py`` holds each kernel's time against
:func:`bound` of its work, and the count charges the same work for each call.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HW:
    """One device's peaks. The defaults are an NVIDIA H100 SXM at its full
    700 W from NVIDIA's data sheet, dense rates without sparsity: published
    peaks, not measurements (a card set below 700 W runs slower under load).

    ``peak_flops``: FLOP/s by unit (bf16 on the tensor cores, f32 outside
    them, TF32 on them); ``hbm_bw``: HBM bytes/s; ``hbm_bytes``: HBM
    capacity; ``link_bw``: NVLink 4 bytes/s in one direction, for collectives
    inside a node; ``net_bw``: one 400 Gb/s network port a GPU, for
    collectives across nodes; ``node_gpus``: the GPUs NVLink joins."""

    peak_flops: dict = dataclasses.field(
        default_factory=lambda: {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12})
    hbm_bw: float = 3.35e12
    hbm_bytes: float = 80e9
    link_bw: float = 450e9
    net_bw: float = 50e9
    node_gpus: int = 8

    def link_bandwidth(self, link: str) -> float:
        """Bytes/s of a link by name: ``link`` (NVLink) or ``net``."""
        return {"link": self.link_bw, "net": self.net_bw}[link]


H100 = HW()


def unit_of(dtype) -> str:
    """The unit key of a dtype (a ``torch.dtype`` or its name): ``bfloat16``
    for the 16-bit floats, ``float32`` else."""
    name = str(dtype).removeprefix("torch.")
    return "bfloat16" if name in ("bfloat16", "float16") else "float32"


def roofline_report(
    *,
    per_device_flops: float,
    per_device_hbm_bytes: float,
    per_device_wire_bytes: float,
    chips: int,
    model_flops: float,
    tokens: float,
    hw: HW = H100,
    flops_by_unit: "dict | None" = None,
    wire_bytes_by_link: "dict | None" = None,
    unit: str = "bfloat16",
) -> dict:
    """All quantities per step; terms in seconds, the bottleneck, and the
    reference's derived figures. ``flops_by_unit`` splits
    ``per_device_flops`` over the units (all of it at ``unit`` when not
    given); ``wire_bytes_by_link`` splits the wire bytes over ``link`` and
    ``net`` (all over ``link`` when not given). ``roofline_fraction_mfu`` is
    the model's FLOP/s at the overlapped lower bound over the peak of
    ``unit``, the model's dtype."""
    by_unit = flops_by_unit if flops_by_unit is not None else {unit: per_device_flops}
    by_link = wire_bytes_by_link if wire_bytes_by_link is not None else {"link": per_device_wire_bytes}
    compute_t = sum(f / hw.peak_flops[u] for u, f in by_unit.items())
    memory_t = per_device_hbm_bytes / hw.hbm_bw
    collective_t = sum(b / hw.link_bandwidth(k) for k, b in by_link.items())
    terms = {"compute": compute_t, "memory": memory_t, "collective": collective_t}
    bottleneck = max(terms, key=terms.get)
    step_time = max(terms.values())  # perfectly-overlapped lower bound
    total_flops = per_device_flops * chips
    useful_ratio = model_flops / total_flops if total_flops else 0.0
    peak = hw.peak_flops[unit]
    mfu = model_flops / (step_time * chips * peak) if step_time > 0 else 0.0
    return {
        "compute_s": compute_t,
        "memory_s": memory_t,
        "collective_s": collective_t,
        "bottleneck": bottleneck,
        "step_time_lb_s": step_time,
        "model_flops": model_flops,
        "hlo_flops_total": total_flops,  # the reference's key: the counted FLOPs of all devices
        "useful_flop_ratio": useful_ratio,
        "roofline_fraction_mfu": mfu,
        "tokens_per_s_lb": tokens / step_time if step_time > 0 else 0.0,
        "chips": chips,
    }


# ---------------------------------------------------------------------------
# The kernels' work: (FLOPs, bytes, unit)
# ---------------------------------------------------------------------------


def kept_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(q, k) pairs a mask keeps, query i at position i and key j at j, both
    from 0 (the kernels' convention): j <= i when causal, i - j < window when
    ``window`` > 0. In closed form: the pairs on the diagonal d = i - j of
    the Sq × Skv grid are min(Sq, Skv + d) - max(0, d), linear in d between
    the kinks at d = 0 and d = Sq - Skv, so the kept diagonals sum as
    arithmetic series."""
    lo = max(0 if causal else -(Skv - 1), -(Skv - 1))
    hi = min(window - 1 if window > 0 else Sq - 1, Sq - 1)
    if Sq <= 0 or Skv <= 0 or lo > hi:
        return 0

    def on_diagonal(d):
        return min(Sq, Skv + d) - max(0, d)

    cuts = sorted({lo, hi + 1} | {k + 1 for k in (0, Sq - Skv) if lo <= k < hi})
    return sum((e - s) * (on_diagonal(s) + on_diagonal(e - 1)) // 2 for s, e in zip(cuts, cuts[1:]))


def attention_work(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, d: int, dv: int, dtype, causal: bool,
                   window: int, kernel: bool = True) -> tuple:
    """K1: q·k and p·v for each kept pair at the real (not the tiles') head
    widths; bytes q, k, v in and the output out. f32 on the tensor-core
    kernels (``kernel``) is three TF32 products (hi·hi, hi·lo, lo·hi) at the
    TF32 rate; f32 with ``kernel`` false is one product on the FMA units."""
    pairs = B * Hq * kept_pairs(Sq, Skv, causal, window)
    flops = pairs * (2 * d + 2 * dv)
    nbytes = (B * Hq * Sq * d + B * Hkv * Skv * d + B * Hkv * Skv * dv + B * Hq * Sq * dv) * dtype.itemsize
    unit = unit_of(dtype)
    if unit == "float32" and kernel:
        return 3 * flops, nbytes, "tf32"
    return flops, nbytes, unit


def rmsnorm_work(rows: int, D: int, dtype, weight_itemsize: int = 4) -> tuple:
    """K2: about 4 operations an element (square, sum, scale, weight); x in
    and y out, the weight (read as f32 by the kernel) once."""
    n = rows * D
    return 4 * n, 2 * n * dtype.itemsize + D * weight_itemsize, unit_of(dtype)


def lru_work(B: int, T: int, W: int, dtype) -> tuple:
    """K3: h = a·h + b, 2 f32 operations a step and channel; a and b in, h
    out, h0 in and h_final out (f32)."""
    n = B * T * W
    return 2 * n, 3 * n * dtype.itemsize + 2 * B * W * 4, "float32"


def wkv6_work(B: int, H: int, T: int, d: int, dtype) -> tuple:
    """K4, the sequential form: about 5 f32 operations per state element per
    token; r, k, v, w in and y out, u in (f32), s0 in and S_final out (f32)."""
    return 5 * B * H * T * d * d, 5 * B * H * T * d * dtype.itemsize + H * d * 4 + 2 * B * H * d * d * 4, "float32"


def moe_gating_work(G: int, N: int, E: int, k: int) -> tuple:
    """K5: softmax (max, subtract, exp, add, divide) and k rounds of compares
    per logit; f32 logits in, idx, gate and pos (4 bytes each) out."""
    n = G * N * E
    return (5 + k) * n, n * 4 + 3 * G * N * k * 4, "float32"


def bound(work: tuple, hw: HW = H100) -> tuple:
    """(ms, "operations" or "bytes"): the least time for ``work`` (FLOPs,
    bytes, unit) on ``hw``, the larger of the operations over the unit's
    peak and the bytes over HBM bandwidth, and which of the two sets it."""
    flops, nbytes, unit = work
    t_ops, t_bytes = flops / hw.peak_flops[unit], nbytes / hw.hbm_bw
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")
