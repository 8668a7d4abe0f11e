"""The port's kernels: plain versions against the JAX package, dispatch, and
(on a card) the Hopper kernels against their plain versions.

On the CPU, inputs come from a seeded numpy generator and go through the JAX
Pallas kernel in interpret mode, the JAX oracle and the port's plain version.
Tolerances are those of tests/test_kernels.py: attention f32 atol 2e-5 /
rtol 1e-4, bf16 atol 0.05; RMSNorm f32 1e-5, bf16 0.05; LRU 1e-5; WKV atol
5e-4 / rtol 1e-3; MoE gating idx and pos exact, gate 1e-6. On the card, bf16 attention is held to atol 1e-3 / rtol
2**-7: kernel and plain version both accumulate in f32 and round once. The
bf16 attention kernel's arithmetic (64-key tiles, P split into bf16 hi and lo
parts for the tensor cores) is emulated on the CPU and held to that limit
against the JAX package, and so is the f32 tensor-core kernels' (3xTF32: each
operand split into TF32 hi and lo parts; 64-key tiles at (64, 64), 32-key
tiles at MLA's (96, 64), 16-key tiles at (128, 128)) at the f32 limit.

JAX is imported inside a fixture, so that the card's machine, which has no
JAX, can run the ``gpu`` tests of this file (``python -m pytest -m gpu``).
"""

import itertools
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import moe_gating as tgate
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as tlru
from repro_torch.kernels import rmsnorm as trn
from repro_torch.kernels import rwkv6_scan as twkv


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.kernels.flash_attention import flash_attention
    from repro.kernels.moe_gating import moe_gating_pallas
    from repro.kernels.ref import attention_ref, lru_ref, moe_gating_ref, rmsnorm_ref, wkv6_ref
    from repro.kernels.rmsnorm import rmsnorm_pallas
    from repro.kernels.rwkv6_scan import wkv6_pallas

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, flash_attention=flash_attention,
        attention_ref=attention_ref, rmsnorm_ref=rmsnorm_ref, rmsnorm_pallas=rmsnorm_pallas,
        lru_ref=lru_ref, wkv6_ref=wkv6_ref, wkv6_pallas=wkv6_pallas, ops=jops,
        moe_gating_ref=moe_gating_ref, moe_gating_pallas=moe_gating_pallas,
    )


H100_SMS = 132


def draw(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


# name: (B, Hq, Hkv, Sq, Skv, d, causal, window, logit_cap, input scale)
ATTN_CASES = {
    "causal": (1, 2, 2, 64, 64, 32, True, 0, 0.0, 1.0),
    "gqa": (2, 4, 1, 128, 128, 64, True, 0, 0.0, 1.0),
    "ragged_gqa": (1, 8, 2, 96, 160, 32, True, 0, 0.0, 1.0),
    "odd_sizes": (1, 2, 2, 33, 65, 16, True, 0, 0.0, 1.0),
    "window": (1, 2, 2, 128, 128, 32, True, 16, 0.0, 1.0),
    "logit_cap": (1, 2, 2, 64, 64, 32, True, 0, 30.0, 4.0),
    "non_causal": (2, 2, 2, 40, 100, 32, False, 0, 0.0, 1.0),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_plain_attention_matches_jax(jx, case):
    B, Hq, Hkv, Sq, Skv, d, causal, window, cap, scale = ATTN_CASES[case]
    qn, kn, vn = draw(0, (B, Hq, Sq, d), (B, Hkv, Skv, d), (B, Hkv, Skv, d), scale=scale)
    vn = vn / scale
    kw = dict(causal=causal, window=window, logit_cap=cap)
    got = ref.attention_ref(torch.from_numpy(qn), torch.from_numpy(kn), torch.from_numpy(vn), **kw)
    q, k, v = (jx.jnp.asarray(a) for a in (qn, kn, vn))
    pallas = jx.flash_attention(q, k, v, block_q=32, block_k=32, interpret=True, **kw)
    oracle = jx.attention_ref(q, k, v, **kw)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_plain_attention_bf16_matches_jax(jx):
    qn, kn, vn = draw(1, (1, 4, 64, 64), (1, 2, 64, 64), (1, 2, 64, 64))
    bf = jx.jnp.bfloat16
    q, k, v = (jx.jnp.asarray(a, bf) for a in (qn, kn, vn))
    want = jx.flash_attention(q, k, v, interpret=True)
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in (qn, kn, vn))
    got = ref.attention_ref(qt, kt, vt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=0.05)


def kernel_blocks(Sq, Skv, causal, window, BQ, BK):
    """The blocks of the tensor-core attention kernels, in their order: for
    each block of BQ query rows, the run [kt_begin, kt_end) of BK-key tiles
    that the block loads and, for each of its two 64-row consumer
    warpgroups, its rows that exist and the tiles live for them among the
    block's (none for a warpgroup past Sq)."""
    n_k = -(-Skv // BK)
    for q0 in range(0, Sq, BQ):
        kt_end = min(n_k, (min(q0 + BQ, Sq) - 1) // BK + 1) if causal else n_k
        kt_begin = (q0 - window + 1) // BK if causal and window > 0 and q0 - window + 1 > 0 else 0
        kt_begin = min(kt_begin, kt_end)
        groups = []
        for first in range(q0, q0 + BQ, 64):
            rows = torch.arange(first, max(first, min(first + 64, Sq)))
            last = int(rows[-1]) if len(rows) else -1
            live = [kt for kt in range(kt_begin, kt_end) if len(rows) and not (
                causal and (kt * BK > last or (window > 0 and kt * BK + BK - 1 <= first - window)))]
            groups.append((rows, live))
        yield kt_begin, kt_end, groups


def kernel_tiles(Sq, Skv, causal, window, BQ, BK):
    """Each warpgroup's rows and the key positions of its live tiles, as
    :func:`kernel_blocks` gives them."""
    for _, _, groups in kernel_blocks(Sq, Skv, causal, window, BQ, BK):
        for rows, live in groups:
            if len(rows):
                yield rows, [torch.arange(kt * BK, min(kt * BK + BK, Skv)) for kt in live]


def emulate_tiled(q, k, v, scores, weigh, out_dtype, *, tiles, causal=True, window=0, logit_cap=0.0):
    """The online softmax of the tensor-core kernels on the CPU, over
    :func:`kernel_tiles` at ``tiles`` (BQ, BK): ``scores(q_rows, k_cols)``
    gives S in f32 (scaled),
    then the tanh cap, the masks at -1e30 (keys past Skv take no part), the
    running max, p = exp(s - m) in f32, l summed from the f32 p, and
    ``weigh(p, v_cols)`` gives the tile's P·V; out = acc / max(l, 1e-30).
    (The kernels keep scores in units of log2 e and skip rescaling acc by a
    factor of 1: the same numbers to an f32 rounding.)"""
    B, Hq, Sq, d = q.shape
    Hkv, Skv, dv = v.shape[1], v.shape[2], v.shape[3]
    qf = q.float()
    kf = k.float().repeat_interleave(Hq // Hkv, dim=1)
    vf = v.float().repeat_interleave(Hq // Hkv, dim=1)
    out = torch.zeros((B, Hq, Sq, dv))
    for rows, live in kernel_tiles(Sq, Skv, causal, window, *tiles):
        m = torch.full((B, Hq, len(rows)), -1e30)
        l = torch.zeros((B, Hq, len(rows)))
        acc = torch.zeros((B, Hq, len(rows), dv))
        for cols in live:
            s = scores(qf[:, :, rows], kf[:, :, cols])
            if logit_cap > 0:
                s = logit_cap * torch.tanh(s / logit_cap)
            keep = torch.ones((len(rows), len(cols)), dtype=torch.bool)
            if causal:
                keep &= cols[None, :] <= rows[:, None]
            if window > 0:
                keep &= rows[:, None] - cols[None, :] < window
            s = torch.where(keep, s, torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + weigh(p, vf[:, :, cols])
            m = m_new
        out[:, :, rows] = acc / l.clamp_min(1e-30)[..., None]
    return out.to(out_dtype)


def emulate_bf16_kernel(q, k, v, *, causal=True, window=0, logit_cap=0.0, split=True):
    """The arithmetic of the bf16 kernels (csrc/flash_attention.cu) on the
    CPU, with the wrapper's tiles for (d, dv) (``flash_attention.tiles``: 128
    keys a tile at MLA's (96, 64), else 64): S from the bf16 products summed
    in f32,
    times the f32 d**-0.5; P split into bf16 hi and lo (rounded once when
    ``split`` is False), each multiplied with V into the f32 acc; out in
    bf16."""
    scale = float(np.float32(1) / np.sqrt(np.float32(q.shape[-1])))

    def weigh(p, vt):
        hi = p.bfloat16().float()
        pv = hi @ vt
        return pv + (p - hi).bfloat16().float() @ vt if split else pv

    return emulate_tiled(q, k, v, lambda qt, kt: (qt @ kt.transpose(-1, -2)) * scale, weigh, torch.bfloat16,
                         tiles=tfa.tiles(torch.bfloat16, q.shape[-1], v.shape[-1]),
                         causal=causal, window=window, logit_cap=logit_cap)


def tf32(x):
    """Round f32 to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties away
    from zero, onto 10 explicit mantissa bits; the 13 low bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


# The f32 kernel's order of the 8 keys of each group in its P·V product: the
# A fragment's column c holds the S fragment's key KEY_ORDER[c], so that a
# thread's S registers are its P registers as they stand.
KEY_ORDER = [0, 2, 4, 6, 1, 3, 5, 7]


def emulate_f32_kernel(q, k, v, *, causal=True, window=0, logit_cap=0.0, split=True, halves=None):
    """The arithmetic of the f32 tensor-core kernels (csrc/flash_attention.cu,
    ``flash_attn_tf32_kernel`` at (64, 64), ``flash_attn_tf32_mla_kernel`` at
    (96, 64), ``flash_attn_tf32_d128_kernel`` at (128, 128),
    ``flash_attn_tf32_d128_dv64_kernel`` at (128, 64),
    ``flash_attn_tf32_d64_dv128_kernel`` at (64, 128) and
    ``flash_attn_tf32_d256_kernel`` at (256, 256)) on the CPU, with the
    wrapper's tiles for the input's (d, dv) (``flash_attention.tiles``: 32
    keys a tile at (96, 64), 16 where K and V come split, else 64): q
    pre-scaled by d**-0.5 in f32, as the Pallas kernel does; S = Q_hi K_hi +
    Q_hi K_lo + Q_lo K_hi summed in f32, each part rounded by :func:`tf32`,
    the two small products summed apart and added to the large one; at
    (256, 256) each of the cluster's two blocks sums that over its half of d
    and S is half 0 + half 1; P·V the same three products of the split p and
    V, over the keys of each group of 8 in ``KEY_ORDER``, added to the
    rescaled acc. With ``split`` False, one TF32 product each: Q K and P V
    from singly rounded operands; ``halves`` overrides the blocks that split
    d."""
    d, dv = q.shape[-1], v.shape[-1]
    scale = float(np.float32(1) / np.sqrt(np.float32(d)))
    width = d // (halves or tfa.cluster_blocks(torch.float32, d, dv))  # a block's columns of Q and K

    def product(a, b):
        if not split:
            return tf32(a) @ tf32(b)
        (a_hi, a_lo), (b_hi, b_lo) = split_tf32(a), split_tf32(b)
        return a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi)

    def scores(qt, kt):
        halves = [product(qt[..., c:c + width], kt[..., c:c + width].transpose(-1, -2)) for c in range(0, d, width)]
        return sum(halves[1:], halves[0])

    def weigh(p, vt):
        n = p.shape[-1]
        order = torch.tensor([g + c for g in range(0, n, 8) for c in KEY_ORDER if g + c < n])
        return product(p[..., order], vt[..., order, :])

    return emulate_tiled(q * scale, k, v, scores, weigh, torch.float32,
                         tiles=tfa.tiles(torch.float32, d, dv), causal=causal, window=window, logit_cap=logit_cap)


# bf16 attention on the card: one output rounding of either side
BF16_ATTN_TOL = dict(atol=1e-3, rtol=2**-7)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_bf16_kernel_arithmetic_matches_jax(jx, case):
    """The bf16 kernel's arithmetic meets the card's limit against the JAX
    Pallas kernel in interpret mode, the JAX oracle and the plain version."""
    B, Hq, Hkv, Sq, Skv, d, causal, window, cap, scale = ATTN_CASES[case]
    qn, kn, vn = draw(16, (B, Hq, Sq, d), (B, Hkv, Skv, d), (B, Hkv, Skv, d), scale=scale)
    vn = vn / scale
    kw = dict(causal=causal, window=window, logit_cap=cap)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in (qn, kn, vn))
    got = emulate_bf16_kernel(q, k, v, **kw).float().numpy()
    jq, jk, jv = (jx.jnp.asarray(t.float().numpy(), jx.jnp.bfloat16) for t in (q, k, v))
    pallas = jx.flash_attention(jq, jk, jv, block_q=32, block_k=32, interpret=True, **kw)
    for want in (pallas, jx.attention_ref(jq, jk, jv, **kw), ref.attention_ref(q, k, v, **kw).float()):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), **BF16_ATTN_TOL)


# MLA's prefill pair (d, dv) = (96, 64) in the bf16 MLA kernel (blocks of
# 128 rows, two warpgroups of 64, 128-key tiles): name: (B, Hq, Hkv, Sq, Skv,
# causal, window)
MLA_CASES = {
    "causal": (1, 4, 4, 130, 130, True, 0),
    "non_causal_ragged": (1, 2, 2, 77, 150, False, 0),
    "window": (1, 2, 2, 200, 200, True, 48),
    # Sq = 1, 63, 64 and 65 past a block: one row, a warpgroup one short, a
    # block whose second warpgroup has no rows, a second warpgroup of one row
    "sq_129": (1, 2, 2, 129, 129, True, 0),
    "sq_191": (1, 2, 2, 191, 191, True, 0),
    "sq_192": (1, 2, 2, 192, 192, True, 0),
    "sq_193": (1, 2, 2, 193, 193, True, 0),
    # Skv shorter than a tile, causal and not
    "short_kv_causal": (1, 2, 2, 100, 100, True, 0),
    "short_kv_non_causal": (1, 2, 2, 60, 100, False, 0),
    # a window under 64 keys: a block's second warpgroup starts a tile later
    "window_turns_differ": (1, 2, 2, 300, 300, True, 40),
}


@pytest.mark.parametrize("case", sorted(MLA_CASES))
def test_bf16_kernel_arithmetic_at_mla_head_dims_matches_jax(jx, case):
    """At (96, 64) the bf16 kernel's arithmetic (scale 96**-0.5 from the real
    d) meets the card's limit against the JAX oracle and the plain version."""
    B, Hq, Hkv, Sq, Skv, causal, window = MLA_CASES[case]
    arrays = draw(17, (B, Hq, Sq, 96), (B, Hkv, Skv, 96), (B, Hkv, Skv, 64))
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrays)
    kw = dict(causal=causal, window=window)
    got = emulate_bf16_kernel(q, k, v, **kw).float().numpy()
    assert got.shape == (B, Hq, Sq, 64)
    jq, jk, jv = (jx.jnp.asarray(t.float().numpy(), jx.jnp.bfloat16) for t in (q, k, v))
    for want in (jx.attention_ref(jq, jk, jv, **kw), ref.attention_ref(q, k, v, **kw).float()):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), **BF16_ATTN_TOL)


def test_mla_head_dims_take_whole_panels():
    """(96, 64) runs the bf16 MLA kernel with Q and K tiles of two 64-column
    panels (the second half zeros), 128-key tiles and three stages, and f32
    on the tensor cores as 3xTF32 with Q and K tiles of three 32-column panels
    and 32-key tiles in two stages; f32 (128, 128) runs on the tensor cores
    too, at 16-key tiles in three stages of K and V split beforehand; the
    other bf16 pairs keep 64-key tiles."""
    assert tfa.MLA_HEAD_DIMS in tfa.HEAD_DIM_PAIRS
    assert tfa.kernel_kind(torch.bfloat16, 96, 64) == tfa.BF16
    assert tfa.kernel_kind(torch.float32, 96, 64) == tfa.F32_TF32
    assert tfa.tiles(torch.bfloat16, 96, 64) == (128, 128)
    assert tfa.tiles(torch.float32, 96, 64) == (128, 32)
    assert tfa.stages(96, 64) == 3
    assert tfa.dynamic_smem_bytes(96, 64, torch.bfloat16) == 1024 + 2 * (128 * 128 + 3 * 128 * (128 + 64)) + 8 * 7
    assert tfa.dynamic_smem_bytes(96, 64, torch.bfloat16) == 181304
    # Q and Q_lo (128 rows x 3 panels), two stages of K, K_lo (32 keys x 3
    # panels), V, V^T_hi, V^T_lo (2 panels), the barriers, the slack
    assert tfa.dynamic_smem_bytes(96, 64, torch.float32) == 1024 + 2 * 49152 + 2 * (2 * 12288 + 3 * 8192) + 8 * 7
    assert tfa.dynamic_smem_bytes(96, 64, torch.float32) == 197688
    # Q and Q_lo (128 rows x 4 panels), three stages of K_hi, K_lo (16 keys x
    # 4 panels), V^T_hi, V^T_lo (128 rows of 16 keys), two barriers a stage
    # and one for Q, the slack
    assert tfa.kernel_kind(torch.float32, 128, 128) == tfa.F32_TF32
    assert tfa.tiles(torch.float32, 128, 128) == (128, 16)
    assert tfa.tf32_stages(128, 128) == 3 and tfa.tf32_stages(96, 64) == tfa.tf32_stages(64, 64) == 2
    assert tfa.dynamic_smem_bytes(128, 128, torch.float32) == 1024 + 2 * 65536 + 3 * (4 * 8192) + 8 * 7
    assert tfa.dynamic_smem_bytes(128, 128, torch.float32) == 230456
    assert {tfa.tiles(torch.bfloat16, d, dv) for d, dv in tfa.HEAD_DIM_PAIRS if (d, dv) != (96, 64)} == {(128, 64)}
    assert {tfa.stages(d, dv) for d, dv in tfa.HEAD_DIM_PAIRS if (d, dv) != (96, 64)} == {2, 4}


def test_each_kernel_has_its_own_launch_count():
    """A call adds one to the count of the kernel that takes it: the MLA pair
    (96, 64) has a count of its own in bf16, and every f32 pair one of its own
    (each its own tensor-core kernel; no f32 pair is left on the FMA units)."""
    names = {(dtype, pair): tfa.launch_count(dtype, *pair) for dtype in tfa.DTYPES for pair in tfa.HEAD_DIM_PAIRS}
    assert names[torch.float32, (96, 64)] == "tf32_mla_launches"
    assert names[torch.float32, (64, 64)] == "tf32_launches"
    assert names[torch.float32, (128, 128)] == "tf32_d128_launches"
    assert names[torch.float32, (128, 64)] == "tf32_d128_dv64_launches"
    assert names[torch.float32, (64, 128)] == "tf32_d64_dv128_launches"
    assert names[torch.float32, (256, 256)] == "tf32_d256_launches"
    assert names[torch.bfloat16, (96, 64)] == "bf16_mla_launches"
    assert {names[torch.bfloat16, pair] for pair in tfa.HEAD_DIM_PAIRS if pair != (96, 64)} == {"bf16_launches"}
    assert len({names[torch.float32, pair] for pair in tfa.HEAD_DIM_PAIRS}) == len(tfa.HEAD_DIM_PAIRS)
    assert {tfa.kernel_kind(torch.float32, *pair) for pair in tfa.HEAD_DIM_PAIRS} == {tfa.F32_TF32}
    assert set(tfa.TF32_HEAD_DIM_PAIRS) == set(tfa.HEAD_DIM_PAIRS)
    assert not hasattr(tfa, "launches") and not hasattr(tfa, "F32_SIMT")
    assert all(isinstance(getattr(tfa, name), int) for name in names.values())


def test_only_f32_d128_needs_a_workspace():
    """Only the f32 pairs whose K and V come split ask for scratch: (128,
    128), (128, 64), (64, 128) and (256, 256); K_hi and K_lo in K's shape,
    and V^T_hi and V^T_lo over keys padded to the split kernel's 32."""
    sizes = {(dtype, pair): tfa.workspace_floats(dtype, 2, 4, 33, *pair)
             for dtype in tfa.DTYPES for pair in tfa.HEAD_DIM_PAIRS}
    assert {key for key, n in sizes.items() if n} == {
        (torch.float32, pair) for pair in ((128, 128), (128, 64), (64, 128), (256, 256))}
    assert sizes[torch.float32, (128, 128)] == 2 * (2 * 4 * 33 * 128) + 2 * (2 * 4 * 128 * 64)
    for d, dv in ((128, 64), (64, 128), (256, 256)):
        assert sizes[torch.float32, (d, dv)] == 2 * (2 * 4 * 33 * d) + 2 * (2 * 4 * dv * 64)


def mla_turns(wg, kt_begin, kt_end, live):
    """The barrier operations of consumer warpgroup ``wg`` of the bf16 MLA
    kernel, in its order (``flash_attn_bf16_mla_kernel``), given the block's
    tiles and the run ``live`` of its own: ("full", kt) waits for tile kt,
    ("empty", kt) releases it, ("sync", w) waits for warpgroup w's turn and
    ("arrive", w) hands the turn to w. One turn a tile, plus one."""
    live_begin, live_end = (live[0], live[-1] + 1) if live else (kt_end, kt_end)

    def turn(kt, release=()):
        if kt < kt_end:
            yield "full", kt
        yield "sync", wg
        if wg == 0 or kt < kt_end:
            yield "arrive", 1 - wg
        for r in release:
            yield "empty", r

    if wg == 1:
        yield "arrive", 0  # warpgroup 0 takes the first turn
    for kt in range(kt_begin, live_begin):
        yield from turn(kt, [kt])
    kt = live_begin
    if live_begin < live_end:
        yield from turn(kt)  # S of the first live tile alone
        for kt in range(live_begin + 1, live_end):
            yield from turn(kt, [kt - 1])  # S of kt, P V of kt - 1
        kt = live_end
        yield from turn(kt, [kt - 1] + ([kt] if kt < kt_end else []))
        kt += 1
    for kt in range(kt, kt_end + 1):
        yield from turn(kt, [kt] if kt < kt_end else [])


def run_mla_block(kt_begin, kt_end, groups, stages, order):
    """Run one block's producer and two consumers against a model of the
    mbarriers (full: one TMA landing a phase; empty: one arrival a consumer
    a phase, waits by parity) and of the two named turn barriers (a bar.sync
    of one warpgroup and a bar.arrive of the other complete a phase), picking
    among the agents that can move in ``order``'s sequence of choices. Fails
    on a deadlock, on an arrival that would count twice in one phase, on a
    parity wait two phases behind, and on a barrier left waiting."""
    full = [0] * stages  # completed phases
    empty = [0] * stages
    empty_in = [set() for _ in range(stages)]  # arrivals in the open phase
    turn_in = [set(), set()]  # named barrier w: warpgroups in the open phase
    turn_done = [0, 0]

    def producer():
        for i, kt in enumerate(range(kt_begin, kt_end)):
            if i >= stages:
                yield "wait_empty", kt
            yield "load", kt

    agents = {"producer": producer(), 0: mla_turns(0, kt_begin, kt_end, groups[0][1]),
              1: mla_turns(1, kt_begin, kt_end, groups[1][1])}
    pending = {name: next(gen, None) for name, gen in agents.items()}
    blocked_on = {}  # a warpgroup inside bar.sync: (barrier, phase it joined)
    turns = {0: 0, 1: 0}

    def ready(name, op):
        kind, x = op
        if kind in ("full", "wait_empty"):
            i = x - kt_begin
            phase, bars = (i // stages, full) if kind == "full" else (i // stages - 1, empty)
            done = bars[i % stages]
            assert done <= phase + 1, f"{name} waits on parity {phase} two phases behind"
            return done > phase
        if kind == "sync" and name in blocked_on:
            w, phase = blocked_on[name]
            return turn_done[w] > phase
        return True

    for step in itertools.count():
        movable = [name for name, op in pending.items() if op is not None and ready(name, op)]
        if not movable:
            break
        name = movable[order[step % len(order)] % len(movable)]
        kind, x = pending[name]
        if kind == "load":
            full[(x - kt_begin) % stages] += 1
        elif kind == "empty":
            s = (x - kt_begin) % stages
            assert name not in empty_in[s], f"warpgroup {name} releases stage {s} twice in one phase"
            empty_in[s].add(name)
            if len(empty_in[s]) == 2:
                empty[s] += 1
                empty_in[s].clear()
        elif kind in ("sync", "arrive"):
            if kind == "sync" and name in blocked_on:  # its phase completed
                del blocked_on[name]
                turns[name] += 1
                pending[name] = next(agents[name], None)
                continue
            assert name not in turn_in[x], f"warpgroup {name} counts twice on turn barrier {x}"
            turn_in[x].add(name)
            if kind == "sync":
                blocked_on[name] = (x, turn_done[x])
            if len(turn_in[x]) == 2:
                turn_done[x] += 1
                turn_in[x].clear()
            if kind == "sync":
                continue
        pending[name] = next(agents[name], None)
    stuck = {name: op for name, op in pending.items() if op is not None}
    assert not stuck, f"deadlock: {stuck}"
    assert turn_in == [set(), set()] and not blocked_on, f"a turn barrier is left waiting: {turn_in}"
    assert all(not s for s in empty_in), "an empty barrier is left part-way"
    assert sum(full) == sum(empty) == kt_end - kt_begin  # every tile landed and was released by both
    assert turns == {0: kt_end - kt_begin + 1, 1: kt_end - kt_begin + 1}


# (Sq, Skv, causal, window): minicpm3-4b's served prefills (prompts of 128,
# 512 and 2048), chip_smoke.py's (96, 64) cases, and the edges of the turns
MLA_SCHEDULE_CASES = [
    (128, 128, True, 0), (512, 512, True, 0), (2048, 2048, True, 0),
    (333, 1000, False, 0), (1500, 1500, True, 512), (1088, 1088, True, 0), (65, 65, True, 0),
    (1, 1, True, 0), (129, 129, True, 0), (191, 191, True, 0), (192, 192, True, 0), (193, 193, True, 0),
    (100, 100, True, 0), (60, 100, False, 0), (300, 300, True, 40), (500, 500, True, 128),
    (257, 257, True, 100), (150, 70, False, 0), (1000, 100, True, 64),
]


@pytest.mark.parametrize("Sq,Skv,causal,window", MLA_SCHEDULE_CASES)
def test_mla_turns_never_deadlock(Sq, Skv, causal, window):
    """Every block of the bf16 MLA kernel at these shapes runs its turn
    protocol to the end, under in-order and shuffled interleavings, with
    every barrier met; the shapes include blocks whose warpgroups have
    unequal live tiles (causal edge, window, a warpgroup past Sq)."""
    bq, bk = tfa.tiles(torch.bfloat16, 96, 64)
    rng = np.random.default_rng(Sq * 7919 + Skv)
    orders = [[0], [1], [2], *(rng.integers(0, 3, 64).tolist() for _ in range(3))]
    unequal = 0
    for kt_begin, kt_end, groups in kernel_blocks(Sq, Skv, causal, window, bq, bk):
        unequal += len(groups[0][1]) != len(groups[1][1])
        for order in orders:
            run_mla_block(kt_begin, kt_end, groups, tfa.stages(96, 64), order)
    if (Sq, Skv, causal, window) in ((1088, 1088, True, 0), (300, 300, True, 40), (1, 1, True, 0)):
        assert unequal  # these shapes give the block's warpgroups unequal live tiles


def test_bf16_kernel_needs_p_in_two_parts():
    """At deepseek-moe-16b's head width, P rounded once to bf16 puts outputs
    outside the card's limit; the hi + lo split does not."""
    qn, kn, vn = draw(17, (1, 4, 512, 128), (1, 4, 512, 128), (1, 4, 512, 128))
    q, k, v = (torch.from_numpy(a).bfloat16() for a in (qn, kn, vn))
    want = ref.attention_ref(q, k, v).float()
    limit = BF16_ATTN_TOL["atol"] + BF16_ATTN_TOL["rtol"] * want.abs()
    outside = {split: int(((emulate_bf16_kernel(q, k, v, split=split).float() - want).abs() > limit).sum())
               for split in (True, False)}
    assert outside[True] == 0 < outside[False]


# f32 attention on the card: the unchanged f32 limit
F32_ATTN_TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_f32_kernel_arithmetic_matches_jax(jx, case):
    """The f32 tensor-core kernel's arithmetic (3xTF32) meets the f32 limit
    against the JAX Pallas kernel in interpret mode, the JAX oracle and the
    plain version."""
    B, Hq, Hkv, Sq, Skv, d, causal, window, cap, scale = ATTN_CASES[case]
    qn, kn, vn = draw(18, (B, Hq, Sq, d), (B, Hkv, Skv, d), (B, Hkv, Skv, d), scale=scale)
    vn = vn / scale
    kw = dict(causal=causal, window=window, logit_cap=cap)
    q, k, v = map(torch.from_numpy, (qn, kn, vn))
    got = emulate_f32_kernel(q, k, v, **kw).numpy()
    jq, jk, jv = map(jx.jnp.asarray, (qn, kn, vn))
    pallas = jx.flash_attention(jq, jk, jv, block_q=32, block_k=32, interpret=True, **kw)
    for want in (pallas, jx.attention_ref(jq, jk, jv, **kw), ref.attention_ref(q, k, v, **kw)):
        np.testing.assert_allclose(got, np.asarray(want), **F32_ATTN_TOL)


def test_f32_kernel_needs_three_tf32_products():
    """At nbi-100m's head width, at MLA's (96, 64) and at (128, 128), one TF32 product for
    each of Q K and P V puts outputs outside the f32 limit; the 3xTF32 split
    does not."""
    for d, dv in tfa.TF32_HEAD_DIM_PAIRS:
        qn, kn, vn = draw(19, (1, 4, 512, d), (1, 4, 512, d), (1, 4, 512, dv))
        q, k, v = map(torch.from_numpy, (qn, kn, vn))
        want = ref.attention_ref(q, k, v)
        limit = F32_ATTN_TOL["atol"] + F32_ATTN_TOL["rtol"] * want.abs()
        outside = {split: int(((emulate_f32_kernel(q, k, v, split=split) - want).abs() > limit).sum())
                   for split in (True, False)}
        assert outside[True] == 0 < outside[False], (d, dv, outside)


# MLA's f32 pair (d, dv) = (96, 64) in the f32 tensor-core MLA kernel (blocks
# of 128 rows, two warpgroups of 64, 32-key tiles): name: (B, Hq, Hkv, Sq,
# Skv, causal, window, logit_cap, input scale)
F32_MLA_CASES = {
    "causal": (1, 2, 2, 130, 130, True, 0, 0.0, 1.0),
    "ragged_non_causal": (1, 2, 2, 77, 150, False, 0, 0.0, 1.0),
    "gqa_window": (1, 4, 2, 160, 160, True, 48, 0.0, 1.0),
    "logit_cap": (1, 2, 2, 70, 70, True, 0, 30.0, 4.0),
    # a window under 32 keys: a block's second warpgroup starts two tiles later
    "window_turns_differ": (1, 2, 2, 200, 200, True, 20, 0.0, 1.0),
    # Skv one short of a tile, a tile, one past it
    "skv_31": (1, 2, 2, 40, 31, False, 0, 0.0, 1.0),
    "skv_32": (1, 2, 2, 40, 32, False, 0, 0.0, 1.0),
    "skv_33": (1, 2, 2, 40, 33, False, 0, 0.0, 1.0),
    # Sq of one row, a warpgroup, one past it, a block, one past it
    "sq_1": (1, 2, 2, 1, 1, True, 0, 0.0, 1.0),
    "sq_64": (1, 2, 2, 64, 64, True, 0, 0.0, 1.0),
    "sq_65": (1, 2, 2, 65, 65, True, 0, 0.0, 1.0),
    "sq_128": (1, 2, 2, 128, 128, True, 0, 0.0, 1.0),
    "sq_129": (1, 2, 2, 129, 129, True, 0, 0.0, 1.0),
}


@pytest.mark.parametrize("case", sorted(F32_MLA_CASES))
def test_f32_kernel_arithmetic_at_mla_head_dims_matches_jax(jx, case):
    """At (96, 64) the f32 tensor-core MLA kernel's arithmetic (3xTF32, 32-key
    tiles, scale 96**-0.5) meets the f32 limit against the JAX Pallas kernel
    in interpret mode, the JAX oracle and the plain version."""
    B, Hq, Hkv, Sq, Skv, causal, window, cap, scale = F32_MLA_CASES[case]
    qn, kn, vn = draw(22, (B, Hq, Sq, 96), (B, Hkv, Skv, 96), (B, Hkv, Skv, 64), scale=scale)
    vn = vn / scale
    kw = dict(causal=causal, window=window, logit_cap=cap)
    q, k, v = map(torch.from_numpy, (qn, kn, vn))
    got = emulate_f32_kernel(q, k, v, **kw).numpy()
    assert got.shape == (B, Hq, Sq, 64)
    jq, jk, jv = map(jx.jnp.asarray, (qn, kn, vn))
    pallas = jx.flash_attention(jq, jk, jv, block_q=32, block_k=32, interpret=True, **kw)
    for want in (pallas, jx.attention_ref(jq, jk, jv, **kw), ref.attention_ref(q, k, v, **kw)):
        np.testing.assert_allclose(got, np.asarray(want), **F32_ATTN_TOL)


def test_f32_mla_cases_reach_the_tile_edges():
    """The (96, 64) cases above reach what the 32-key tiles make an edge: a
    block whose two warpgroups have different first live tiles, a block whose
    second warpgroup has no rows, and a last tile of 31, 32 and 33 keys."""
    bq, bk = tfa.tiles(torch.float32, 96, 64)
    assert (bq, bk) == (128, 32)
    differ = idle = False
    for _, _, _, Sq, Skv, causal, window, _, _ in F32_MLA_CASES.values():
        for _, _, ((rows0, live0), (rows1, live1)) in kernel_blocks(Sq, Skv, causal, window, bq, bk):
            differ |= bool(live0 and live1 and live0[0] != live1[0])
            idle |= not len(rows1)
    assert differ and idle
    assert {31, 32, 33} <= {case[4] for case in F32_MLA_CASES.values()}


# f32 (d, dv) = (128, 128) in the f32 tensor-core d 128 kernel (blocks of 128
# rows, two warpgroups of 64, 16-key tiles): codeqwen1.5-7b's one-row inserts
# at smoke size and the tiles' edges: name: (B, Hq, Hkv, Sq, Skv, causal,
# window, logit_cap, input scale)
F32_D128_CASES = {
    "insert": (1, 2, 2, 150, 150, True, 0, 0.0, 1.0),
    "insert_64": (1, 2, 2, 64, 64, True, 0, 0.0, 1.0),
    "ragged_non_causal": (1, 2, 2, 77, 150, False, 0, 0.0, 1.0),
    "gqa": (1, 4, 1, 130, 130, True, 0, 0.0, 1.0),
    "logit_cap": (1, 2, 2, 70, 70, True, 0, 30.0, 4.0),
    # a window over several 16-key tiles, and one under a tile: a block's
    # second warpgroup starts tiles later than its first
    "window": (1, 2, 2, 200, 200, True, 40, 0.0, 1.0),
    "window_under_a_tile": (1, 2, 2, 140, 140, True, 10, 0.0, 1.0),
    # Skv under a tile, a tile, one past it (insert shapes longer than the keys)
    "skv_15": (1, 2, 2, 40, 15, False, 0, 0.0, 1.0),
    "skv_16": (1, 2, 2, 40, 16, False, 0, 0.0, 1.0),
    "skv_17": (1, 2, 2, 40, 17, False, 0, 0.0, 1.0),
    # one row; a block of one row (its second warpgroup idle); a block whose
    # second warpgroup has one row
    "sq_1": (1, 2, 2, 1, 1, True, 0, 0.0, 1.0),
    "sq_129": (1, 2, 2, 129, 129, True, 0, 0.0, 1.0),
    "sq_193": (1, 2, 2, 193, 193, True, 0, 0.0, 1.0),
}


@pytest.mark.parametrize("case", sorted(F32_D128_CASES))
def test_f32_kernel_arithmetic_at_d128_matches_jax(jx, case):
    """At (128, 128) the f32 tensor-core d 128 kernel's arithmetic (3xTF32,
    16-key tiles, scale 128**-0.5) meets the f32 limit against the JAX Pallas
    kernel in interpret mode, the JAX oracle and the plain version."""
    B, Hq, Hkv, Sq, Skv, causal, window, cap, scale = F32_D128_CASES[case]
    qn, kn, vn = draw(23, (B, Hq, Sq, 128), (B, Hkv, Skv, 128), (B, Hkv, Skv, 128), scale=scale)
    vn = vn / scale
    kw = dict(causal=causal, window=window, logit_cap=cap)
    q, k, v = map(torch.from_numpy, (qn, kn, vn))
    got = emulate_f32_kernel(q, k, v, **kw).numpy()
    assert got.shape == (B, Hq, Sq, 128)
    jq, jk, jv = map(jx.jnp.asarray, (qn, kn, vn))
    pallas = jx.flash_attention(jq, jk, jv, block_q=32, block_k=32, interpret=True, **kw)
    for want in (pallas, jx.attention_ref(jq, jk, jv, **kw), ref.attention_ref(q, k, v, **kw)):
        np.testing.assert_allclose(got, np.asarray(want), **F32_ATTN_TOL)


def test_f32_d128_cases_reach_the_tile_edges():
    """The (128, 128) cases above reach what the 16-key tiles make an edge: a
    block whose two warpgroups have different first live tiles, a second
    warpgroup with no rows and one with a single row, and a last tile of 15,
    16 and 17 keys."""
    bq, bk = tfa.tiles(torch.float32, 128, 128)
    assert (bq, bk) == (128, 16)
    differ = idle = single = False
    for _, _, _, Sq, Skv, causal, window, _, _ in F32_D128_CASES.values():
        for _, _, ((rows0, live0), (rows1, live1)) in kernel_blocks(Sq, Skv, causal, window, bq, bk):
            differ |= bool(live0 and live1 and live0[0] != live1[0])
            idle |= not len(rows1)
            single |= len(rows1) == 1
    assert differ and idle and single
    assert {15, 16, 17} <= {case[4] for case in F32_D128_CASES.values()}


# f32 (d, dv) = (256, 256), (128, 64) and (64, 128), whose K and V come split
# too (16-key tiles, 32 at the mixed pairs; (256, 256) on a cluster of two
# blocks that split the head dims): the (128, 128) cases, GQA with two query heads a
# KV head, and Skv one short of a 32-key tile, a tile, one past it: name: (B,
# Hq, Hkv, Sq, Skv, causal, window, logit_cap, input scale)
F32_SPLIT_CASES = {
    **F32_D128_CASES, "gqa_groups_of_2": (1, 4, 2, 100, 100, True, 0, 0.0, 1.0),
    "skv_31": (1, 2, 2, 40, 31, False, 0, 0.0, 1.0), "skv_32": (1, 2, 2, 40, 32, False, 0, 0.0, 1.0),
    "skv_33": (1, 2, 2, 40, 33, False, 0, 0.0, 1.0),
}
MIXED_HEAD_DIMS = ((128, 64), (64, 128))


def check_f32_emulation(jx, case, d, dv, seed):
    """The f32 tensor-core emulation at (d, dv) and case ``case`` of
    F32_SPLIT_CASES against the JAX Pallas kernel in interpret mode, the JAX
    oracle and the plain version, at the f32 limit."""
    B, Hq, Hkv, Sq, Skv, causal, window, cap, scale = F32_SPLIT_CASES[case]
    qn, kn, vn = draw(seed, (B, Hq, Sq, d), (B, Hkv, Skv, d), (B, Hkv, Skv, dv), scale=scale)
    vn = vn / scale
    kw = dict(causal=causal, window=window, logit_cap=cap)
    q, k, v = map(torch.from_numpy, (qn, kn, vn))
    got = emulate_f32_kernel(q, k, v, **kw).numpy()
    assert got.shape == (B, Hq, Sq, dv)
    jq, jk, jv = map(jx.jnp.asarray, (qn, kn, vn))
    pallas = jx.flash_attention(jq, jk, jv, block_q=32, block_k=32, interpret=True, **kw)
    for want in (pallas, jx.attention_ref(jq, jk, jv, **kw), ref.attention_ref(q, k, v, **kw)):
        np.testing.assert_allclose(got, np.asarray(want), **F32_ATTN_TOL)


@pytest.mark.parametrize("case", sorted(F32_SPLIT_CASES))
def test_f32_kernel_arithmetic_at_d256_matches_jax(jx, case):
    """At (256, 256) the cluster kernel's arithmetic (3xTF32, 16-key tiles, S
    summed per 128-column half and the halves added, scale 256**-0.5) meets
    the f32 limit against the JAX Pallas kernel in interpret mode, the JAX
    oracle and the plain version."""
    check_f32_emulation(jx, case, 256, 256, seed=24)


@pytest.mark.parametrize("case", sorted(F32_SPLIT_CASES))
@pytest.mark.parametrize("d,dv", MIXED_HEAD_DIMS)
def test_f32_kernel_arithmetic_at_mixed_matches_jax(jx, case, d, dv):
    """At (128, 64) and (64, 128) the arithmetic of their instances of the
    (128, 128) block (3xTF32, 16-key tiles) meets the f32 limit against the
    JAX Pallas kernel in interpret mode, the JAX oracle and the plain
    version."""
    check_f32_emulation(jx, case, d, dv, seed=25)


def test_f32_split_cases_reach_the_tile_edges():
    """The cases above reach what the tiles (16 keys, 32 at the mixed pairs)
    and the cluster make an edge at every new pair: a block whose two warpgroups
    have different first live tiles, a second warpgroup with no rows and one
    with a single row, a last tile one key short, full and one key past, a
    window under a tile, MQA and GQA; and the emulation at (256, 256) sums S
    per half of d, which a sum over all 256 columns at once does not repeat
    bit for bit."""
    assert [tfa.tiles(torch.float32, d, dv) for d, dv in ((256, 256), *MIXED_HEAD_DIMS)] == [
        (128, 16), (128, 32), (128, 32)]
    for d, dv in ((256, 256), *MIXED_HEAD_DIMS):
        bq, bk = tfa.tiles(torch.float32, d, dv)
        differ = idle = single = False
        for _, _, _, Sq, Skv, causal, window, _, _ in F32_SPLIT_CASES.values():
            for _, _, ((rows0, live0), (rows1, live1)) in kernel_blocks(Sq, Skv, causal, window, bq, bk):
                differ |= bool(live0 and live1 and live0[0] != live1[0])
                idle |= not len(rows1)
                single |= len(rows1) == 1
        assert differ and idle and single
        assert {bk - 1, bk, bk + 1} <= {case[4] for case in F32_SPLIT_CASES.values()}
        assert any(0 < case[6] < bk for case in F32_SPLIT_CASES.values())
    assert {(Hq, Hkv) for _, Hq, Hkv, *_ in F32_SPLIT_CASES.values()} >= {(4, 1), (4, 2), (2, 2)}
    assert [tfa.cluster_blocks(torch.float32, d, dv) for d, dv in ((256, 256), *MIXED_HEAD_DIMS)] == [2, 1, 1]
    qn, kn, vn = draw(26, (1, 2, 64, 256), (1, 2, 64, 256), (1, 2, 64, 256))
    q, k, v = map(torch.from_numpy, (qn, kn, vn))
    at_once, per_half = emulate_f32_kernel(q, k, v, halves=1), emulate_f32_kernel(q, k, v)
    assert not torch.equal(per_half, at_once)
    torch.testing.assert_close(per_half, at_once, **F32_ATTN_TOL)


def cluster_consumer_ops(kt_begin, kt_end, live):
    """The operations of one consumer warpgroup of a block of the (256, 256)
    cluster kernel, in its order (``tf32_block``), given the block's tiles and
    the run ``live`` of its own: ("full", kt) waits for tile kt's stage,
    ("send", i) stores its partial S of its i-th live tile into the peer
    block's slot of i's parity and arrives on the peer's barrier of that
    slot, ("landed", i) waits on its own barrier of that slot for phase i //
    2, ("read", i) reads the peer's partial there, ("empty", kt) releases the
    stage."""
    live = set(live)
    i = 0
    for kt in range(kt_begin, kt_end):
        yield "full", kt
        if kt in live:
            yield "send", i
            yield "landed", i
            yield "read", i
            i += 1
        yield "empty", kt


def run_cluster(kt_begin, kt_end, groups, stages, order, slots=2):
    """Run the two blocks of a cluster, each a producer and two consumer
    warpgroups over the same tiles (the blocks own the same rows), against a
    model of the mbarriers (full: one TMA landing a phase; empty: one arrival
    a consumer a phase; landed: one arrival of the peer's warpgroup a phase;
    waits by parity), picking among the agents that can move in ``order``'s
    sequence of choices. Fails on a deadlock, on a slot written again before
    its reader read it, on a read that finds another tile's partial, on a
    parity wait two phases behind, and on a barrier left part-way or an
    arrival that no wait meets."""
    full = {blk: [0] * stages for blk in (0, 1)}  # completed phases
    empty = {blk: [0] * stages for blk in (0, 1)}
    empty_in = {blk: [set() for _ in range(stages)] for blk in (0, 1)}
    landed = {(blk, wg): [0] * slots for blk in (0, 1) for wg in (0, 1)}
    slot = {(blk, wg): [None] * slots for blk in (0, 1) for wg in (0, 1)}  # (tile, read yet)

    def producer():
        for i, kt in enumerate(range(kt_begin, kt_end)):
            if i >= stages:
                yield "wait_empty", kt
            yield "load", kt

    agents = {}
    for blk in (0, 1):
        agents[blk, "producer"] = producer()
        for wg in (0, 1):
            agents[blk, wg] = cluster_consumer_ops(kt_begin, kt_end, groups[wg][1])
    pending = {name: next(gen, None) for name, gen in agents.items()}

    def ready(name, op):
        (blk, who), (kind, x) = name, op
        if kind in ("full", "wait_empty"):
            i = x - kt_begin
            phase, bars = (i // stages, full[blk]) if kind == "full" else (i // stages - 1, empty[blk])
            done = bars[i % stages]
        elif kind == "landed":
            phase, done = x // slots, landed[name][x % slots]
        else:
            return True
        assert done <= phase + 1, f"{name} waits on parity {phase} two phases behind"
        return done > phase

    waits = 0
    for step in itertools.count():
        movable = [name for name, op in pending.items() if op is not None and ready(name, op)]
        if not movable:
            break
        name = movable[order[step % len(order)] % len(movable)]
        (blk, wg), (kind, x) = name, pending[name]
        if kind == "load":
            full[blk][(x - kt_begin) % stages] += 1
        elif kind == "empty":
            st = (x - kt_begin) % stages
            assert wg not in empty_in[blk][st], f"{name} releases stage {st} twice in one phase"
            empty_in[blk][st].add(wg)
            if len(empty_in[blk][st]) == 2:
                empty[blk][st] += 1
                empty_in[blk][st].clear()
        elif kind == "send":
            peer = (1 - blk, wg)
            held = slot[peer][x % slots]
            assert held is None or held[1], f"{name} overwrites the peer's slot {x % slots} before it was read"
            slot[peer][x % slots] = (x, False)
            landed[peer][x % slots] += 1
        elif kind == "read":
            held = slot[name][x % slots]
            assert held == (x, False), f"{name} reads {held} for its live tile {x}"
            slot[name][x % slots] = (x, True)
        elif kind == "landed":
            waits += 1
        pending[name] = next(agents[name], None)
    stuck = {name: op for name, op in pending.items() if op is not None}
    assert not stuck, f"deadlock: {stuck}"
    for blk in (0, 1):
        assert not any(empty_in[blk]), "an empty barrier is left part-way"
        assert sum(full[blk]) == sum(empty[blk]) == kt_end - kt_begin
    assert sum(sum(n) for n in landed.values()) == waits == 2 * sum(len(live) for _, live in groups)


# (Sq, Skv, causal, window): the (256, 256) cases above, chip_smoke.py's
# d256_f32 (1024, window 512) and an insert of 1000 tokens
CLUSTER_SCHEDULE_CASES = sorted({(c[3], c[4], c[5], c[6]) for c in F32_SPLIT_CASES.values()}
                                | {(1024, 1024, True, 512), (1000, 1000, True, 0)})


@pytest.mark.parametrize("Sq,Skv,causal,window", CLUSTER_SCHEDULE_CASES)
def test_cluster_exchange_never_overwrites_a_slot(Sq, Skv, causal, window):
    """Every cluster of the (256, 256) kernel at these shapes runs its stage
    rings and its exchange of partial S to the end, under in-order and
    shuffled interleavings of its six agents: no slot is written again before
    it is read, every read finds its own tile's partial, every wait meets its
    arrival and no barrier is left part-way. Two slots a warpgroup, no
    barrier that frees them."""
    bq, bk = tfa.tiles(torch.float32, 256, 256)
    rng = np.random.default_rng(Sq * 7919 + Skv + window)
    orders = [[0], [1], [5], *(rng.integers(0, 6, 64).tolist() for _ in range(3))]
    for kt_begin, kt_end, groups in kernel_blocks(Sq, Skv, causal, window, bq, bk):
        for order in orders:
            run_cluster(kt_begin, kt_end, groups, tfa.tf32_stages(256, 256), order)


def test_cluster_exchange_needs_two_slots():
    """With one exchange slot a warpgroup and no barrier to free it, a block
    can overwrite its peer's slot before the peer read it: the model catches
    what two slots by the tile's parity rule out."""
    bq, bk = tfa.tiles(torch.float32, 256, 256)
    (kt_begin, kt_end, groups), = kernel_blocks(64, 64, True, 0, bq, bk)
    with pytest.raises(AssertionError, match="overwrites"):
        for order in itertools.product(range(6), repeat=3):
            run_cluster(kt_begin, kt_end, groups, tfa.tf32_stages(256, 256), list(order), slots=1)


def test_tf32_rounds_to_nearest_away():
    """tf32 keeps 10 explicit mantissa bits and rounds a tie away from zero;
    hi + lo carries about 22 bits."""
    ulp = 2.0**-10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2**-23, 1 + 3 * ulp / 2, 3.0])
    torch.testing.assert_close(tf32(x), torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0]), rtol=0, atol=0)
    y = torch.from_numpy(draw(20, (1000,))[0])
    hi, lo = split_tf32(y)
    assert bool(((tf32(hi) == hi) & (tf32(lo) == lo)).all())
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2.0**-21


@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 100), (1, 768)])
def test_plain_rmsnorm_matches_jax(jx, shape):
    xn, wn = draw(2, shape, shape[-1:])
    got = ref.rmsnorm_ref(torch.from_numpy(xn), torch.from_numpy(wn))
    for fn in (jx.rmsnorm_pallas, jx.rmsnorm_ref):
        kw = {"interpret": True} if fn is jx.rmsnorm_pallas else {}
        want = fn(jx.jnp.asarray(xn), jx.jnp.asarray(wn), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_plain_rmsnorm_bf16_matches_jax(jx):
    xn, wn = draw(3, (8, 128), (128,))
    want = jx.rmsnorm_pallas(jx.jnp.asarray(xn, jx.jnp.bfloat16), jx.jnp.asarray(wn), interpret=True)
    got = ref.rmsnorm_ref(torch.from_numpy(xn).to(torch.bfloat16), torch.from_numpy(wn))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=0.05)


# The RMSNorm kernel's vector path (csrc/rmsnorm.cu, MAX_VPT and
# MAX_TEAM_WARPS); test_rmsnorm_launch_config holds rmsnorm_plan to the
# library's launch_config on the card.
NORM_MAX_VPT = 8
NORM_MAX_TEAM_WARPS = 16
NORM_FEW_ROWS_WARPS = 8
# every norm width of the port's configs, and the smoke configs' widths
NORM_WIDTHS = (16, 24, 64, 256, 768, 2048, 2560, 4096, 4608, 7168, 12288)
NORM_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5), torch.bfloat16: dict(atol=0.05, rtol=2**-7)}


def rmsnorm_plan(D, elt, rows=1 << 20, sms=H100_SMS):
    """(warps a row, 16-byte vectors a thread) of the vector path for ``rows``
    rows of D ``elt``-byte values: one warp up to 256 vectors a row, else the
    fewest of 2, 4, 8, 16 warps that leave a thread at most 8 vectors; then,
    while the rows give the SMs fewer than 8 warps each, twice the warps,
    down to one vector a thread."""
    nvec = D * elt // 16
    team = 1
    while team < NORM_MAX_TEAM_WARPS and nvec > 32 * team * NORM_MAX_VPT:
        team *= 2
    while team < NORM_MAX_TEAM_WARPS and -(-nvec // (32 * team)) > 1 and rows * team < NORM_FEW_ROWS_WARPS * sms:
        team *= 2
    return team, -(-nvec // (32 * team))


def emulate_rmsnorm_kernel(x, w, plan, eps=1e-6):
    """The vector path's arithmetic on the CPU at ``plan`` (warps a row,
    vectors a thread), in its f32 order: the squares of each 16-byte vector
    by an FMA chain from 0; a thread's vectors (vector c of a row to thread
    c mod 32T, T the team's warps) added in order; the lane tree of each
    warp; the team's warps added in order; then x * rsqrt(sum / D + eps) *
    w, rounded once to x's dtype."""
    rows, D = x.shape
    V = 16 // x.element_size()
    team, vpt = plan
    a = x.float().reshape(rows, D // V, V)
    s = torch.zeros(rows, D // V)
    for j in range(V):
        s = fma(a[..., j], a[..., j], s)
    threads = 32 * team
    s = torch.nn.functional.pad(s, (0, vpt * threads - D // V)).reshape(rows, vpt, threads)
    ss = torch.zeros(rows, threads)
    for k in range(vpt):
        ss = ss + s[:, k]
    warps = halve(ss.reshape(rows, team, 32), 2)
    total = warps[:, 0]
    for i in range(1, team):
        total = total + warps[:, i]
    r = torch.rsqrt(total / D + eps)
    return (x.float() * r[:, None] * w.float()).to(x.dtype)


def test_rmsnorm_plan_covers_every_width():
    """Every D up to MAX_D that the vector path takes fits a team of at most
    16 warps of at most 8 vectors, with no warp of the team idle; the
    widths of the design (D 12288 bf16: 8 warps of 6 vectors)."""
    for elt in (2, 4):
        for D in range(16 // elt, trn.MAX_D + 1, 16 // elt):
            team, vpt = rmsnorm_plan(D, elt)
            nvec = D * elt // 16
            assert 1 <= vpt <= NORM_MAX_VPT and team <= NORM_MAX_TEAM_WARPS, (D, elt)
            assert 32 * team * (vpt - 1) < nvec <= 32 * team * vpt, (D, elt)
            assert team == 1 or nvec > 32 * (team // 2) * NORM_MAX_VPT, (D, elt)
    assert [rmsnorm_plan(D, 2) for D in (256, 768, 2048, 2560, 4608, 7168, 12288)] == [
        (1, 1), (1, 3), (1, 8), (2, 5), (4, 5), (4, 7), (8, 6)]
    assert rmsnorm_plan(12288, 4) == (16, 6) and rmsnorm_plan(768, 4) == (1, 6)
    # a decode batch of 8 rows: one vector a thread, or 16 warps a row
    assert [rmsnorm_plan(D, 2, rows=8) for D in (256, 768, 2048, 7168, 12288)] == [
        (1, 1), (4, 1), (8, 1), (16, 2), (16, 3)]
    assert rmsnorm_plan(2048, 2, rows=132 * 8) == (1, 8) and rmsnorm_plan(2048, 2, rows=132 * 8 - 1) == (2, 4)


def test_rmsnorm_vector_path_rule():
    """The wrapper counts a generic launch where the library takes its generic
    path: D off the vector width (8 bf16, 4 f32 values), or x or y off a
    16-byte boundary."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert trn.takes_vector_path(16, bf16) and trn.takes_vector_path(1004, f32)
    assert not trn.takes_vector_path(1004, bf16) and not trn.takes_vector_path(1002, f32)
    assert not trn.takes_vector_path(2560, bf16, misalign=2) and not trn.takes_vector_path(768, f32, misalign=4)
    assert trn.takes_vector_path(768, f32, misalign=16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", NORM_WIDTHS)
def test_rmsnorm_kernel_arithmetic_matches_jax(jx, D, dtype):
    """The vector path's summation order, at the plan of a prefill and of a
    decode batch, against the Pallas kernel in interpret mode, at every norm
    width, on rows whose scales span 1e-3 to 1e2 (f32 1e-5; bf16 atol 0.05
    plus one rounding step relative)."""
    xn, wn = draw(40 + D, (5, D), (D,))
    xn *= np.array([1e-3, 0.1, 1.0, 10.0, 100.0], np.float32)[:, None]
    x, w = torch.from_numpy(xn).to(dtype), torch.from_numpy(wn)
    jdtype = jx.jnp.bfloat16 if dtype == torch.bfloat16 else jx.jnp.float32
    want = jx.rmsnorm_pallas(jx.jnp.asarray(xn, jdtype), jx.jnp.asarray(wn), interpret=True)
    for rows in (16384, 8):
        got = emulate_rmsnorm_kernel(x, w, rmsnorm_plan(D, x.element_size(), rows=rows))
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **NORM_TOL[dtype])
        torch.testing.assert_close(got.float(), ref.rmsnorm_ref(x, w).float(), **NORM_TOL[dtype])


def lru_inputs(seed, B, T, W):
    """a in (0, 1) like RG-LRU decays, b and h0 normal."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (B, T, W)).astype(np.float32)
    b = rng.standard_normal((B, T, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    return a, b, h0


def wkv_inputs(seed, B, H, T, d):
    """r, k, v normal; w in (0, 1) like RWKV-6 decays; u normal; s0 nonzero."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, T, d)).astype(np.float32) * 0.5 for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, H, T, d)) * 0.5 - 1.0)).astype(np.float32)
    u = rng.standard_normal((H, d)).astype(np.float32) * 0.5
    s0 = rng.standard_normal((B, H, d, d)).astype(np.float32) * 0.5
    return r, k, v, w, u, s0


# name: (B, T, W); T % 128 == 0 where the Pallas kernel runs
LRU_CASES = {"smoke": (2, 128, 64), "wide": (1, 256, 512), "two_width_tiles": (2, 128, 1024)}


@pytest.mark.parametrize("case", sorted(LRU_CASES))
def test_plain_lru_matches_jax(jx, case):
    """ops.lru_scan on the CPU against the reference's ops.lru_scan through
    its Pallas kernel in interpret mode, and against its oracle."""
    a, b, h0 = lru_inputs(8, *LRU_CASES[case])
    got_h, got_last = ops.lru_scan(*map(torch.from_numpy, (a, b, h0)))
    ja, jb, jh = map(jx.jnp.asarray, (a, b, h0))
    for want_h, want_last in (jx.ops.lru_scan(ja, jb, jh, use_pallas=True), jx.lru_ref(ja, jb, jh)):
        np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last), atol=1e-5, rtol=1e-5)


def test_plain_lru_any_length_and_bf16_match_jax_oracle(jx):
    a, b, h0 = lru_inputs(9, 2, 37, 48)
    got_h, got_last = ref.lru_ref(*map(torch.from_numpy, (a, b, h0)))
    want_h, want_last = jx.lru_ref(*map(jx.jnp.asarray, (a, b, h0)))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last), atol=1e-5, rtol=1e-5)
    bf = jx.jnp.bfloat16
    got_h, _ = ref.lru_ref(torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16(), torch.from_numpy(h0))
    want_h, _ = jx.lru_ref(jx.jnp.asarray(a, bf), jx.jnp.asarray(b, bf), jx.jnp.asarray(h0))
    assert got_h.dtype == torch.bfloat16
    np.testing.assert_allclose(got_h.float().numpy(), np.asarray(want_h, np.float32), atol=0.05)


# The LRU kernel's launch rule (csrc/rglru_scan.cu: TILES, STAGES, IN_FLIGHT,
# STEP_ALIGN) on an H100's 132 SMs, without the shared-memory cap that no
# shape here reaches; test_lru_scan_launch_config holds it to the library's
# report on the card.
LRU_STAGES = 3
LRU_IN_FLIGHT = 4 << 20
LRU_STEP_ALIGN = 16


def lru_plan(B, T, W, elt, sms=H100_SMS):
    """(WT, D) of a (B, T, W) call with elt-byte inputs: the widest tile of
    128, 64, 32, 16 channels that gives every SM a block, and the steps a ring
    stage such that LRU_STAGES - 1 stages of the whole grid hold
    LRU_IN_FLIGHT bytes of a and b, no more than T needs."""
    tile = next((wt for wt in (128, 64, 32, 16) if B * -(-W // wt) >= sms), 16)

    def up(x):
        return -(-x // LRU_STEP_ALIGN) * LRU_STEP_ALIGN

    steps = up(-(-LRU_IN_FLIGHT // (2 * B * W * elt * (LRU_STAGES - 1))))
    return tile, max(LRU_STEP_ALIGN, min(steps, up(max(T, 1))))


def emulate_lru_kernel(a, b, h0, WT, D, stages=LRU_STAGES):
    """The LRU kernel's data movement on the CPU. Per batch row and tile of
    WT channels, a ring of ``stages`` slots of D steps; stage c is copied
    into slot c % stages ``stages - 1`` stages before the chain reads it, with
    zeros past W and past T; every channel's chain runs h = a h + b (f32
    product, then f32 sum) from its slot and stops at T. A chain that read a
    step past T or a copy that missed a row would show in y or h_final.
    Returns (h_seq in a's dtype, h_final f32)."""
    B, T, W = a.shape
    tiles, n_stages = -(-W // WT), -(-T // D)
    rings = [torch.zeros((stages, B, tiles, D, WT), dtype=a.dtype) for _ in range(2)]

    def issue(c):
        if c >= n_stages:
            return
        rows = min(D, T - c * D)
        for ring, x in zip(rings, (a, b)):
            padded = torch.zeros((B, rows, tiles * WT), dtype=x.dtype)
            padded[..., :W] = x[:, c * D : c * D + rows]
            ring[c % stages].zero_()
            ring[c % stages][:, :, :rows] = padded.unflatten(-1, (tiles, WT)).transpose(1, 2)

    h = torch.zeros((B, tiles * WT))
    h[:, :W] = h0.float()
    h = h.unflatten(-1, (tiles, WT))
    ys = torch.zeros((B, T, tiles, WT))
    for c in range(stages - 1):
        issue(c)
    for c in range(n_stages):
        issue(c + stages - 1)  # into slot (c - 1) % stages, which the chain has left
        ring_a, ring_b = (ring[c % stages] for ring in rings)
        for t in range(min(D, T - c * D)):
            h = ring_a[:, :, t].float() * h + ring_b[:, :, t].float()
            ys[:, c * D + t] = h
    return ys.flatten(2)[..., :W].to(a.dtype), h.flatten(1)[:, :W]


# the shapes chip_smoke.py times K3 at: (B, T, W, bytes an element)
LRU_SERVED = {"griffin_prefill": (8, 2304, 2560, 4), "griffin_prefill_b1": (1, 2304, 2560, 4),
              "griffin_prefill_s256": (8, 256, 2560, 4), "bf16_ragged": (4, 1001, 2500, 2)}


def test_lru_plan_fills_the_card_in_one_wave():
    """At each served shape the rule gives at least one block per SM and at
    least 4 MB of a and b in flight; the tiles and depths the emulation
    tests below use."""
    plans = {name: lru_plan(*shape) for name, shape in LRU_SERVED.items()}
    assert plans == {"griffin_prefill": (128, 16), "griffin_prefill_b1": (16, 112),
                     "griffin_prefill_s256": (128, 16), "bf16_ragged": (64, 64)}
    for name, (B, T, W, elt) in LRU_SERVED.items():
        WT, D = plans[name]
        assert B * -(-W // WT) >= H100_SMS, name
        assert 2 * B * W * elt * (LRU_STAGES - 1) * D >= LRU_IN_FLIGHT, name


def lru_emulation_cases():
    """(B, T, W, dtype, WT, D): each served shape's (WT, D) at a small B, with
    W two tiles and 3 channels (a ragged last tile) and T three stages and 5
    steps (a ragged last stage); T of 0, 1, D - 1, D and D + 1; bf16 at odd W."""
    cases = {}
    for name, (B, T, W, elt) in LRU_SERVED.items():
        WT, D = lru_plan(B, T, W, elt)
        cases[name] = (2, 3 * D + 5, 2 * WT + 3, torch.bfloat16 if elt == 2 else torch.float32, WT, D)
    for T in (0, 1, 7, 8, 9):
        cases[f"T{T}"] = (2, T, 37, torch.float32, 16, 8)
    cases["bf16_odd_w"] = (2, 37, 99, torch.bfloat16, 32, 8)
    return cases


LRU_EMULATION_CASES = lru_emulation_cases()


@pytest.mark.parametrize("case", sorted(LRU_EMULATION_CASES))
def test_lru_kernel_emulation_equals_plain_to_the_bit(case):
    B, T, W, dtype, WT, D = LRU_EMULATION_CASES[case]
    a, b, h0 = map(torch.from_numpy, lru_inputs(30, B, T, W))
    a, b = a.to(dtype), b.to(dtype)
    got_h, got_last = emulate_lru_kernel(a, b, h0, WT, D)
    want_h, want_last = ref.lru_ref(a, b, h0)
    assert got_h.dtype == dtype and got_h.shape == (B, T, W)
    assert torch.equal(got_h, want_h) and torch.equal(got_last, want_last)


@pytest.mark.parametrize("served", sorted(LRU_SERVED))
@pytest.mark.parametrize("case", sorted(LRU_CASES))
def test_lru_kernel_emulation_matches_jax(jx, case, served):
    """At each served shape's (WT, D): within the LRU limit of lru_pallas in
    interpret mode (through the reference's ops.lru_scan) and of its oracle."""
    a, b, h0 = lru_inputs(31, *LRU_CASES[case])
    got_h, got_last = emulate_lru_kernel(*map(torch.from_numpy, (a, b, h0)), *lru_plan(*LRU_SERVED[served]))
    ja, jb, jh = map(jx.jnp.asarray, (a, b, h0))
    for want_h, want_last in (jx.ops.lru_scan(ja, jb, jh, use_pallas=True), jx.lru_ref(ja, jb, jh)):
        np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last), atol=1e-5, rtol=1e-5)


def test_lru_kernel_emulation_bf16_odd_width_matches_jax(jx):
    """bf16 at odd W (the plain-load path): y within one bf16 rounding step of
    the JAX oracle's, h_final within the LRU limit."""
    a, b, h0 = lru_inputs(32, 2, 37, 99)
    bf = jx.jnp.bfloat16
    got_h, got_last = emulate_lru_kernel(torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16(),
                                         torch.from_numpy(h0), 32, 8)
    want_h, want_last = jx.lru_ref(jx.jnp.asarray(a, bf), jx.jnp.asarray(b, bf), jx.jnp.asarray(h0))
    np.testing.assert_allclose(got_h.float().numpy(), np.asarray(want_h, np.float32), atol=0.05, rtol=2**-7)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last), atol=1e-5, rtol=1e-5)


# name: (B, H, T, d); T % 64 == 0 where the Pallas kernel runs
WKV_CASES = {"smoke": (2, 4, 64, 16), "two_chunks": (1, 2, 128, 32), "head64": (1, 2, 64, 64)}


@pytest.mark.parametrize("case", sorted(WKV_CASES))
def test_plain_wkv6_matches_jax(jx, case):
    """ops.wkv6 on the CPU against wkv6_pallas in interpret mode and against
    the reference's oracle."""
    arrays = wkv_inputs(10, *WKV_CASES[case])
    got_y, got_s = ops.wkv6(*map(torch.from_numpy, arrays))
    jarrays = list(map(jx.jnp.asarray, arrays))
    for want_y, want_s in (jx.wkv6_pallas(*jarrays, interpret=True), jx.wkv6_ref(*jarrays)):
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=5e-4, rtol=1e-3)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=5e-4, rtol=1e-3)


def test_plain_wkv6_any_length_and_bf16_match_jax_oracle(jx):
    arrays = wkv_inputs(11, 1, 2, 37, 16)
    got_y, got_s = ref.wkv6_ref(*map(torch.from_numpy, arrays))
    want_y, want_s = jx.wkv6_ref(*map(jx.jnp.asarray, arrays))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=5e-4, rtol=1e-3)
    bf = jx.jnp.bfloat16
    t_in = [torch.from_numpy(a).bfloat16() for a in arrays[:4]] + [torch.from_numpy(a) for a in arrays[4:]]
    j_in = [jx.jnp.asarray(a, bf) for a in arrays[:4]] + [jx.jnp.asarray(a) for a in arrays[4:]]
    got_y, got_s = ref.wkv6_ref(*t_in)
    want_y, want_s = jx.wkv6_ref(*j_in)
    assert got_y.dtype == torch.bfloat16 and got_s.dtype == torch.float32
    np.testing.assert_allclose(got_y.float().numpy(), np.asarray(want_y, np.float32), atol=0.05, rtol=2**-7)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=5e-4, rtol=1e-3)


def fma(a, b, c):
    """a * b + c rounded once to f32, as ``fmaf`` does: the product is exact
    in f64, so only the f64 sum's rounding (rarely) adds to the one of f32."""
    return (a.double() * b.double() + c.double()).float()


def halve(x, dim):
    """The sum of ``repro::segment_sum`` over a warp segment of lanes along
    ``dim`` (a power of two): each step adds the upper half to the lower."""
    while x.shape[dim] > 1:
        lo, hi = x.chunk(2, dim)
        x = lo + hi
    return x.squeeze(dim)


# The WKV-6 kernel's split (csrc/rwkv6_scan.cu, CH and P):
# test_wkv6_smem_lets_four_blocks_share_an_sm holds them to the library's
# report on the card.
WKV_CHUNK = 16
WKV_PARTS = 4


def emulate_wkv6_kernel(r, k, v, w, u, s0):
    """The arithmetic of the WKV-6 kernel (csrc/rwkv6_scan.cu) on the CPU, in
    its f32 order. Row group g of WKV_PARTS holds rows g R .. g R + R - 1 (R =
    d / WKV_PARTS) of every column; per token and column it sums r_i S_ij
    over its float4 groups of rows m into accumulator m % chains (four fmas
    each; two chains where a thread has two or more float4 groups, else one)
    and adds the accumulators in order; the partial sums of the row groups
    are added by halves. The bonus r.(u*k) is summed four elements to a lane
    (fma of r*u and k), then by halves over d/4 lanes; y = fma(bonus, v,
    sum). S_ij = fma(w_i, S_ij, k_i v_j). Returns (y in r's dtype, S_final
    f32)."""
    B, H, T, d = r.shape
    parts = WKV_PARTS
    groups = d // 4 // parts
    chains = 2 if groups >= 2 else 1
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :]
    rows = torch.arange(d).view(parts, 4 * groups)  # rows[g, 4m + e]
    s = s0.float()[:, :, rows, :]  # (B, H, parts, 4 groups, d)
    ys = torch.empty((B, H, T, d))
    for t in range(T):
        rt, kt, vt, wt = rf[:, :, t], kf[:, :, t], vf[:, :, t], wf[:, :, t]
        ru, kk = (rt * uf).unflatten(-1, (d // 4, 4)), kt.unflatten(-1, (d // 4, 4))
        bonus = torch.zeros((B, H, d // 4))
        for e in range(4):
            bonus = fma(ru[..., e], kk[..., e], bonus)
        bonus = halve(bonus, -1)
        rg, kg, wg = (x[:, :, rows, None] for x in (rt, kt, wt))  # (B, H, parts, 4 groups, 1)
        vj = vt[:, :, None, :]
        acc = [torch.zeros((B, H, parts, d)) for _ in range(chains)]
        for m in range(groups):
            for e in range(4 * m, 4 * m + 4):
                acc[m % chains] = fma(rg[:, :, :, e], s[:, :, :, e], acc[m % chains])
        part = acc[0]
        for a in acc[1:]:
            part = part + a
        ys[:, :, t] = fma(bonus[..., None], vt, halve(part, 2))
        s = fma(wg, s, kg * vj[:, :, :, None])
    s_final = torch.empty((B, H, d, d))
    s_final[:, :, rows.flatten()] = s.flatten(2, 3)
    return ys.to(r.dtype), s_final


@pytest.mark.parametrize("case", sorted(WKV_CASES))
def test_wkv6_kernel_arithmetic_matches_jax(jx, case):
    """The WKV-6 kernel's arithmetic meets the f32 limit against wkv6_pallas
    in interpret mode, the JAX oracle and the plain version."""
    arrays = wkv_inputs(21, *WKV_CASES[case])
    got_y, got_s = emulate_wkv6_kernel(*map(torch.from_numpy, arrays))
    jarrays = list(map(jx.jnp.asarray, arrays))
    wants = [jx.wkv6_pallas(*jarrays, interpret=True), jx.wkv6_ref(*jarrays),
             ref.wkv6_ref(*map(torch.from_numpy, arrays))]
    for want_y, want_s in wants:
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=5e-4, rtol=1e-3)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("T", [37, 70])
def test_wkv6_kernel_arithmetic_any_length(jx, T, d):
    """At T off the kernel's chunk and the Pallas kernel's 64 (ROADMAP H4),
    against the JAX oracle and the plain version, at each head size the
    kernel has an instance for."""
    arrays = wkv_inputs(22, 1, 2, T, d)
    got_y, got_s = emulate_wkv6_kernel(*map(torch.from_numpy, arrays))
    for want_y, want_s in (jx.wkv6_ref(*map(jx.jnp.asarray, arrays)), ref.wkv6_ref(*map(torch.from_numpy, arrays))):
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=5e-4, rtol=1e-3)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=5e-4, rtol=1e-3)


def test_wkv6_kernel_arithmetic_bf16_matches_jax(jx):
    """bf16 inputs: y in bf16 within one rounding step of the JAX oracle's,
    the f32 state within the f32 limit."""
    arrays = wkv_inputs(23, 2, 2, 100, 64)
    t_in = [torch.from_numpy(a).bfloat16() for a in arrays[:4]] + [torch.from_numpy(a) for a in arrays[4:]]
    j_in = [jx.jnp.asarray(a, jx.jnp.bfloat16) for a in arrays[:4]] + [jx.jnp.asarray(a) for a in arrays[4:]]
    got_y, got_s = emulate_wkv6_kernel(*t_in)
    want_y, want_s = jx.wkv6_ref(*j_in)
    assert got_y.dtype == torch.bfloat16 and got_s.dtype == torch.float32
    np.testing.assert_allclose(got_y.float().numpy(), np.asarray(want_y, np.float32), atol=0.05, rtol=2**-7)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("d", [16, 32, 64])
def test_wkv6_emulation_keeps_every_row_and_column(d):
    """With no decay and no bonus, S_final = s0 + sum_t k_t v_t^T and y_t =
    r_t . S_{t-1}: the emulation's row layout loses and repeats nothing."""
    r, k, v, w, u, s0 = map(torch.from_numpy, wkv_inputs(24, 1, 1, 5, d))
    y, s = emulate_wkv6_kernel(r, k, v, torch.ones_like(w), torch.zeros_like(u), s0)
    want_s = s0 + torch.einsum("bhti,bhtj->bhij", k, v)
    torch.testing.assert_close(s, want_s, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(y[:, :, 0], torch.einsum("bhi,bhij->bhj", r[:, :, 0], s0), atol=1e-5, rtol=1e-5)


def test_ops_send_cpu_recurrences_to_plain_versions():
    a, b, h0 = map(torch.from_numpy, lru_inputs(12, 2, 20, 32))
    wkv = list(map(torch.from_numpy, wkv_inputs(13, 1, 2, 20, 16)))
    before = (tlru.launches, twkv.launches)
    for got, want in zip(ops.lru_scan(a, b, h0), ref.lru_ref(a, b, h0)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for got, want in zip(ops.wkv6(*wkv), ref.wkv6_ref(*wkv)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (tlru.launches, twkv.launches) == before


def test_recurrence_wrappers_reject_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tlru.lru_scan(torch.zeros(1, 4, 8), torch.zeros(1, 4, 8), torch.zeros(1, 8))
    z = torch.zeros(1, 2, 4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        twkv.wkv6(z, z, z, z, torch.zeros(2, 64), torch.zeros(1, 2, 64, 64))


def router_logits(seed, G, N, E, scale=1.0, skew=0.0):
    """Router logits, normal with the given scale, plus a per-expert bias of
    standard deviation ``skew`` that makes some experts popular (and so drops
    picks at a tight capacity)."""
    rng = np.random.default_rng(seed)
    bias = rng.standard_normal(E) * skew
    return (rng.standard_normal((G, N, E)) * scale + bias).astype(np.float32)


# name: (G, N, E, k, capacity, skew): tests/test_kernels.py's shapes, then
# deepseek-moe-16b's routing widths (E 64, k 6) with drops
GATING_CASES = {
    "g2_e16_k2": (2, 64, 16, 2, 12, 0.0),
    "g1_e32_k4": (1, 128, 32, 4, 20, 0.0),
    "g3_e8_k1": (3, 32, 8, 1, 5, 0.0),
    "deepseek_e64_k6": (2, 128, 64, 6, 15, 1.0),
}


@pytest.mark.parametrize("case", sorted(GATING_CASES))
def test_plain_moe_gating_matches_jax(jx, case):
    """The plain gating against the reference's token-by-token oracle and
    moe_gating_pallas in interpret mode: idx and pos exact, gate 1e-6."""
    G, N, E, k, cap, skew = GATING_CASES[case]
    x = router_logits(20, G, N, E, skew=skew)
    idx, gate, pos = ops.moe_gating(torch.from_numpy(x), top_k=k, capacity=cap)
    assert (idx.dtype, gate.dtype, pos.dtype) == (torch.int32, torch.float32, torch.int32)
    for fn in (jx.moe_gating_ref, jx.moe_gating_pallas):
        want_idx, want_gate, want_pos = fn(jx.jnp.asarray(x), top_k=k, capacity=cap)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
        np.testing.assert_allclose(gate.numpy(), np.asarray(want_gate), atol=1e-6)
    if skew:
        assert (pos < 0).any()  # the case exercises drops


def test_plain_moe_gating_without_renormalising_matches_jax(jx):
    x = router_logits(21, 2, 40, 16)
    _, gate, _ = ref.moe_gating_ref(torch.from_numpy(x), top_k=3, capacity=8, renormalise=False)
    _, want, _ = jx.moe_gating_pallas(jx.jnp.asarray(x), top_k=3, capacity=8, renormalise=False)
    np.testing.assert_allclose(gate.numpy(), np.asarray(want), atol=1e-6)


def test_plain_moe_gating_ties_and_capacity():
    """Everyone wants expert 0: exactly ``cap`` picks survive, in slots
    0 .. cap-1 in token order (tests/test_kernels.py's drop case); equal
    logits go to the lower expert, as the first maximum wins."""
    x = torch.zeros(1, 32, 4)
    x[:, :, 0] = 10.0
    idx, _, pos = ref.moe_gating_ref(x, top_k=1, capacity=5)
    assert (idx == 0).all()
    np.testing.assert_array_equal(pos[0, :, 0].numpy(), [0, 1, 2, 3, 4] + [-1] * 27)
    idx, gate, _ = ref.moe_gating_ref(torch.zeros(2, 3, 6), top_k=6, capacity=4)
    np.testing.assert_array_equal(idx.numpy(), np.broadcast_to(np.arange(6), (2, 3, 6)))
    torch.testing.assert_close(gate, torch.full((2, 3, 6), 1 / 6), rtol=0, atol=1e-7)


def test_lane_sum_is_a_sum():
    x = torch.from_numpy(router_logits(22, 3, 5, 100)).exp()
    torch.testing.assert_close(ref.lane_sum(x), x.sum(-1, keepdim=True), rtol=1e-6, atol=0)


def test_ops_send_cpu_gating_to_plain_version():
    x = torch.from_numpy(router_logits(23, 2, 16, 8))
    before = tgate.launches
    for got, want in zip(ops.moe_gating(x, top_k=2, capacity=5), ref.moe_gating_ref(x, top_k=2, capacity=5)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tgate.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tgate.moe_gating(x, top_k=2, capacity=5)


def emulate_moe_gating_kernel(logits, top_k, capacity, tile):
    """The gating kernels' split (csrc/moe_gating.cu) on the CPU. idx and
    gate come from the route kernel's row arithmetic, which is the plain
    version's step for step. Each tile of ``tile`` tokens counts its picks
    per (rank j, expert e): hist (G, T, k, E). The slots kernel's base is
    sum_{j' < j} sum_{all t'} hist[t'][j'][e] + sum_{t' < t} hist[t'][j][e];
    its walk cuts the tile into 32-token segments, and a pick's slot is base
    plus its rank among the earlier lanes of its segment that picked the same
    expert (``__match_any_sync``) plus that expert's picks of rank j in the
    tile's earlier segments. A group of one tile has the same base with T = 1.
    Returns (idx, gate, pos) as the kernels do, and hist."""
    idx, gate, _ = ref.moe_gating_ref(logits, top_k=top_k, capacity=capacity)
    G, N, k = idx.shape
    E = logits.shape[-1]
    T = -(-N // tile)
    segments = -(-tile // 32)
    # tokens past N and lanes past a tile pick expert E, which the one-hot drops
    picks = torch.nn.functional.pad(idx.long(), (0, 0, 0, T * tile - N), value=E).view(G, T, tile, k)
    picks = torch.nn.functional.pad(picks, (0, 0, 0, segments * 32 - tile), value=E)
    onehot = torch.nn.functional.one_hot(picks.view(G, T, segments, 32, k), E + 1)[..., :E]
    hist = onehot.sum((2, 3))  # (G, T, k, E)
    total = hist.sum(1, keepdim=True)
    base = (total.cumsum(2) - total) + (hist.cumsum(1) - hist)
    in_segment = onehot.cumsum(3) - onehot  # lanes before this one, same expert
    seg_counts = onehot.sum(3, keepdim=True)
    earlier = seg_counts.cumsum(2) - seg_counts  # the tile's earlier segments
    slot = (base[:, :, None, None] + in_segment + earlier) * onehot
    slot = slot.sum(-1).view(G, T, segments * 32, k)[:, :, :tile].reshape(G, T * tile, k)[:, :N]
    pos = torch.where(slot < capacity, slot, -1).int()
    return idx, gate, pos, hist


# name: (G, N, E, k, capacity, skew, everyone wants expert 0): N off every
# tile, drops, one expert taking every first pick, k 1, E below a warp, and
# kimi-k2's 384 experts at k 8
TILED_GATING_CASES = {
    "ragged_n": (2, 100, 16, 2, 20, 0.0, False),
    "skew_drops": (3, 70, 40, 3, 6, 1.0, False),
    "everyone_expert_0": (2, 50, 8, 2, 7, 0.0, True),
    "k1": (2, 45, 16, 1, 4, 0.5, False),
    "e20_below_a_warp": (1, 77, 20, 4, 18, 0.0, False),
    "e384_k8": (2, 40, 384, 8, 2, 1.0, False),
}


@pytest.mark.parametrize("tile", [8, 32, 64])
@pytest.mark.parametrize("case", sorted(TILED_GATING_CASES))
def test_tiled_gating_matches_jax(jx, case, tile):
    """The kernels' tiles, histograms, base counts and segment walk give the
    slots of the reference's token-by-token oracle, of moe_gating_pallas in
    interpret mode and of the plain version: idx and pos exact, gate 1e-6."""
    G, N, E, k, cap, skew, all_zero = TILED_GATING_CASES[case]
    x = router_logits(25, G, N, E, skew=skew)
    if all_zero:
        x[..., 0] += 10.0
    idx, gate, pos, hist = emulate_moe_gating_kernel(torch.from_numpy(x), k, cap, tile)
    assert hist.shape == (G, -(-N // tile), k, E) and int(hist.sum()) == G * N * k
    wants = [fn(jx.jnp.asarray(x), top_k=k, capacity=cap) for fn in (jx.moe_gating_ref, jx.moe_gating_pallas)]
    for want_idx, want_gate, want_pos in [*wants, ref.moe_gating_ref(torch.from_numpy(x), top_k=k, capacity=cap)]:
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
        np.testing.assert_allclose(gate.numpy(), np.asarray(want_gate), atol=1e-6)
    if skew:
        assert (pos < 0).any()  # the case exercises drops
    if all_zero:
        first_slots = np.where(np.arange(N) < cap, np.arange(N), -1)
        np.testing.assert_array_equal(pos[:, :, 0].numpy(), np.broadcast_to(first_slots, (G, N)))


def test_flash_attention_smem_fits_a_block():
    """The dynamic shared memory of every compiled instance (head-dim pair
    and dtype) fits the 232,448 bytes a Hopper block may opt into. The
    largest are bf16 at d 256 (Q 64 KB and two stages of K and V) and f32 at
    (64, 64) and (128, 128) on the tensor cores (230,456 bytes each: Q_hi and
    Q_lo and two stages of five 16 KB tiles; Q_hi and Q_lo of 64 KB and three
    16-key stages of K and V split beforehand); f32 at (96, 64) takes 32-key
    tiles (the d 64 layout at d 96 would take 295,992 bytes, three stages of
    32 keys 246,864) and f32 at (128, 128) 16-key tiles (32 keys would take
    295,992 bytes too; splitting K and V in the block, two stages of 16 keys
    214,072); f32 at (256, 256) fits only as a cluster of two (128, 128)
    blocks with two stages and the exchange slots (one block would need 262,144
    bytes for Q, Q_lo and two 16-key stages at 64 rows; three stages beside one
    slot a warpgroup 238,664); (128, 64) and (64, 128) are the (128, 128)
    block at their widths at 32-key tiles, (128, 64) in two stages (at 16
    keys and three stages they took 205,880 and 140,344 bytes)."""
    largest = {torch.bfloat16: (256, 256), torch.float32: (64, 64)}
    for dtype in tfa.DTYPES:
        sizes = {pair: tfa.dynamic_smem_bytes(*pair, dtype) for pair in tfa.HEAD_DIM_PAIRS}
        assert max(sizes.values()) == sizes[largest[dtype]] <= 232448
    # Q and Q_lo (128 rows x 128 columns), two stages of K_hi, K_lo (16 keys
    # x 128 columns), V^T_hi, V^T_lo (128 rows of 16 keys), two exchange
    # slots of 64 x 16 f32 for each of the two consumer warpgroups, a barrier
    # for Q, two a stage and one a slot, the slack
    assert tfa.dynamic_smem_bytes(256, 256, torch.float32) == 1024 + 2 * 65536 + 2 * 32768 + 4 * 4096 + 8 * 9
    assert tfa.dynamic_smem_bytes(256, 256, torch.float32) == 214088
    one_block_64_rows = 2 * 64 * 256 * 4 + 2 * 4 * 16 * 256 * 4
    three_stages_one_slot = 1024 + 2 * 65536 + 3 * 32768 + 2 * 4096 + 8 * 9
    assert one_block_64_rows == 262144 > 232448 and three_stages_one_slot == 238664 > 232448
    # (128, 64) at 32-key tiles: Q and Q_lo 64 KB each, two stages of K_hi,
    # K_lo (32 keys x 128 columns) and V^T_hi, V^T_lo (64 rows of 32 keys);
    # three stages would not fit
    assert tfa.dynamic_smem_bytes(128, 64, torch.float32) == 1024 + 2 * 65536 + 2 * (2 * 16384 + 2 * 8192) + 8 * 5
    assert tfa.dynamic_smem_bytes(128, 64, torch.float32) == 230440 and tfa.tf32_stages(128, 64) == 2
    three_32_key_stages = 1024 + 2 * 65536 + 3 * (2 * 16384 + 2 * 8192) + 8 * 7
    keys_16_at_d128_dv64 = 1024 + 2 * 65536 + 3 * (2 * 8192 + 2 * 4096) + 8 * 7
    assert three_32_key_stages == 279608 > 232448 and keys_16_at_d128_dv64 == 205880
    # (64, 128) at 32-key tiles: Q and Q_lo 32 KB each, three stages of K_hi,
    # K_lo (32 keys x 64 columns) and V^T_hi, V^T_lo (128 rows of 32 keys)
    assert tfa.dynamic_smem_bytes(64, 128, torch.float32) == 1024 + 2 * 32768 + 3 * (2 * 8192 + 2 * 16384) + 8 * 7
    assert tfa.dynamic_smem_bytes(64, 128, torch.float32) == 214072
    keys_16_at_d64_dv128 = 1024 + 2 * 32768 + 3 * (2 * 4096 + 2 * 8192) + 8 * 7
    assert keys_16_at_d64_dv128 == 140344
    assert tfa.dynamic_smem_bytes(256, 256, torch.bfloat16) == 1024 + 2 * (128 * 256 + 2 * 64 * 512) + 8 * 5
    assert tfa.dynamic_smem_bytes(64, 64, torch.float32) == 1024 + 2 * 32768 + 2 * 5 * 16384 + 8 * 7
    assert tfa.dynamic_smem_bytes(96, 64, torch.float32) == 197688
    d64_layout_at_d96 = 1024 + 2 * 49152 + 2 * (2 * 24576 + 3 * 16384) + 56
    three_stages = 1024 + 2 * 49152 + 3 * (2 * 12288 + 3 * 8192) + 8 * 10
    assert (d64_layout_at_d96, three_stages) == (295992, 246864) and min(d64_layout_at_d96, three_stages) > 232448
    assert tfa.dynamic_smem_bytes(128, 128, torch.float32) == 230456
    keys_32_at_d128 = 1024 + 2 * 65536 + 2 * (2 * 16384 + 3 * 16384) + 56
    split_in_the_block = 1024 + 2 * 65536 + 2 * (2 * 8192 + 3 * 8192) + 56
    assert keys_32_at_d128 == 295992 > 232448 and split_in_the_block == 214072


def test_ops_send_cpu_tensors_to_plain_versions():
    qn, kn, vn, xn, wn = draw(4, (1, 4, 20, 64), (1, 2, 20, 64), (1, 2, 20, 64), (5, 64), (64,))
    q, k, v, x, w = map(torch.from_numpy, (qn, kn, vn, xn, wn))
    def counts():
        return (*(getattr(tfa, name) for name in COUNTS), trn.launches)

    before = counts()
    for dtype in (torch.float32, torch.bfloat16):
        qt, kt, vt = (t.to(dtype) for t in (q, k, v))
        torch.testing.assert_close(
            ops.attention(qt, kt, vt, causal=True, window=8, logit_cap=5.0),
            ref.attention_ref(qt, kt, vt, causal=True, window=8, logit_cap=5.0), rtol=0, atol=0,
        )
    torch.testing.assert_close(ops.rmsnorm(x, w), ref.rmsnorm_ref(x, w), rtol=0, atol=0)
    assert counts() == before


def test_kernel_wrappers_reject_cpu_tensors():
    """A wrapper never falls back: given what its kernel cannot take, it raises."""
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="needs CUDA"):
        tfa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        trn.rmsnorm(torch.zeros(4, 64), torch.ones(64))


# ---------------------------------------------------------------------------
# On the card: the Hopper kernels against their plain versions
# ---------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


GPU_ATTN_CASES = {
    **ATTN_CASES,
    "griffin_mqa_d256_bf16": (2, 10, 1, 300, 300, 256, True, 128, 0.0, 1.0),
    "griffin_d256": (1, 4, 1, 200, 200, 256, True, 64, 0.0, 1.0),
    "d256_cap_bf16": (1, 2, 2, 130, 130, 256, True, 0, 30.0, 4.0),
    "nbi100m_prefill": (2, 12, 12, 512, 512, 64, True, 0, 0.0, 1.0),
    "gqa_d128_bf16": (1, 32, 8, 256, 256, 128, True, 0, 0.0, 1.0),
    "ragged_300": (1, 4, 4, 300, 300, 64, True, 0, 0.0, 1.0),
    "window_128": (1, 4, 2, 400, 400, 64, True, 128, 0.0, 1.0),
    "non_causal_d128": (2, 4, 4, 70, 200, 128, False, 0, 0.0, 1.0),
    # the edges of the bf16 kernel's TMA boxes and 64-key tiles
    "sq1_short_kv_bf16": (2, 4, 2, 1, 30, 128, False, 0, 0.0, 1.0),
    "sq1_causal_bf16": (1, 4, 4, 1, 1, 64, True, 0, 0.0, 1.0),
    "ragged_300_130_bf16": (2, 4, 2, 300, 130, 128, True, 0, 0.0, 1.0),
    "non_causal_d128_bf16": (2, 4, 4, 70, 200, 128, False, 0, 0.0, 1.0),
    "window_d128_bf16": (1, 4, 2, 400, 400, 128, True, 128, 0.0, 1.0),
    "logit_cap_d128_bf16": (1, 2, 2, 130, 130, 128, True, 0, 30.0, 4.0),
    "mqa_d256_ragged_bf16": (1, 10, 1, 150, 333, 256, False, 0, 0.0, 1.0),
    "deepseek_heads_bf16": (1, 16, 16, 1000, 1000, 128, True, 0, 0.0, 1.0),
    # the edges of the f32 tensor-core kernel (d 64): ragged Sq and Skv off
    # the 128-row block and the 64-key tile, GQA, window, cap, non-causal
    "tf32_ragged_non_causal": (2, 4, 4, 130, 197, 64, False, 0, 0.0, 1.0),
    "tf32_ragged_gqa": (1, 8, 2, 333, 333, 64, True, 0, 0.0, 1.0),
    "tf32_sq1": (2, 4, 2, 1, 70, 64, False, 0, 0.0, 1.0),
    "tf32_sq_past_skv": (1, 4, 4, 100, 30, 64, False, 0, 0.0, 1.0),
    "tf32_window_ragged": (1, 4, 1, 500, 500, 64, True, 100, 0.0, 1.0),
    "tf32_logit_cap": (1, 4, 4, 257, 257, 64, True, 0, 30.0, 4.0),
}


# the wrapper's launch counts, one a kernel
COUNTS = ("bf16_launches", "bf16_mla_launches", *tfa.TF32_COUNTS.values())


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_ATTN_CASES))
def test_flash_attention_kernel_matches_plain(case):
    _need_card()
    B, Hq, Hkv, Sq, Skv, d, causal, window, cap, scale = GPU_ATTN_CASES[case]
    if (d, d) not in tfa.HEAD_DIM_PAIRS:  # the CPU cases' narrow heads: widen to the kernel's
        d = 64
    dtype = torch.bfloat16 if case.endswith("bf16") else torch.float32
    arrays = draw(5, (B, Hq, Sq, d), (B, Hkv, Skv, d), (B, Hkv, Skv, d), scale=scale)
    q, k, v = (torch.from_numpy(a).to("cuda", dtype) for a in arrays)
    kw = dict(causal=causal, window=window, logit_cap=cap)
    count = tfa.launch_count(dtype, d, d)
    before = getattr(tfa, count)
    got = ops.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert getattr(tfa, count) == before + 1
    want = ref.attention_ref(q, k, v, **kw)
    # both accumulate in f32 and round once: a bf16 output is off by one rounding step at most
    tol = dict(atol=1e-3, rtol=2**-7) if dtype == torch.bfloat16 else dict(atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(got.float(), want.float(), **tol)


# the (96, 64) kernel on the card: name: (B, Hq, Hkv, Sq, Skv, causal, window)
GPU_MLA_CASES = {
    "minicpm3_heads": (2, 40, 40, 300, 300, True, 0),
    "causal_sq1": (1, 4, 4, 1, 1, True, 0),
    "non_causal": (2, 8, 8, 200, 200, False, 0),
    "ragged_non_causal": (1, 4, 4, 130, 333, False, 0),
    "ragged_sq_past_skv": (1, 4, 4, 150, 70, False, 0),
    "ragged_causal": (1, 4, 4, 77, 77, True, 0),
    "window": (1, 4, 4, 500, 500, True, 128),
    "gqa_window": (1, 8, 2, 257, 257, True, 100),
    # the edges of its 128-row blocks, 128-key tiles and turns (MLA_CASES)
    "sq_129": (1, 8, 8, 129, 129, True, 0),
    "sq_191": (1, 8, 8, 191, 191, True, 0),
    "sq_192": (1, 8, 8, 192, 192, True, 0),
    "sq_193": (1, 8, 8, 193, 193, True, 0),
    "short_kv_causal": (1, 8, 8, 100, 100, True, 0),
    "short_kv_non_causal": (1, 8, 8, 60, 100, False, 0),
    "window_turns_differ": (1, 8, 8, 300, 300, True, 40),
    "second_warpgroup_idle": (2, 8, 8, 1088, 1088, True, 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_MLA_CASES))
def test_flash_attention_mla_instance_matches_plain(case):
    """bf16 at (96, 64) launches the bf16 MLA kernel (its own count, not the
    other bf16 pairs') and meets the card's bf16 limit."""
    _need_card()
    B, Hq, Hkv, Sq, Skv, causal, window = GPU_MLA_CASES[case]
    arrays = draw(41, (B, Hq, Sq, 96), (B, Hkv, Skv, 96), (B, Hkv, Skv, 64))
    q, k, v = (torch.from_numpy(a).to("cuda", torch.bfloat16) for a in arrays)
    kw = dict(causal=causal, window=window)
    before = (tfa.bf16_mla_launches, tfa.bf16_launches)
    got = ops.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (tfa.bf16_mla_launches, tfa.bf16_launches) == (before[0] + 1, before[1])
    assert got.shape == (B, Hq, Sq, 64) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref.attention_ref(q, k, v, **kw).float(), **BF16_ATTN_TOL)


# the f32 (96, 64) kernel on the card: the CPU cases' edges (F32_MLA_CASES) at
# more heads, and the main path's shapes: name: (B, Hq, Hkv, Sq, Skv, causal,
# window, logit_cap, input scale)
GPU_F32_MLA_CASES = {
    **{name: (B, 4 * Hq, 4 * Hkv, *rest) for name, (B, Hq, Hkv, *rest) in F32_MLA_CASES.items()},
    "minicpm3_insert": (1, 40, 40, 1000, 1000, True, 0, 0.0, 1.0),
    "minicpm3_insert_64": (1, 40, 40, 64, 64, True, 0, 0.0, 1.0),
    "ragged_sq_past_skv": (1, 4, 4, 150, 70, False, 0, 0.0, 1.0),
    "window_128": (1, 4, 4, 500, 500, True, 128, 0.0, 1.0),
    "second_warpgroup_idle": (2, 8, 8, 1088, 1088, True, 0, 0.0, 1.0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_F32_MLA_CASES))
def test_flash_attention_f32_mla_instance_matches_plain(case):
    """f32 at (96, 64) launches the 3xTF32 MLA kernel (its own count: one a
    call, and none on another kernel's) and meets the f32 limit."""
    _need_card()
    B, Hq, Hkv, Sq, Skv, causal, window, cap, scale = GPU_F32_MLA_CASES[case]
    qn, kn, vn = draw(42, (B, Hq, Sq, 96), (B, Hkv, Skv, 96), (B, Hkv, Skv, 64), scale=scale)
    q, k, v = (torch.from_numpy(a).cuda() for a in (qn, kn, vn / scale))
    kw = dict(causal=causal, window=window, logit_cap=cap)
    counts = {name: getattr(tfa, name) for name in COUNTS}
    got = ops.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    counts["tf32_mla_launches"] += 1
    assert counts == {name: getattr(tfa, name) for name in COUNTS}
    assert got.shape == (B, Hq, Sq, 64) and got.dtype == torch.float32
    torch.testing.assert_close(got, ref.attention_ref(q, k, v, **kw), **F32_ATTN_TOL)


# the f32 (128, 128) kernel on the card: the CPU cases' edges (F32_D128_CASES)
# at more heads, and codeqwen1.5-7b's inserts (32 heads; mistral's 32 over 8
# KV heads): name: (B, Hq, Hkv, Sq, Skv, causal, window, logit_cap, input scale)
GPU_F32_D128_CASES = {
    **{name: (B, 4 * Hq, 4 * Hkv, *rest) for name, (B, Hq, Hkv, *rest) in F32_D128_CASES.items()},
    "codeqwen_insert": (1, 32, 32, 1000, 1000, True, 0, 0.0, 1.0),
    "codeqwen_insert_512": (1, 32, 32, 512, 512, True, 0, 0.0, 1.0),
    "codeqwen_insert_200": (1, 32, 32, 200, 200, True, 0, 0.0, 1.0),
    "codeqwen_insert_64": (1, 32, 32, 64, 64, True, 0, 0.0, 1.0),
    "gqa_32_over_8": (1, 32, 8, 1000, 1000, True, 0, 0.0, 1.0),
    "ragged_sq_past_skv": (1, 4, 4, 150, 70, False, 0, 0.0, 1.0),
    "window_128": (1, 4, 4, 500, 500, True, 128, 0.0, 1.0),
    "second_warpgroup_idle": (2, 8, 8, 1088, 1088, True, 0, 0.0, 1.0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_F32_D128_CASES))
def test_flash_attention_f32_d128_instance_matches_plain(case):
    """f32 at (128, 128) launches the 3xTF32 d 128 kernel (its own count: one
    a call, and none on another kernel's) and meets the f32 limit."""
    _need_card()
    B, Hq, Hkv, Sq, Skv, causal, window, cap, scale = GPU_F32_D128_CASES[case]
    qn, kn, vn = draw(45, (B, Hq, Sq, 128), (B, Hkv, Skv, 128), (B, Hkv, Skv, 128), scale=scale)
    q, k, v = (torch.from_numpy(a).cuda() for a in (qn, kn, vn / scale))
    kw = dict(causal=causal, window=window, logit_cap=cap)
    counts = {name: getattr(tfa, name) for name in COUNTS}
    got = ops.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    counts["tf32_d128_launches"] += 1
    assert counts == {name: getattr(tfa, name) for name in COUNTS}
    assert got.shape == (B, Hq, Sq, 128) and got.dtype == torch.float32
    torch.testing.assert_close(got, ref.attention_ref(q, k, v, **kw), **F32_ATTN_TOL)


# the f32 kernels whose K and V come split, on the card: the CPU cases' edges
# (F32_SPLIT_CASES) at more heads, and the shapes chip_smoke.py's phase 3
# gives them (Griffin's 10 heads on one KV head under a window of 512 at
# (256, 256), 16 heads at the mixed pairs): name: (B, Hq, Hkv, Sq, Skv,
# causal, window, logit_cap, input scale)
GPU_F32_SPLIT_CASES = {
    **{name: (B, 4 * Hq, 4 * Hkv, *rest) for name, (B, Hq, Hkv, *rest) in F32_SPLIT_CASES.items()},
    "griffin_window_512": (2, 10, 1, 1024, 1024, True, 512, 0.0, 1.0),
    "heads_16_s1024": (2, 16, 16, 1024, 1024, True, 0, 0.0, 1.0),
    "ragged_sq_past_skv": (1, 4, 4, 150, 70, False, 0, 0.0, 1.0),
    "second_warpgroup_idle": (2, 8, 8, 1088, 1088, True, 0, 0.0, 1.0),
}


def check_f32_instance(case, d, dv, seed):
    """f32 at (d, dv) launches its own 3xTF32 kernel (one launch on its own
    count, none on the others) and meets the f32 limit at case ``case`` of
    GPU_F32_SPLIT_CASES."""
    B, Hq, Hkv, Sq, Skv, causal, window, cap, scale = GPU_F32_SPLIT_CASES[case]
    qn, kn, vn = draw(seed, (B, Hq, Sq, d), (B, Hkv, Skv, d), (B, Hkv, Skv, dv), scale=scale)
    q, k, v = (torch.from_numpy(a).cuda() for a in (qn, kn, vn / scale))
    kw = dict(causal=causal, window=window, logit_cap=cap)
    counts = {name: getattr(tfa, name) for name in COUNTS}
    got = ops.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    counts[tfa.launch_count(torch.float32, d, dv)] += 1
    assert counts == {name: getattr(tfa, name) for name in COUNTS}
    assert got.shape == (B, Hq, Sq, dv) and got.dtype == torch.float32
    torch.testing.assert_close(got, ref.attention_ref(q, k, v, **kw), **F32_ATTN_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_F32_SPLIT_CASES))
def test_flash_attention_f32_d256_instance_matches_plain(case):
    """f32 at (256, 256) launches the 3xTF32 cluster kernel (its own count)
    and meets the f32 limit."""
    _need_card()
    check_f32_instance(case, 256, 256, seed=47)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_F32_SPLIT_CASES))
@pytest.mark.parametrize("d,dv", MIXED_HEAD_DIMS)
def test_flash_attention_f32_mixed_instance_matches_plain(case, d, dv):
    """f32 at (128, 64) and (64, 128) launches its 3xTF32 instance of the
    (128, 128) block (its own count) and meets the f32 limit."""
    _need_card()
    check_f32_instance(case, d, dv, seed=48)


@pytest.mark.gpu
def test_flash_attention_launch_config_matches_the_wrapper():
    """The library's blocks (query rows, keys a tile, stages, dynamic shared
    memory, threads, blocks a cluster) are the ones the wrapper and the CPU
    emulation assume, for every pair and dtype; the card holds clusters of
    the (256, 256) kernel, and only that kernel has a cluster."""
    _need_card()
    for dtype in tfa.DTYPES:
        for d, dv in tfa.HEAD_DIM_PAIRS:
            kind = tfa.kernel_kind(dtype, d, dv)
            bq, bk = tfa.tiles(dtype, d, dv)
            stages = {tfa.BF16: tfa.stages(d, dv), tfa.F32_TF32: tfa.tf32_stages(d, dv)}[kind]
            config = tfa.launch_config(dtype, d, dv)
            resident = config.pop("clusters_resident")
            assert config == dict(bq=bq, bk=bk, stages=stages, smem_bytes=tfa.dynamic_smem_bytes(d, dv, dtype),
                                  threads=384, cluster=tfa.cluster_blocks(dtype, d, dv))
            assert (resident > 0) == (config["cluster"] > 1)


@pytest.mark.gpu
def test_mla_attention_grads_on_the_card_match_the_cpu():
    """bf16 ``ops.attention`` at (96, 64) under autograd: the forward is the
    MLA kernel (one launch), the backward the plain path recomputed. out is
    held to one bf16 rounding; dq, dk, dv to ROADMAP's bf16 attention atol
    0.05 plus two rounding steps relative, since each device rounds the
    recompute's bf16 products at other places."""
    _need_card()
    arrays = draw(43, (1, 4, 150, 96), (1, 4, 150, 96), (1, 4, 150, 64), (1, 4, 150, 64))
    results = {}
    for dev in ("cuda", "cpu"):
        q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16).requires_grad_() for a in arrays[:3])
        before = tfa.bf16_mla_launches
        out = ops.attention(q, k, v, causal=True, kv_chunk=64)
        assert out.grad_fn is not None
        grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(arrays[3]).to(dev, torch.bfloat16))
        torch.cuda.synchronize()
        assert tfa.bf16_mla_launches == before + (dev == "cuda")
        results[dev] = [t.float().cpu() for t in (out, *grads)]
    torch.testing.assert_close(results["cuda"][0], results["cpu"][0], **BF16_ATTN_TOL)
    for got, want in zip(results["cuda"][1:], results["cpu"][1:]):
        torch.testing.assert_close(got, want, atol=0.05, rtol=2**-6)


@pytest.mark.gpu
def test_f32_mla_attention_grads_on_the_card_match_the_cpu():
    """f32 ``ops.attention`` at (96, 64) under autograd: the forward is one
    launch of the 3xTF32 MLA kernel, the backward the plain path recomputed
    (no launch); out, dq, dk, dv agree with the CPU's at the f32 attention
    limit, as at d 64."""
    _need_card()
    arrays = draw(44, (1, 4, 150, 96), (1, 2, 150, 96), (1, 2, 150, 64), (1, 4, 150, 64))
    results = {}
    for dev in ("cuda", "cpu"):
        q, k, v = (torch.from_numpy(a).to(dev).requires_grad_() for a in arrays[:3])
        before = {name: getattr(tfa, name) for name in COUNTS}
        out = ops.attention(q, k, v, causal=True, window=100, kv_chunk=64)
        assert out.grad_fn is not None
        grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(arrays[3]).to(dev))
        torch.cuda.synchronize()
        before["tf32_mla_launches"] += dev == "cuda"
        assert before == {name: getattr(tfa, name) for name in COUNTS}
        results[dev] = [t.cpu() for t in (out, *grads)]
    for got, want in zip(results["cuda"], results["cpu"]):
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.gpu
def test_f32_d128_attention_grads_on_the_card_match_the_cpu():
    """f32 ``ops.attention`` at (128, 128) under autograd: the forward is one
    launch of the 3xTF32 d 128 kernel, the backward the plain path recomputed
    (no launch); out, dq, dk, dv agree with the CPU's at the f32 attention
    limit, as at d 64 and (96, 64)."""
    _need_card()
    arrays = draw(46, (1, 4, 150, 128), (1, 2, 150, 128), (1, 2, 150, 128), (1, 4, 150, 128))
    results = {}
    for dev in ("cuda", "cpu"):
        q, k, v = (torch.from_numpy(a).to(dev).requires_grad_() for a in arrays[:3])
        before = {name: getattr(tfa, name) for name in COUNTS}
        out = ops.attention(q, k, v, causal=True, window=100, kv_chunk=64)
        assert out.grad_fn is not None
        grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(arrays[3]).to(dev))
        torch.cuda.synchronize()
        before["tf32_d128_launches"] += dev == "cuda"
        assert before == {name: getattr(tfa, name) for name in COUNTS}
        results[dev] = [t.cpu() for t in (out, *grads)]
    for got, want in zip(results["cuda"], results["cpu"]):
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.gpu
def test_f32_d256_attention_grads_on_the_card_match_the_cpu():
    """f32 ``ops.attention`` at (256, 256) under autograd: the forward is one
    launch of the 3xTF32 cluster kernel, the backward the plain path
    recomputed (no launch); out, dq, dk, dv agree with the CPU's at the f32
    attention limit, as at the other pairs."""
    _need_card()
    arrays = draw(49, (1, 4, 150, 256), (1, 1, 150, 256), (1, 1, 150, 256), (1, 4, 150, 256))
    results = {}
    for dev in ("cuda", "cpu"):
        q, k, v = (torch.from_numpy(a).to(dev).requires_grad_() for a in arrays[:3])
        before = {name: getattr(tfa, name) for name in COUNTS}
        out = ops.attention(q, k, v, causal=True, window=100, kv_chunk=64)
        assert out.grad_fn is not None
        grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(arrays[3]).to(dev))
        torch.cuda.synchronize()
        before["tf32_d256_launches"] += dev == "cuda"
        assert before == {name: getattr(tfa, name) for name in COUNTS}
        results[dev] = [t.cpu() for t in (out, *grads)]
    for got, want in zip(results["cuda"], results["cpu"]):
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,dv", [(64, 128), (128, 64)])
def test_flash_attention_kernel_mixed_head_dims(d, dv, dtype):
    """The mixed pairs launch their own kernel: bf16 the bf16 kernel, f32
    their 3xTF32 instance (one launch on its own count, none on the others)."""
    _need_card()
    arrays = draw(7, (2, 4, 130, d), (2, 2, 130, d), (2, 2, 130, dv))
    q, k, v = (torch.from_numpy(a).to("cuda", dtype) for a in arrays)
    counts = {name: getattr(tfa, name) for name in COUNTS}
    got = ops.attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    counts[tfa.launch_count(dtype, d, dv)] += 1
    assert counts == {name: getattr(tfa, name) for name in COUNTS}
    assert tfa.launch_count(dtype, d, dv) == {
        torch.bfloat16: "bf16_launches", torch.float32: f"tf32_d{d}_dv{dv}_launches"}[dtype]
    assert got.shape == (2, 4, 130, dv) and got.dtype == dtype
    tol = BF16_ATTN_TOL if dtype == torch.bfloat16 else dict(atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(got.float(), ref.attention_ref(q, k, v, causal=True).float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("d,dv", tfa.HEAD_DIM_PAIRS)
def test_f32_head_dims_run_their_kernel(d, dv):
    """Each f32 head-dim pair launches its own tensor-core kernel (each its
    own count: no pair is left on the FMA units) and meets the f32 limit."""
    _need_card()
    arrays = draw(21, (1, 4, 200, d), (1, 2, 200, d), (1, 2, 200, dv))
    q, k, v = (torch.from_numpy(a).cuda() for a in arrays)
    kind = tfa.kernel_kind(torch.float32, d, dv)
    assert (kind == tfa.F32_TF32) == ((d, dv) in tfa.TF32_HEAD_DIM_PAIRS)
    counts = {name: getattr(tfa, name) for name in COUNTS}
    got = ops.attention(q, k, v, causal=True, window=150)
    torch.cuda.synchronize()
    counts[tfa.launch_count(torch.float32, d, dv)] += 1
    assert counts == {name: getattr(tfa, name) for name in COUNTS}
    assert tfa.launch_count(torch.float32, d, dv) == tfa.TF32_COUNTS[d, dv]
    torch.testing.assert_close(got, ref.attention_ref(q, k, v, causal=True, window=150), **F32_ATTN_TOL)


# (shape, dtype): the vector path at each team size of a prefill's plan
# (warps a row: 1 at (4096, 768) f32, 2 at D 2560 and 4096 bf16, 4 at D
# 7168, 8 at 12288 bf16, 16 at 12288 f32) and of a few rows' widened plan
# (one vector a thread, or 16 warps), rows that leave teams idle, ragged
# vectors a thread (f32 D 1004, bf16 D 4608), an x larger than L2 (4096 x
# 8192 bf16, loaded past L1); the generic path at D off the vector width
# (bf16 D 1004 and 4998, f32 D 1002)
GPU_NORM_CASES = [
    ((4096, 768), torch.float32), ((8, 768), torch.float32), ((2048, 4096), torch.bfloat16),
    ((3, 5, 12288), torch.float32), ((7, 1000), torch.bfloat16), ((1000, 2560), torch.bfloat16),
    ((65, 4608), torch.bfloat16), ((129, 7168), torch.bfloat16), ((2000, 7168), torch.bfloat16),
    ((1100, 12288), torch.bfloat16), ((8, 12288), torch.bfloat16), ((16384, 256), torch.bfloat16),
    ((5, 1004), torch.float32), ((7, 1004), torch.bfloat16), ((3, 4998), torch.bfloat16),
    ((5, 1002), torch.float32), ((4096, 8192), torch.bfloat16),
]


def test_gpu_norm_cases_reach_every_team_size():
    """The card's K2 cases take every team size (1 to 16 warps), one and
    eight vectors a thread, and the generic path."""
    plans = {rmsnorm_plan(shape[-1], 2 if dtype == torch.bfloat16 else 4, int(np.prod(shape[:-1])))
             for shape, dtype in GPU_NORM_CASES if trn.takes_vector_path(shape[-1], dtype)}
    assert {team for team, _ in plans} == {1, 2, 4, 8, 16}
    assert {1, 8} <= {vpt for _, vpt in plans}
    assert not all(trn.takes_vector_path(shape[-1], dtype) for shape, dtype in GPU_NORM_CASES)


def norm_counts():
    return trn.launches, trn.generic_launches


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", GPU_NORM_CASES)
def test_rmsnorm_kernel_matches_plain(shape, dtype):
    """Within the norm limit of the plain version, one launch a call, and a
    generic launch exactly where launch_config names the generic path."""
    _need_card()
    xn, wn = draw(6, shape, shape[-1:])
    x = torch.from_numpy(xn).to("cuda", dtype)
    w = torch.from_numpy(wn).to("cuda")
    D, rows = shape[-1], x.numel() // shape[-1]
    generic = trn.launch_config(rows, D, dtype)["path"] == "generic"
    assert generic == (not trn.takes_vector_path(D, dtype))
    launches, generic_launches = norm_counts()
    got = ops.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert norm_counts() == (launches + 1, generic_launches + generic)
    # bf16 keeps 8 significant bits, so one rounding step of a value near 10
    # is 0.0625: the bf16 bound is atol 0.05 plus one step relative (2**-7)
    torch.testing.assert_close(got.float(), ref.rmsnorm_ref(x, w).float(), **NORM_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", GPU_NORM_CASES)
def test_rmsnorm_launch_config(shape, dtype):
    """The library's launch for each case: rmsnorm_plan's team and vectors a
    thread on the vector path, 256 threads a block (one team when wider), a
    row a team (narrow rows: enough that a block reads 16 KB, while every SM
    still gets a block), and every team's rows within one of the others'."""
    _need_card()
    D = shape[-1]
    rows = int(np.prod(shape[:-1]))
    elt = 2 if dtype == torch.bfloat16 else 4
    c = trn.launch_config(rows, D, dtype)
    if not trn.takes_vector_path(D, dtype):  # PR 11's kernels: a warp a row up to D 1024, else a block
        assert c["path"] == "generic" and c["vectors_per_thread"] == 0 and c["threads"] == 256, c
        assert c["team_warps"] == (1 if D <= 1024 else 8) and c["rows_per_team"] == 1, c
        return
    assert c["path"] == "vector", c
    assert (c["team_warps"], c["vectors_per_thread"]) == rmsnorm_plan(D, elt, rows, c["sms"]), c
    assert c["threads"] == max(256, 32 * c["team_warps"]) == 32 * c["team_warps"] * c["teams"], c
    row_bytes = D * elt
    assert c["rows_per_team"] == min(-(-16384 // (row_bytes * c["teams"])), -(-rows // (c["teams"] * c["sms"]))), c
    assert (c["blocks"] - 1) * c["teams"] * c["rows_per_team"] < rows <= c["blocks"] * c["teams"] * c["rows_per_team"], c
    assert c["blocks_per_sm"] >= 1, c
    assert c["stream_x"] == (rows * D * elt > c["l2_bytes"]), c


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_misaligned_views(dtype):
    """A contiguous x one element past a 16-byte boundary takes the generic
    path (the counters show it); a weight off the boundary keeps the vector
    path (the wrapper copies it to a fresh allocation)."""
    _need_card()
    rows, D = 37, 2560
    xn, wn = draw(7, (rows, D), (D,))
    xbuf = torch.zeros(rows * D + 1, device="cuda", dtype=dtype)
    xbuf[1:] = torch.from_numpy(xn).to("cuda", dtype).flatten()
    shifted = xbuf[1:].view(rows, D)
    wbuf = torch.zeros(D + 1, device="cuda")
    wbuf[1:] = torch.from_numpy(wn).to("cuda")
    w_shifted = wbuf[1:]
    aligned = torch.from_numpy(xn).to("cuda", dtype)
    assert shifted.data_ptr() % 16 and w_shifted.data_ptr() % 16 and aligned.data_ptr() % 16 == 0
    assert trn.launch_config(rows, D, dtype, shifted.data_ptr())["path"] == "generic"
    for x, w, generic in ((shifted, w_shifted, 1), (aligned, w_shifted, 0), (shifted, wbuf[1:].clone(), 1)):
        launches, generic_launches = norm_counts()
        got = ops.rmsnorm(x, w)
        torch.cuda.synchronize()
        assert norm_counts() == (launches + 1, generic_launches + generic)
        torch.testing.assert_close(got.float(), ref.rmsnorm_ref(x, w).float(), **NORM_TOL[dtype])


@pytest.mark.gpu
def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    _need_card()
    q = torch.zeros(1, 2, 8, 32, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        ops.attention(q, q, q)
    q64 = torch.zeros(1, 2, 8, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.attention(q64, q64, q64)
    for dtype in (torch.bfloat16, torch.float32):  # the TMA kernels
        shifted = torch.zeros(2 * 8 * 64 + 1, device="cuda", dtype=dtype)[1:].view(1, 2, 8, 64)
        with pytest.raises(ValueError, match="16 bytes"):
            ops.attention(shifted, shifted, shifted)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rmsnorm(torch.zeros(64, 8, device="cuda").t(), torch.ones(64, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape,dtype",
    [((8, 2304, 2560), torch.float32), ((2, 37, 100), torch.float32), ((3, 129, 256), torch.bfloat16),
     ((1, 0, 64), torch.float32), ((2, 37, 99), torch.bfloat16), ((1, 2304, 2560), torch.float32),
     ((8, 256, 2560), torch.float32), ((4, 1001, 2500), torch.bfloat16), ((2, 37, 99), torch.float32)],
)
def test_lru_scan_kernel_matches_plain(shape, dtype):
    """Within the LRU limit and to the bit, one launch a call: the served
    shapes, each copy path (16-byte rows; 4-byte bf16 rows at W 2500 and f32
    rows at W 99; 2-byte bf16 rows at W 99) and T 0."""
    _need_card()
    a, b, h0 = (torch.from_numpy(x).to("cuda") for x in lru_inputs(14, *shape))
    a, b = a.to(dtype), b.to(dtype)
    before = tlru.launches
    got_h, got_last = ops.lru_scan(a, b, h0)
    torch.cuda.synchronize()
    assert tlru.launches == before + 1
    want_h, want_last = ref.lru_ref(a, b, h0)
    tol = dict(atol=0.05, rtol=2**-7) if dtype == torch.bfloat16 else dict(atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got_h.float(), want_h.float(), **tol)
    torch.testing.assert_close(got_last, want_last, atol=1e-5, rtol=1e-5)
    assert torch.equal(got_h, want_h) and torch.equal(got_last, want_last)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,offset,path", [(torch.float32, 1, 4), (torch.bfloat16, 2, 4),
                                               (torch.bfloat16, 1, 2), (torch.float32, 4, 16)])
def test_lru_scan_kernel_copy_path_follows_the_pointers(dtype, offset, path):
    """Contiguous views that start ``offset`` elements into their storage:
    the library picks the copy path the pointers allow, and the kernel is
    still exact at a tile and stage edge."""
    _need_card()
    B, T, W = 2, 45, 136
    views = []
    for x in lru_inputs(18, B, T, W)[:2]:
        buf = torch.zeros(B * T * W + offset, device="cuda", dtype=dtype)
        buf[offset:] = torch.from_numpy(x).to("cuda").to(dtype).flatten()
        views.append(buf[offset:].view(B, T, W))
    a, b = views
    h0 = torch.from_numpy(lru_inputs(18, B, T, W)[2]).to("cuda")
    misalign = (a.data_ptr() | b.data_ptr()) % 16
    assert tlru.launch_config(B, T, W, dtype, misalign)["copy_bytes"] == path
    got_h, got_last = ops.lru_scan(a, b, h0)
    want_h, want_last = ref.lru_ref(a, b, h0)
    assert torch.equal(got_h, want_h) and torch.equal(got_last, want_last)


@pytest.mark.gpu
@pytest.mark.parametrize("served", sorted(LRU_SERVED))
def test_lru_scan_kernel_stage_edges(served):
    """At each served shape's tile and stage depth: T of 1, D - 1, D, D + 1
    (and W off the tile) equal the plain version to the bit."""
    _need_card()
    B, _, W, elt = LRU_SERVED[served]
    dtype = torch.bfloat16 if elt == 2 else torch.float32
    for T in (1, LRU_STEP_ALIGN - 1, LRU_STEP_ALIGN, LRU_STEP_ALIGN + 1):
        D = tlru.launch_config(B, T, W, dtype)["steps"]
        for t in sorted({T, D - 1, D, D + 1} - {0}):
            a, b, h0 = (torch.from_numpy(x).to("cuda") for x in lru_inputs(19, B, t, W))
            a, b = a.to(dtype), b.to(dtype)
            got_h, got_last = ops.lru_scan(a, b, h0)
            want_h, want_last = ref.lru_ref(a, b, h0)
            assert torch.equal(got_h, want_h) and torch.equal(got_last, want_last), (served, t, D)


@pytest.mark.gpu
def test_lru_scan_launch_config():
    """The library's launch at each served shape: the tile and depth of
    lru_plan (at the card's SM count), one wave (every block resident at
    once), at least 4 MB of a and b in flight, a ring that fits its blocks'
    SM, and the copy path each alignment allows."""
    _need_card()
    for name, (B, T, W, elt) in LRU_SERVED.items():
        dtype = torch.bfloat16 if elt == 2 else torch.float32
        c = tlru.launch_config(B, T, W, dtype)
        assert (c["tile"], c["steps"]) == lru_plan(B, T, W, elt, sms=c["sms"]), (name, c)
        assert c["stages"] == LRU_STAGES, (name, c)
        assert c["blocks"] == B * -(-W // c["tile"]) >= c["sms"], (name, c)
        assert c["blocks"] <= c["blocks_per_sm"] * c["sms"], (name, c)
        assert c["in_flight_bytes"] >= LRU_IN_FLIGHT, (name, c)
        assert c["smem_bytes"] == 2 * LRU_STAGES * c["steps"] * c["tile"] * elt, (name, c)
        assert c["threads"] == max(128, c["tile"]), (name, c)
    f32, bf16 = torch.float32, torch.bfloat16
    paths = {(8, 2560, f32, 0): 16, (4, 2500, bf16, 0): 4, (2, 99, bf16, 0): 2, (2, 99, f32, 0): 4,
             (2, 136, f32, 4): 4, (2, 136, bf16, 4): 4, (2, 136, bf16, 2): 2, (2, 136, bf16, 6): 2,
             (2, 136, bf16, 0): 16}
    for (B, W, dtype, misalign), path in paths.items():
        assert tlru.launch_config(B, 100, W, dtype, misalign)["copy_bytes"] == path, (B, W, dtype, misalign)


# The kernel's edges: T of one token, one short of a chunk, one chunk, one
# past it and many chunks, at each head size; bf16 with the (nonzero) s0 of
# wkv_inputs; B * H that fills the card.
WKV_EDGE_T = (1, WKV_CHUNK - 1, WKV_CHUNK, WKV_CHUNK + 1, 1000)
GPU_WKV_CASES = [
    ((8, 64, 256, 64), torch.bfloat16), ((2, 4, 100, 64), torch.float32), ((1, 3, 70, 16), torch.float32),
    ((2, 2, 33, 32), torch.bfloat16),
    *[((2, 3, T, d), torch.float32) for T in WKV_EDGE_T for d in twkv.HEAD_SIZES],
    *[((2, 3, T, 64), torch.bfloat16) for T in WKV_EDGE_T],
    ((8, 64, 1024, 64), torch.bfloat16),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", GPU_WKV_CASES)
def test_wkv6_kernel_matches_plain(shape, dtype):
    _need_card()
    r, k, v, w, u, s0 = (torch.from_numpy(x).to("cuda") for x in wkv_inputs(15, *shape))
    r, k, v, w = (t.to(dtype) for t in (r, k, v, w))
    before = twkv.launches
    got_y, got_s = ops.wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert twkv.launches == before + 1
    want_y, want_s = ref.wkv6_ref(r, k, v, w, u, s0)
    tol = dict(atol=0.05, rtol=2**-7) if dtype == torch.bfloat16 else dict(atol=5e-4, rtol=1e-3)
    torch.testing.assert_close(got_y.float(), want_y.float(), **tol)
    torch.testing.assert_close(got_s, want_s, atol=5e-4, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("d", twkv.HEAD_SIZES)
def test_wkv6_kernel_follows_its_emulation(d):
    """The kernel and emulate_wkv6_kernel add in the same order: they agree
    far inside the f32 limit over several chunks (the emulation's fma may
    round twice, rarely, so not to the bit)."""
    _need_card()
    arrays = [torch.from_numpy(x) for x in wkv_inputs(17, 2, 3, 2 * WKV_CHUNK + 5, d)]
    got_y, got_s = ops.wkv6(*(t.to("cuda") for t in arrays))
    want_y, want_s = emulate_wkv6_kernel(*arrays)
    torch.testing.assert_close(got_y.cpu(), want_y, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(got_s.cpu(), want_s, atol=1e-6, rtol=1e-6)


@pytest.mark.gpu
def test_wkv6_smem_lets_four_blocks_share_an_sm():
    """At d 64 in bf16, the served shape, four blocks are resident on one SM
    (shared memory and registers both), so that B * H = 512 blocks run at
    once on 132 SMs; every instance fits one block in whole warps; the chunk
    and row split are the ones the emulation and the edge cases assume."""
    _need_card()
    for d in twkv.HEAD_SIZES:
        for dtype in twkv.DTYPES:
            c = twkv.launch_config(d, dtype)
            assert c["blocks_per_sm"] >= 1 and c["threads"] % 32 == 0, (d, dtype, c)
            assert (c["chunk"], c["parts"]) == (WKV_CHUNK, WKV_PARTS), (d, dtype, c)
    assert twkv.launch_config(64, torch.bfloat16)["blocks_per_sm"] >= 4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_empty_sequence_returns_s0(dtype):
    """T = 0: one launch, an empty y and S_final equal to s0."""
    _need_card()
    r, k, v, w, u, s0 = (torch.from_numpy(x).to("cuda") for x in wkv_inputs(16, 2, 3, 0, 64))
    before = twkv.launches
    y, s = ops.wkv6(*(t.to(dtype) for t in (r, k, v, w)), u, s0)
    torch.cuda.synchronize()
    assert twkv.launches == before + 1
    assert y.shape == (2, 3, 0, 64) and y.dtype == dtype
    torch.testing.assert_close(s, s0, rtol=0, atol=0)


@pytest.mark.gpu
def test_wkv6_wrapper_rejects_unaligned_inputs():
    """The kernel copies r, k, v and w 16 bytes at a time: a contiguous view
    that starts off a 16-byte boundary is refused, not read wrongly."""
    _need_card()
    shape = (1, 2, 8, 64)
    buf = torch.zeros(2 * 8 * 64 + 1, device="cuda", dtype=torch.bfloat16)
    bad = buf[1:].view(shape)
    z = torch.zeros(shape, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        ops.wkv6(bad, z, z, z, torch.zeros(2, 64, device="cuda"), torch.zeros(1, 2, 64, 64, device="cuda"))


@pytest.mark.gpu
def test_recurrence_wrappers_reject_what_the_kernels_do_not_take():
    _need_card()
    a = torch.zeros(1, 4, 8, device="cuda")
    with pytest.raises(TypeError, match="h0"):
        ops.lru_scan(a, a, torch.zeros(1, 8, device="cuda", dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        ops.lru_scan(a.transpose(1, 2).contiguous().transpose(1, 2), a, torch.zeros(1, 8, device="cuda"))
    z = torch.zeros(1, 2, 4, 128, device="cuda")
    with pytest.raises(ValueError, match="head size"):
        ops.wkv6(z, z, z, z, torch.zeros(2, 128, device="cuda"), torch.zeros(1, 2, 128, 128, device="cuda"))


# name: (G, N, E, k, capacity, logit scale, skew). The first three are the
# shapes the deepseek-moe-16b path gives the kernels (its largest prefill group
# set, one group of a short prefill and a decode step), with the router's
# logit scale at full width; then groups of several tiles with N off the
# tile and drops, one group of 30000 tokens at k 8, an odd shape with drops,
# kimi-k2's routing widths, and narrow E below a warp.
GPU_GATING_CASES = {
    "deepseek_prefill": (16, 1024, 64, 6, 120, 0.1, 0.0),
    "deepseek_prefill_g1": (1, 1024, 64, 6, 120, 0.1, 0.0),
    "deepseek_decode": (1, 8, 64, 6, 4, 0.1, 0.0),
    "ragged_tiles_drops": (3, 1000, 64, 6, 94, 1.0, 1.0),
    "long_group_k8": (1, 30000, 64, 8, 4688, 1.0, 0.0),
    "odd_drops": (3, 100, 160, 8, 13, 1.0, 1.0),
    "kimi_routing": (4, 256, 384, 8, 7, 1.0, 0.0),
    "e16_k2": (2, 64, 16, 2, 12, 1.0, 0.0),
    "e8_k1": (3, 32, 8, 1, 5, 1.0, 0.5),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_GATING_CASES))
def test_moe_gating_kernel_matches_plain(case):
    _need_card()
    G, N, E, k, cap, scale, skew = GPU_GATING_CASES[case]
    x = torch.from_numpy(router_logits(24, G, N, E, scale=scale, skew=skew)).cuda()
    before = tgate.launches
    idx, gate, pos = ops.moe_gating(x, top_k=k, capacity=cap)
    torch.cuda.synchronize()
    assert tgate.launches == before + 1
    want_idx, want_gate, want_pos = ref.moe_gating_ref(x, top_k=k, capacity=cap)
    torch.testing.assert_close(idx, want_idx, rtol=0, atol=0)
    torch.testing.assert_close(pos, want_pos, rtol=0, atol=0)
    torch.testing.assert_close(gate, want_gate, rtol=0, atol=1e-6)
    if skew:
        assert bool((pos < 0).any())


@pytest.mark.gpu
def test_moe_gating_kernel_drops_past_capacity():
    _need_card()
    x = torch.zeros(1, 32, 4, device="cuda")
    x[:, :, 0] = 10.0
    _, _, pos = ops.moe_gating(x, top_k=1, capacity=5)
    assert pos[0, :, 0].tolist() == [0, 1, 2, 3, 4] + [-1] * 27


@pytest.mark.gpu
def test_moe_gating_wrapper_rejects_what_the_kernel_does_not_take():
    _need_card()
    x = torch.zeros(1, 8, 64, device="cuda")
    with pytest.raises(TypeError, match="float32"):
        ops.moe_gating(x.double(), top_k=2, capacity=4)
    with pytest.raises(ValueError, match="contiguous"):
        ops.moe_gating(torch.zeros(1, 64, 8, device="cuda").transpose(1, 2), top_k=2, capacity=4)
    with pytest.raises(ValueError, match="top_k"):
        ops.moe_gating(x, top_k=0, capacity=4)
    with pytest.raises(ValueError, match="top_k"):
        ops.moe_gating(torch.zeros(1, 8, 400, device="cuda"), top_k=2, capacity=4)
    with pytest.raises(ValueError, match="top_k"):
        ops.moe_gating(x, top_k=33, capacity=4)
    with pytest.raises(ValueError, match="capacity"):
        ops.moe_gating(x, top_k=2, capacity=-1)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 300, 64, 6, 30), (3, 100, 160, 8, 13), (1, 8, 64, 6, 4)])
def test_moe_gating_kernel_follows_its_emulation(shape):
    """Groups of several tiles (N off the tile, several 32-token segments a
    tile, drops) and of one tile give the emulation's idx, pos and gate at
    the library's tile, and its slots kernel runs exactly when a group spans
    more than one tile."""
    _need_card()
    G, N, E, k, cap = shape
    x = torch.from_numpy(router_logits(26, G, N, E, skew=1.0))
    before = tgate.slots_launches
    idx, gate, pos = ops.moe_gating(x.cuda(), top_k=k, capacity=cap)
    assert tgate.slots_launches == before + (N > tgate.TILE)
    want_idx, want_gate, want_pos, _ = emulate_moe_gating_kernel(x, k, cap, tgate.TILE)
    torch.testing.assert_close(idx.cpu(), want_idx, rtol=0, atol=0)
    torch.testing.assert_close(pos.cpu(), want_pos, rtol=0, atol=0)
    torch.testing.assert_close(gate.cpu(), want_gate, rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_moe_gating_launch_config():
    """The library's launches are the ones the kernels assume: a warp per row
    of the tile (at most 32), shared memory for the tile's counts and picks,
    one tile a decode step; at deepseek-moe-16b's prefill shape two route
    blocks fit an SM, so its 256 blocks are all resident on 132 SMs."""
    _need_card()
    for N, E, k in ((1024, 64, 6), (8, 64, 6), (100, 384, 8)):
        c = tgate.launch_config(N, E, k)
        R = tgate.TILE
        assert c["tiles"] == -(-N // R)
        assert c["route"]["threads"] == 32 * min(32, R, N)
        assert c["route"]["smem_bytes"] == 4 * k * (E + R + 1)
        assert c["slots"]["smem_bytes"] == 4 * k * (R + 1 + 2 * E)
        assert c["route"]["blocks_per_sm"] >= 1 and c["slots"]["blocks_per_sm"] >= 1
    assert tgate.launch_config(1024, 64, 6)["route"]["blocks_per_sm"] >= 2


# the train path's gradients through the autograd Functions of ops: on the
# card the forward is the kernel, the backward the plain path recomputed
GRAD_ATTN_CASES = {
    # name: (B, Hq, Hkv, S, d, window, logit_cap, kv_chunk); nbi-100m's heads
    # at two chunkings, GQA with a window, a logit cap on a ragged length
    "nbi100m_heads": (2, 4, 4, 128, 64, 0, 0.0, 1024),
    "nbi100m_heads_chunked": (2, 4, 4, 128, 64, 0, 0.0, 32),
    "gqa_window": (1, 8, 2, 200, 64, 50, 0.0, 64),
    "logit_cap_ragged": (1, 4, 4, 77, 64, 0, 30.0, 32),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GRAD_ATTN_CASES))
def test_attention_grads_on_the_card_match_the_cpu(case):
    """``ops.attention`` on CUDA tensors that require grad: the output keeps
    its ``grad_fn`` (the 3xTF32 kernel's forward, one launch, the backward
    launching none) and out, dq, dk, dv agree with the CPU's at the f32
    attention limit."""
    _need_card()
    B, Hq, Hkv, S, d, window, cap, chunk = GRAD_ATTN_CASES[case]
    arrays = draw(31, (B, Hq, S, d), (B, Hkv, S, d), (B, Hkv, S, d), (B, Hq, S, d))
    kw = dict(causal=True, window=window, logit_cap=cap, kv_chunk=chunk)
    results = {}
    for dev in ("cuda", "cpu"):
        q, k, v = (torch.from_numpy(a).to(dev).requires_grad_() for a in arrays[:3])
        before = tfa.tf32_launches
        out = ops.attention(q, k, v, **kw)
        assert out.grad_fn is not None
        grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(arrays[3]).to(dev))
        torch.cuda.synchronize()
        assert tfa.tf32_launches == before + (dev == "cuda")
        results[dev] = [t.cpu() for t in (out, *grads)]
    for got, want in zip(results["cuda"], results["cpu"]):
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_grads_on_the_card_match_the_cpu(dtype):
    _need_card()
    x, w, g = draw(32, (4, 100, 768), (768,), (4, 100, 768))
    results = {}
    for dev in ("cuda", "cpu"):
        xt = torch.from_numpy(x).to(dev, dtype).requires_grad_()
        wt = torch.from_numpy(1.0 + 0.1 * w).to(dev).requires_grad_()
        before = trn.launches
        out = ops.rmsnorm(xt, wt)
        assert out.grad_fn is not None
        dx, dw = torch.autograd.grad(out, (xt, wt), torch.from_numpy(g).to(dev, dtype))
        torch.cuda.synchronize()
        assert trn.launches == before + (dev == "cuda")
        results[dev] = [t.cpu().float() for t in (out, dx, dw)]
    # dw sums 400 rows: its f32 sums differ in order between the devices
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=0.05, rtol=2**-7)
    for got, want in zip(results["cuda"], results["cpu"]):
        torch.testing.assert_close(got, want, **tol)


@pytest.mark.gpu
def test_forward_only_kernels_refuse_grad_on_the_card():
    """The gating kernel has no backward and refuses grad on the card; the LRU
    and WKV kernels run under autograd (their gradients recompute the plain
    path), and without grad return results off the graph."""
    _need_card()
    a = torch.rand(1, 8, 32, device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.moe_gating(torch.rand(1, 8, 16, device="cuda", requires_grad=True), top_k=2, capacity=4)
    h, _ = ops.lru_scan(a, a, torch.zeros(1, 32, device="cuda"))
    assert h.grad_fn is not None
    r = torch.rand(1, 2, 8, 16, device="cuda", requires_grad=True)
    y, _ = ops.wkv6(r, r, r, r, torch.rand(2, 16, device="cuda"), torch.zeros(1, 2, 16, 16, device="cuda"))
    assert y.grad_fn is not None
    with torch.no_grad():
        h, _ = ops.lru_scan(a, a, torch.zeros(1, 32, device="cuda"))
    assert h.grad_fn is None
