"""The port's step accounting against the reference's
(``repro_torch.analysis`` against ``repro.analysis``): the roofline report,
the H100's peaks, the kernels' work, and the op counter against
``analyze_hlo`` on the same functions and on whole train and prefill steps
of smoke configs, on one device and on a fake (2, 2) mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
import repro.models.rglru as ref_rglru
import repro.models.transformer as ref_transformer
import repro.models.whisper as ref_whisper
from repro.analysis.hlo import analyze_hlo
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models.common import attention_chunked as ref_attention
from repro.models.registry import build_model as ref_build_model
from repro.optim import make_optimizer as ref_make_optimizer
from repro.training.steps import abstract_train_state as ref_abstract_train_state
from repro.training.steps import make_prefill_step as ref_make_prefill_step
from repro.training.steps import make_train_step as ref_make_train_step
from repro.analysis.roofline import V5E
from repro.analysis.roofline import roofline_report as ref_report
from repro_torch.analysis import roofline
from repro_torch.analysis.opstats import count
from repro_torch.analysis.roofline import H100, HW, roofline_report
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, submit
from repro_torch.models.registry import build_model

# the reference's V5E as a port record: one unit and one link
V5E_PORT = HW(peak_flops={"bfloat16": V5E.peak_flops}, hbm_bw=V5E.hbm_bw, hbm_bytes=V5E.hbm_bytes,
              link_bw=V5E.link_bw)


def lowered_text(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


# tests/test_analysis.py's cases (its two reports), and a collective-bound one
REPORTS = {
    "terms_and_bottleneck": dict(per_device_flops=197e12, per_device_hbm_bytes=819e9 / 2,
                                 per_device_wire_bytes=50e9 / 4, chips=256, model_flops=0.5 * 197e12 * 256,
                                 tokens=1e6),
    "memory_bound": dict(per_device_flops=1e12, per_device_hbm_bytes=819e9, per_device_wire_bytes=0, chips=1,
                         model_flops=1e12, tokens=1),
    "collective_bound": dict(per_device_flops=1e12, per_device_hbm_bytes=1e9, per_device_wire_bytes=50e9 * 3,
                             chips=512, model_flops=3e14, tokens=4096),
}


@pytest.mark.parametrize("case", sorted(REPORTS))
def test_roofline_report_equals_the_reference(case):
    """With one unit and one link the port's report is the reference's dict."""
    want = ref_report(**REPORTS[case])
    assert roofline_report(**REPORTS[case], hw=V5E_PORT) == want
    assert roofline_report(**REPORTS[case], hw=V5E_PORT, flops_by_unit={"bfloat16": REPORTS[case]["per_device_flops"]},
                           wire_bytes_by_link={"link": REPORTS[case]["per_device_wire_bytes"]}) == want


def test_v5e_in_a_port_record():
    assert V5E_PORT.peak_flops == {"bfloat16": 197e12}
    assert (V5E_PORT.hbm_bw, V5E_PORT.link_bw, V5E_PORT.hbm_bytes) == (819e9, 50e9, 16e9)


def test_report_sums_units_and_links():
    """Each unit's FLOPs over its own peak, each link's bytes over its own
    bandwidth; MFU against the model dtype's peak."""
    rep = roofline_report(per_device_flops=989e12 + 67e12 + 495e12, per_device_hbm_bytes=3.35e12,
                          per_device_wire_bytes=450e9 + 50e9, chips=8, model_flops=989e12 * 8, tokens=10,
                          flops_by_unit={"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12},
                          wire_bytes_by_link={"link": 450e9, "net": 50e9})
    assert rep["compute_s"] == pytest.approx(3.0)
    assert rep["memory_s"] == pytest.approx(1.0)
    assert rep["collective_s"] == pytest.approx(2.0)
    assert rep["bottleneck"] == "compute"
    assert rep["roofline_fraction_mfu"] == pytest.approx(1 / 3)
    f32 = roofline_report(per_device_flops=67e12, per_device_hbm_bytes=0, per_device_wire_bytes=0, chips=1,
                          model_flops=67e12, tokens=1, unit="float32")
    assert f32["compute_s"] == pytest.approx(1.0) and f32["roofline_fraction_mfu"] == pytest.approx(1.0)


def test_h100_values():
    assert H100.peak_flops == {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
    assert (H100.hbm_bw, H100.hbm_bytes, H100.link_bw, H100.net_bw, H100.node_gpus) == (3.35e12, 80e9, 450e9, 50e9, 8)


def test_submit_reads_the_h100_record():
    assert submit.GPU_MEMORY_BYTES == H100.hbm_bytes == 80e9
    assert not hasattr(submit, "PEAK_FLOPS") and not hasattr(chip_smoke, "PEAK_FLOPS")


def mask_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    q = np.arange(Sq)[:, None]
    k = np.arange(Skv)[None, :]
    keep = np.ones((Sq, Skv), dtype=bool)
    if causal:
        keep &= k <= q
    if window > 0:
        keep &= q - k < window
    return int(keep.sum())


@settings(max_examples=300, deadline=None)
@given(st.integers(0, 300), st.integers(0, 300), st.booleans(), st.integers(0, 320))
def test_kept_pairs_is_the_mask_count(Sq, Skv, causal, window):
    assert roofline.kept_pairs(Sq, Skv, causal, window) == mask_pairs(Sq, Skv, causal, window)


@pytest.mark.parametrize("Sq,Skv,causal,window", [(1, 1032, True, 0), (1000, 1000, True, 0), (300, 17, True, 5),
                                                   (17, 300, False, 40), (2048, 2048, True, 2048),
                                                   (2304, 2304, True, 2048), (5, 9, False, 0)])
def test_kept_pairs_edges(Sq, Skv, causal, window):
    assert roofline.kept_pairs(Sq, Skv, causal, window) == mask_pairs(Sq, Skv, causal, window)


def phase3_case(cases, name):
    return next(c for c in cases if c[0] == name)[1:]


# chip_smoke.py phase 3's printed bounds (ms, to its 4 decimals) before the
# work moved into analysis.roofline
BOUNDS = {
    "nbi100m_prefill": ("attention", 0.0196), "deepseek_prefill": ("attention", 0.1390),
    "mla_prefill": ("attention", 0.2172), "deepseek_prefill_rows": ("rmsnorm", 0.0401),
    "griffin_prefill": ("lru", 0.1691), "rwkv6_prefill": ("wkv6", 0.1603), "deepseek_prefill_g": ("gating", 0.0016),
}


@pytest.mark.parametrize("name", sorted(BOUNDS))
def test_work_bounds_print_phase3_digits(name):
    what, want = BOUNDS[name]
    if what == "attention":
        B, Hq, Hkv, Sq, Skv, d, dv, dtype, causal, window, _ = phase3_case(chip_smoke.attention_cases(True), name)
        work = roofline.attention_work(B, Hq, Hkv, Sq, Skv, d, dv, dtype, causal, window)
    elif what == "rmsnorm":
        rows, D, dtype = phase3_case(chip_smoke.norm_cases(True), name)
        work = roofline.rmsnorm_work(rows, D, dtype)
    elif what == "lru":
        work = roofline.lru_work(*phase3_case(chip_smoke.lru_cases(True), name))
    elif what == "wkv6":
        B, H, T, d, dtype, _ = phase3_case(chip_smoke.wkv_cases(True), name)
        work = roofline.wkv6_work(B, H, T, d, dtype)
    else:
        G, N, E, k = phase3_case(chip_smoke.gating_cases(True), "deepseek_prefill")[:4]
        work = roofline.moe_gating_work(G, N, E, k)
    ms, _ = roofline.bound(work)
    assert f"{ms:.4f}" == f"{want:.4f}"


def test_f32_attention_work_counts_three_tf32_products():
    fma = roofline.attention_work(2, 4, 2, 64, 64, 64, 64, torch.float32, True, 0, kernel=False)
    tf32 = roofline.attention_work(2, 4, 2, 64, 64, 64, 64, torch.float32, True, 0)
    assert fma[2] == "float32" and tf32 == (3 * fma[0], fma[1], "tf32")
    assert fma[0] == 2 * 4 * (64 * 65 // 2) * (2 * 64 + 2 * 64)
    bf16 = roofline.attention_work(2, 4, 2, 64, 64, 64, 64, torch.bfloat16, True, 0)
    assert bf16 == (fma[0], fma[1] // 2, "bfloat16")


# ---------------------------------------------------------------------------
# count against analyze_hlo
# ---------------------------------------------------------------------------


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_matmul_flops_exact():
    st_ref = analyze_hlo(lowered_text(lambda a, b: a @ b, jnp.zeros((128, 256)), jnp.zeros((256, 64))))
    stats, out = count(lambda a, b: a @ b, meta(128, 256), meta(256, 64))
    want = 2 * 128 * 256 * 64
    assert stats.flops == want and stats.flops_by_unit == {"float32": want} and out.shape == (128, 64)
    assert st_ref.notes == [] and stats.flops == st_ref.flops
    assert stats.hbm_bytes == (128 * 256 + 256 * 64 + 128 * 64) * 4
    bf16, _ = count(lambda a, b: a @ b, meta(128, 256, dtype=torch.bfloat16), meta(256, 64, dtype=torch.bfloat16))
    assert bf16.flops_by_unit == {"bfloat16": want}


def test_loop_of_matmuls_scales_n_fold():
    """The reference recovers the scan's trip count; eager PyTorch dispatches
    every iteration."""
    W = jnp.eye(64, dtype=jnp.float32)

    def ref_flops(n):
        def f(x):
            h, _ = jax.lax.scan(lambda h, _: (jnp.tanh(h @ W), None), x, None, length=n)
            return h

        return analyze_hlo(lowered_text(f, jnp.ones((64, 64)))).flops

    def port(n):
        def f(x, w):
            for _ in range(n):
                x = torch.tanh(x @ w)
            return x

        return count(f, meta(64, 64), meta(64, 64))[0]

    s8, s32 = port(8), port(32)
    assert s8.flops == 8 * 2 * 64**3 and s32.flops == 4 * s8.flops
    assert s32.hbm_bytes == 4 * s8.hbm_bytes
    assert (s8.flops, s32.flops) == (ref_flops(8), ref_flops(32))


def test_elementwise_bytes_at_least_read_and_write():
    stats, _ = count(lambda a: a + 1.0, meta(1024, 1024))
    assert stats.hbm_bytes >= 2 * 1024 * 1024 * 4
    assert stats.bytes_by_op == {"add": 2 * 1024 * 1024 * 4} and stats.flops == 0


def test_views_and_allocations_are_free():
    stats, _ = count(lambda a: a.reshape(64, 16).t().unsqueeze(0)[:, :4], meta(32, 32))
    assert stats.hbm_bytes == 0
    stats, _ = count(lambda: torch.empty(1000, device="meta"))
    assert stats.hbm_bytes == 0 and stats.peak_bytes == 4000


def test_no_collectives_on_single_device():
    st_ref = analyze_hlo(lowered_text(lambda a: a @ a, jnp.ones((32, 32))))
    stats, _ = count(lambda a: a @ a, meta(32, 32))
    assert stats.collective_wire_bytes == st_ref.collective_wire_bytes == 0
    assert stats.collective_count == st_ref.collective_count == 0


def test_peak_bytes_on_a_chain():
    """a (1 MB) → b = a·2 → c = b + 1 (b freed when the chain drops it) →
    d = c.sum(): at most two 1 MB results live beside the argument."""
    def chain(a):
        b = a * 2
        c = b + 1
        del b
        return c.sum()

    stats, out = count(chain, meta(256, 1024))
    mb = 256 * 1024 * 4
    assert stats.argument_bytes == mb
    assert stats.peak_bytes == 3 * mb
    assert stats.output_bytes == 4 and out.shape == ()

    def keep_all(a):
        return [a * k for k in range(4)]

    assert count(keep_all, meta(256, 1024))[0].peak_bytes == 5 * mb


# ---------------------------------------------------------------------------
# whole steps against analyze_hlo
# ---------------------------------------------------------------------------

STEP_B, STEP_S = 2, 32  # a step's rows and tokens: two of the smoke configs' attention chunks of 16


def step_configs(arch: str) -> tuple:
    """(reference config, port config) of ``arch``'s smoke config at the head
    widths the port's attention kernel takes."""
    cfg = dryrun.kernel_widths(get_smoke_config(arch))
    widths = {k: getattr(cfg, k) for k in ("head_dim", "qk_nope_dim", "qk_rope_dim", "v_head_dim")}
    return ref_smoke_config(arch).replace(**widths), cfg


def ref_step_flops(cfg, kind: str) -> float:
    """``analyze_hlo``'s FLOPs of the reference's jitted train or prefill step
    on one CPU device (no mesh and no rules)."""
    model = ref_build_model(cfg)
    if kind == "train":
        opt = ref_make_optimizer(cfg.optimizer)
        step, args = ref_make_train_step(model, opt, None, None), (ref_abstract_train_state(model, opt),
                                                                   model.train_inputs(STEP_B, STEP_S))
    else:
        step, args = ref_make_prefill_step(model, None, None), (model.abstract_params(),
                                                                model.prefill_inputs(STEP_B, STEP_S))
    stats = analyze_hlo(lowered_text(step, *args))
    assert stats.notes == [], stats.notes
    return stats.flops


def port_step(cfg, kind: str):
    step, args = dryrun.step_and_inputs(build_model(cfg), kind, STEP_B, STEP_S)
    return count(step, *args)[0]


def products(stats) -> float:
    """The count's FLOPs of matrix products: all but the port's kernels' work."""
    return sum(f for op, f in stats.flops_by_op.items() if op not in stats.kernel_calls)


def test_prefill_step_equals_the_reference():
    """nbi-100m's prefill: the reference's step is its products plus its XLA
    attention (``attention_chunked``, two layers of it); the port's is the
    same products plus K1's work (the pairs the causal mask keeps, 3×TF32)
    and K2's. Exact, to the FLOP."""
    ref_cfg, cfg = step_configs("nbi100m")
    hd = cfg.resolved_head_dim
    q = jnp.zeros((STEP_B, cfg.n_heads, STEP_S, hd))
    attention = analyze_hlo(lowered_text(
        lambda q, k, v: ref_attention(q, k, v, causal=True, kv_chunk=cfg.attn_chunk), q, q, q)).flops
    stats = port_step(cfg, "prefill")
    assert products(stats) == ref_step_flops(ref_cfg, "prefill") - cfg.n_layers * attention
    k1 = roofline.attention_work(STEP_B, cfg.n_heads, cfg.n_kv_heads, STEP_S, STEP_S, hd, hd, torch.float32, True, 0)
    assert stats.kernel_calls == {"rmsnorm": 2 * cfg.n_layers + 1, "flash_attention_tf32": cfg.n_layers}
    assert stats.flops_by_op["flash_attention_tf32"] == cfg.n_layers * k1[0]
    assert stats.flops_by_unit["tf32"] == cfg.n_layers * k1[0]


def held_out_attention(monkeypatch):
    """Both packages' attention replaced by one that multiplies nothing (q
    plus the mean of k + v over the keys, K/V repeated to the query heads):
    the reference's XLA attention and the port's kernel (with its plain
    recompute for the gradient) do different products by design, so a step
    without them must match product for product."""
    def ref_attend(q, k, v, **_):
        return q[..., :v.shape[-1]] + (k[..., :v.shape[-1]] + v).mean(axis=2, keepdims=True)

    def port_attend(q, k, v, **_):
        g = q.shape[1] // k.shape[1]
        return q[..., :v.shape[-1]] + (k[..., :v.shape[-1]] + v).mean(dim=2, keepdim=True).repeat_interleave(g, 1)

    for module in (ref_transformer, ref_rglru, ref_whisper):
        monkeypatch.setattr(module, "attention_chunked", ref_attend)
    monkeypatch.setattr(ops, "attention", port_attend)


# the steps whose every product the two packages share; MoE (the
# reference's one-hot dispatch and combine are products, the port's gathers
# are not), RWKV-6 (the reference's WKV recurrence has products, K4 does
# not), MLA's and Whisper's train steps differ by design
HELD_OUT_STEPS = [("nbi100m", "train"), ("nbi100m", "prefill"), ("recurrentgemma_2b", "train"),
                  ("recurrentgemma_2b", "prefill"), ("minicpm3_4b", "prefill"), ("whisper_small", "prefill")]


@pytest.mark.parametrize("arch,kind", HELD_OUT_STEPS)
def test_step_products_equal_the_reference(arch, kind, monkeypatch):
    """A whole train or prefill step (forward, backward, optimizer) without
    attention: the count's products equal ``analyze_hlo``'s, exactly."""
    held_out_attention(monkeypatch)
    ref_cfg, cfg = step_configs(arch)
    assert products(port_step(cfg, kind)) == ref_step_flops(ref_cfg, kind)


# ---------------------------------------------------------------------------
# a fake (2, 2) mesh
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_mesh():
    """A ("data", "model") 2 × 2 mesh as rank 0 of a fake process group,
    destroyed after the test; none may exist before or be left after."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def dtensor(mesh, local_shape, placements):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(meta(*local_shape), mesh, placements, run_check=False)


def test_column_parallel_matmul_counts_a_quarter(fake_mesh):
    """x replicated, w split by columns over both mesh dims: each rank
    multiplies all of x by its quarter of w, with no collective."""
    from torch.distributed.tensor import Replicate, Shard

    x = dtensor(fake_mesh, (64, 256), (Replicate(), Replicate()))
    w = dtensor(fake_mesh, (256, 256), (Shard(1), Shard(1)))
    stats, out = count(lambda x, w: x @ w, x, w)
    assert out.shape == (64, 1024)
    assert stats.flops == 2 * 64 * 256 * 1024 / 4
    assert stats.collective_count == 0


def test_row_parallel_all_reduce(fake_mesh):
    """x split by columns and w by rows over ``model``: partial sums, then
    an all-reduce of s = the output's bytes: 2·s·(N−1)/N on NVLink."""
    from torch.distributed.tensor import Replicate, Shard

    x = dtensor(fake_mesh, (64, 128), (Replicate(), Shard(1)))
    w = dtensor(fake_mesh, (128, 512), (Replicate(), Shard(0)))
    stats, _ = count(lambda x, w: (x @ w).redistribute(fake_mesh, (Replicate(), Replicate())), x, w)
    s = 64 * 512 * 4
    assert stats.flops == 2 * 64 * 128 * 512
    assert stats.collective_by_type == {"all-reduce": 2 * s * (2 - 1) / 2}
    assert stats.wire_bytes_by_link == {"link": s} and stats.collective_count == 1


def test_all_gather_and_reduce_scatter(fake_mesh):
    from torch.distributed.tensor import Partial, Replicate, Shard

    x = dtensor(fake_mesh, (32, 64), (Shard(0), Replicate()))
    gathered, _ = count(lambda x: x.redistribute(fake_mesh, (Replicate(), Replicate())), x)
    r = 64 * 64 * 4  # the gathered result
    assert gathered.collective_by_type == {"all-gather": r * (2 - 1) / 2}
    y = dtensor(fake_mesh, (64, 64), (Partial(), Replicate()))
    scattered, _ = count(lambda y: y.redistribute(fake_mesh, (Shard(0), Replicate())), y)
    r = 32 * 64 * 4  # the scattered result
    assert scattered.collective_by_type == {"reduce-scatter": r * (2 - 1)}


def test_legacy_all_reduce_counted(fake_mesh):
    """``torch.distributed.all_reduce`` (the vocab-parallel loss, split-KV
    decode) is counted like the functional one."""
    x = meta(1000)
    stats, _ = count(lambda x: dist.all_reduce(x, group=fake_mesh.get_group("model")), x)
    assert stats.collective_by_type == {"all-reduce": 2 * 4000 * (2 - 1) / 2} and not stats.notes
