"""The port's dry-run (``repro_torch.launch.dryrun``) against the reference's
(``repro.launch.dryrun``), and the kernels' meta route
(``repro_torch.kernels.ops``).

Every family's smoke config, at head widths the attention kernel takes
(``dryrun.kernel_widths``: the meta route refuses the smoke configs' 16-wide
heads as the card's wrapper does), counts a train, prefill and decode step
on ``meta``, without a mesh and on a fake (2, 2) mesh: the count's kernel
calls are the ``ops.*`` calls the same step makes on CPU tensors, and each
rank's matrix products a quarter of the step's (nbi-100m's exactly). A cell
builds its own fake process group and leaves none behind; the tests that
make one check that none exists before or after. The reference's dry-run
sets ``XLA_FLAGS`` when it is imported, so its cells are read in a
subprocess.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro.configs import ASSIGNED as REF_ASSIGNED
from repro_torch.analysis import roofline
from repro_torch.analysis.opstats import count
from repro_torch.configs import ARCHS, ASSIGNED, get_smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import parse_mesh
from repro_torch.models.common import map_defs, torch_dtype
from repro_torch.models.registry import build_model
from repro_torch.optim import make_optimizer
from repro_torch.training import init_train_state

ROOT = Path(__file__).resolve().parent.parent
# small cells: the smoke configs' attention chunks (8 to 16) would loop
# through the published shapes' thousands of tokens chunk by chunk
SMALL = {"train_4k": ("train", 16, 4), "prefill_32k": ("prefill", 16, 4), "decode_32k": ("decode", 16, 4),
         "long_500k": ("decode", 64, 1)}
KIND_SHAPE = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}
RECORD_KEYS = {"arch", "shape", "kind", "mesh", "chips", "seq", "batch", "rules", "collective_by_type",
               "collective_count", "param_count", "active_param_count", "padded_vocab", "status", "count_s",
               "flops_per_device", "hbm_bytes_per_device", "collective_wire_bytes_per_device", "memory",
               "kernel_calls", "roofline"}


@pytest.fixture
def no_group_before_or_after():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


@pytest.fixture
def small_shapes(monkeypatch):
    for name, shape in SMALL.items():
        monkeypatch.setitem(dryrun.SHAPES, name, shape)


def test_shapes_and_cells_equal_the_reference():
    code = ("import json; from repro.launch.dryrun import SHAPES, MESHES, plan_cells; "
            "print(json.dumps({'shapes': SHAPES, 'meshes': list(MESHES), 'cells': plan_cells()}))")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=240,
                         check=True)
    want = json.loads(out.stdout.strip().splitlines()[-1])
    assert json.loads(json.dumps(dryrun.SHAPES)) == want["shapes"]
    assert list(dryrun.MESHES) == want["meshes"]
    assert dryrun.plan_cells() == want["cells"]
    assert dryrun.plan_cells(["rwkv6-7b"], ["long_500k"])[0]["skip"] is None


def test_assigned_equals_the_reference():
    assert ASSIGNED == REF_ASSIGNED


def test_meshes_keep_model_inside_a_node():
    single, multi = (parse_mesh(dryrun.MESHES[m]) for m in ("single", "multi"))
    assert (single.size(), multi.size()) == (256, 512)
    assert single.mesh_dim_names == ("data", "model") and multi.mesh_dim_names == ("pod", "data", "model")
    assert single.shape[-1] == multi.shape[-1] == roofline.H100.node_gpus


# ---------------------------------------------------------------------------
# the meta route
# ---------------------------------------------------------------------------


def randn(*shape, dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(sum(shape))
    return torch.randn(shape, generator=g).to(dtype).to(device)


def attention_case(dtype, d, dv, device):
    return (randn(2, 4, 24, d, dtype=dtype, device=device), randn(2, 2, 40, d, dtype=dtype, device=device),
            randn(2, 2, 40, dv, dtype=dtype, device=device))


# name: (op, inputs on a device, the launch counts a kernel call adds one to)
META_CASES = {
    "attention_f32": (lambda q, k, v: ops.attention(q, k, v, causal=True, window=16),
                      lambda dev: attention_case(torch.float32, 64, 64, dev), {"flash_attention_tf32": 1}),
    "attention_bf16_mla": (lambda q, k, v: ops.attention(q, k, v, causal=False),
                           lambda dev: attention_case(torch.bfloat16, 96, 64, dev), {"flash_attention_bf16_mla": 1}),
    "attention_f32_d128": (lambda q, k, v: ops.attention(q, k, v),
                           lambda dev: attention_case(torch.float32, 128, 128, dev),
                           {"flash_attention_tf32_d128": 1}),
    "rmsnorm_vector": (ops.rmsnorm, lambda dev: (randn(3, 7, 64, dtype=torch.bfloat16, device=dev),
                                                 randn(64, device=dev)), {"rmsnorm": 1}),
    "rmsnorm_generic": (ops.rmsnorm, lambda dev: (randn(5, 20, dtype=torch.bfloat16, device=dev),
                                                  randn(20, device=dev)),
                        {"rmsnorm": 1, "rmsnorm_generic": 1}),
    "lru_scan": (ops.lru_scan, lambda dev: (randn(2, 9, 16, device=dev), randn(2, 9, 16, device=dev),
                                            randn(2, 16, device=dev)), {"lru_scan": 1}),
    "wkv6": (ops.wkv6, lambda dev: (*(randn(2, 3, 10, 16, dtype=torch.bfloat16, device=dev) for _ in range(3)),
                                    torch.full((2, 3, 10, 16), 0.9, dtype=torch.bfloat16, device=dev),
                                    randn(3, 16, device=dev), randn(2, 3, 16, 16, device=dev)), {"wkv6": 1}),
    "moe_gating_one_tile": (lambda x: ops.moe_gating(x, top_k=2, capacity=10),
                            lambda dev: (randn(3, 32, 8, device=dev),), {"moe_gating": 1}),
    "moe_gating_tiles": (lambda x: ops.moe_gating(x, top_k=3, capacity=40),
                         lambda dev: (randn(2, 100, 8, device=dev),), {"moe_gating": 1, "moe_gating_slots": 1}),
}


def flat(x):
    return list(x) if isinstance(x, tuple) else [x]


@pytest.mark.parametrize("case", sorted(META_CASES))
def test_meta_route_gives_the_plain_shapes_and_one_kernel_call(case):
    op, inputs, calls = META_CASES[case]
    stats, out = count(op, *inputs("meta"))
    want = flat(op(*inputs("cpu")))
    assert [(o.shape, o.dtype, o.device.type) for o in flat(out)] == [(w.shape, w.dtype, "meta") for w in want]
    assert stats.kernel_calls == calls


def test_meta_route_counts_the_kernels_work():
    q, k, v = attention_case(torch.float32, 128, 128, "meta")
    stats, _ = count(lambda q, k, v: ops.attention(q, k, v, causal=True), q, k, v)
    flops, nbytes, unit = roofline.attention_work(2, 4, 2, 24, 40, 128, 128, torch.float32, True, 0)
    ws = fa.workspace_floats(torch.float32, 2, 2, 40, 128, 128) * 4
    assert stats.flops_by_unit == {unit: flops} and unit == "tf32"
    assert stats.bytes_by_op == {"flash_attention_tf32_d128": nbytes + 2 * ws}
    # the split pass's scratch lives beside the output while the kernel runs
    assert stats.peak_bytes == stats.argument_bytes + 2 * 4 * 24 * 128 * 4 + ws


def test_cpu_tensors_take_the_plain_version():
    q, k, v = attention_case(torch.float32, 64, 64, "cpu")
    stats, out = count(lambda q, k, v: ops.attention(q, k, v), q, k, v)
    assert stats.kernel_calls == {}
    torch.testing.assert_close(out, ref.attention_ref(q, k, v, causal=True), rtol=0, atol=0)


# name: (op, meta inputs the card's wrapper refuses, the refusal)
REFUSED = {
    "attention_head_pair": (lambda q, k, v: ops.attention(q, k, v),
                            lambda: attention_case(torch.float32, 16, 16, "meta"), (ValueError, "head dims")),
    "attention_not_contiguous": (lambda q, k, v: ops.attention(q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3)),
                                 lambda: attention_case(torch.float32, 64, 64, "meta"), (ValueError, "contiguous")),
    "attention_f16": (lambda q, k, v: ops.attention(q, k, v), lambda: attention_case(torch.float16, 64, 64, "meta"),
                      (TypeError, "not in")),
    "rmsnorm_too_wide": (ops.rmsnorm, lambda: (randn(2, 16384, device="meta"), randn(16384, device="meta")),
                         (ValueError, "need D in")),
    "rmsnorm_not_contiguous": (lambda x, w: ops.rmsnorm(x.t(), w), lambda: (randn(64, 8, device="meta"),
                                                                           randn(8, device="meta")),
                               (ValueError, "contiguous")),
    "lru_scan_h0_bf16": (ops.lru_scan, lambda: (randn(2, 9, 16, device="meta"), randn(2, 9, 16, device="meta"),
                                                randn(2, 16, dtype=torch.bfloat16, device="meta")),
                         (TypeError, "h0 must be float32")),
    "wkv6_head_size": (ops.wkv6, lambda: (*(randn(1, 2, 8, 128, device="meta") for _ in range(4)),
                                          randn(2, 128, device="meta"), randn(1, 2, 128, 128, device="meta")),
                       (ValueError, "head size 128")),
    "moe_gating_experts": (lambda x: ops.moe_gating(x, top_k=2, capacity=10),
                           lambda: (randn(1, 8, 400, device="meta"),), (ValueError, "E <= 384")),
    "moe_gating_bf16": (lambda x: ops.moe_gating(x, top_k=2, capacity=10),
                        lambda: (randn(1, 8, 16, dtype=torch.bfloat16, device="meta"),), (TypeError, "float32")),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_meta_route_refuses_what_the_wrapper_refuses(case):
    """The meta route makes the wrapper's device-independent checks: a count
    refuses, as the card would, and records no call."""
    op, inputs, (error, match) = REFUSED[case]
    with pytest.raises(error, match=match):
        count(op, *inputs())


def test_smoke_widths_are_refused_and_kernel_widths_taken():
    """The smoke configs' 16-wide heads are no kernel's: their step does not
    count, as it would not launch; ``kernel_widths`` gives each family's
    smoke config heads the kernel takes and changes nothing else."""
    model = build_model(get_smoke_config("nbi100m"))
    step, args = dryrun.step_and_inputs(model, "prefill", 2, 16)
    with pytest.raises(ValueError, match="head dims"):
        count(step, *args)
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        wide = dryrun.kernel_widths(cfg)
        if cfg.attention == "mla":
            assert (wide.qk_nope_dim + wide.qk_rope_dim, wide.v_head_dim) == fa.MLA_HEAD_DIMS
        elif cfg.family != "rwkv6":
            assert (wide.resolved_head_dim,) * 2 in fa.HEAD_DIM_PAIRS
        assert dryrun.kernel_widths(wide) == wide
        assert wide.replace(head_dim=cfg.head_dim, qk_nope_dim=cfg.qk_nope_dim, qk_rope_dim=cfg.qk_rope_dim,
                            v_head_dim=cfg.v_head_dim) == cfg


def test_meta_gating_under_grad_raises_as_on_the_card():
    x = torch.empty(2, 32, 8, device="meta", requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.moe_gating(x, top_k=2, capacity=10)


# ---------------------------------------------------------------------------
# every family's smoke config, without a mesh and on a fake (2, 2) mesh
# ---------------------------------------------------------------------------


def cpu_calls(monkeypatch) -> dict:
    """Count the ``ops.*`` calls that reach a kernel's place on the CPU, by op."""
    calls = dict.fromkeys(("attention", "rmsnorm", "lru_scan", "wkv6", "moe_gating"), 0)

    def counted(name, fn):
        def run(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)

        return run

    for name, attr in (("attention", "_attention_fwd"), ("rmsnorm", "_rmsnorm_fwd"), ("lru_scan", "_lru_fwd"),
                       ("wkv6", "_wkv6_fwd")):
        monkeypatch.setattr(ops, attr, counted(name, getattr(ops, attr)))
    monkeypatch.setattr(ops.ref, "moe_gating_ref", counted("moe_gating", ref.moe_gating_ref))
    return calls


def products(flops_by_op: dict, kernel_calls: dict) -> float:
    """The FLOPs of the step's matrix products: every counted op but the
    port's kernels."""
    return sum(f for op, f in flops_by_op.items() if op not in kernel_calls)


def by_op(kernel_calls: dict) -> dict:
    """Kernel calls by op: K1's instances summed, the sub-counts (the
    generic RMSNorm path, K5's slots kernel) left out."""
    out = dict.fromkeys(("attention", "rmsnorm", "lru_scan", "wkv6", "moe_gating"), 0)
    for name, n in kernel_calls.items():
        if name.startswith("flash_attention"):
            out["attention"] += n
        elif name in out:
            out[name] += n
    return out


def on_cpu(meta_args, seed: int = 0):
    """Real CPU tensors for a tree of meta ones: int tokens in the vocab, floats
    small."""
    g = torch.Generator().manual_seed(seed)

    def real(t):
        if t.dtype.is_floating_point:
            return (0.02 * torch.randn(t.shape, generator=g)).to(t.dtype)
        return torch.randint(0, 64, t.shape, generator=g).to(t.dtype)

    return map_defs(real, meta_args)


def run_on_cpu(model, kind: str, batch: int, seq: int):
    cfg = model.cfg
    if kind == "train":
        from repro_torch.training import make_train_step

        opt = make_optimizer(cfg.optimizer)
        state = init_train_state(model, opt, torch.Generator().manual_seed(0), "cpu")
        return make_train_step(model, opt)(state, on_cpu(model.train_inputs(batch, seq)))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    if kind == "prefill":
        return model.prefill_fn(params, on_cpu(model.prefill_inputs(batch, seq)))
    cache = map_defs(lambda t: torch.zeros(t.shape, dtype=t.dtype), model.cache_defs_fn(batch, seq))
    tokens = on_cpu(model.decode_inputs(batch))["tokens"]
    return model.decode_fn(params, cache, tokens, seq // 2)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_step_counts_the_cpu_calls_with_and_without_a_mesh(arch, kind, small_shapes, monkeypatch,
                                                                  no_group_before_or_after):
    cfg = dryrun.kernel_widths(get_smoke_config(arch))
    model = build_model(cfg)
    _, seq, batch = SMALL[KIND_SHAPE[kind]]
    step, args = dryrun.step_and_inputs(model, kind, batch, seq)
    plain, _ = count(step, *args)
    assert plain.argument_bytes > 0 and plain.peak_bytes >= max(plain.argument_bytes, plain.output_bytes)
    assert plain.collective_count == 0 and plain.flops > 0
    rec = dryrun.count_cell(arch, KIND_SHAPE[kind], cfg=cfg, spec="data=2,model=2")
    assert RECORD_KEYS <= set(rec) and rec["status"] == "ok" and rec["chips"] == 4
    assert rec["kernel_calls"] == plain.kernel_calls  # each rank runs every op on its shards
    assert rec["collective_wire_bytes_per_device"] > 0
    # each rank's products: at least its quarter, and well under the whole
    # step (a DTensor op counted at its global shapes would give the whole)
    whole = products(plain.flops_by_op, plain.kernel_calls)
    assert whole / 4 <= products(rec["flops_by_op"], rec["kernel_calls"]) <= whole / 2
    calls = cpu_calls(monkeypatch)
    run_on_cpu(model, kind, batch, seq)
    assert by_op(plain.kernel_calls) == calls


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dense_mesh_rank_counts_a_quarter_exactly(kind, small_shapes, no_group_before_or_after):
    """nbi-100m on ("data", "model") = (2, 2): batch split over ``data``,
    heads and the MLP's width over ``model``, so each rank's matrix products
    and attention are a quarter of the step's, and its norms (rows split over
    ``data`` only) a half."""
    cfg = dryrun.kernel_widths(get_smoke_config("nbi100m"))
    _, seq, batch = SMALL[KIND_SHAPE[kind]]
    step, args = dryrun.step_and_inputs(build_model(cfg), kind, batch, seq)
    plain, _ = count(step, *args)
    rec = dryrun.count_cell("nbi100m", KIND_SHAPE[kind], cfg=cfg, spec="data=2,model=2")
    assert products(rec["flops_by_op"], rec["kernel_calls"]) * 4 == products(plain.flops_by_op, plain.kernel_calls)
    for op, flops in plain.flops_by_op.items():
        assert rec["flops_by_op"][op] == flops / (2 if op == "rmsnorm" else 4), op


def test_count_cell_refuses_beside_a_group_and_leaves_none(small_shapes, monkeypatch):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        with pytest.raises(RuntimeError, match="already exists"):
            dryrun.count_cell("nbi100m", "prefill_32k", cfg=get_smoke_config("nbi100m"), spec="data=2,model=2")
    finally:
        dist.destroy_process_group()

    def broken(*args, **kwargs):
        raise ValueError("a step that fails")

    monkeypatch.setattr(dryrun, "count", broken)
    with pytest.raises(ValueError, match="a step that fails"):
        dryrun.count_cell("nbi100m", "prefill_32k", cfg=get_smoke_config("nbi100m"), spec="data=2,model=2")
    assert not dist.is_initialized()


def test_count_cell_frames_and_patches_follow_the_config():
    whisper = build_model(get_smoke_config("whisper_small"))
    llava = build_model(get_smoke_config("llava_next_mistral_7b"))
    assert whisper.train_inputs(2, 16)["frames"].shape == (2, whisper.cfg.enc_len, whisper.cfg.d_model)
    batch = llava.train_inputs(2, 16)
    n = llava.cfg.n_patches
    assert (batch["patches"].shape, batch["tokens"].shape, batch["labels"].shape) == (
        (2, n, llava.cfg.d_model), (2, 16 - n), (2, 16))
    assert batch["patches"].dtype == torch_dtype(llava.cfg.dtype) and batch["tokens"].dtype == torch.int32
    assert set(llava.prefill_inputs(2, 16)) == {"patches", "tokens"}
    dec = llava.decode_inputs(3)
    assert (dec["tokens"].shape, dec["pos"].shape, dec["pos"].dtype) == ((3, 1), (), torch.int32)


def test_main_caches_forces_and_fails(tmp_path, small_shapes, monkeypatch, capsys, no_group_before_or_after):
    monkeypatch.setattr(dryrun, "get_config", lambda arch: dryrun.kernel_widths(get_smoke_config(arch)))
    monkeypatch.setitem(dryrun.MESHES, "single", "data=2,model=2")
    out = tmp_path / "dry"
    argv = ["--arch", "nbi-100m", "--shape", "prefill_32k", "--shape", "long_500k", "--mesh", "single",
            "--out", str(out)]
    assert dryrun.main(argv) == 0
    cell = out / "nbi-100m__prefill_32k__single.json"
    rec = json.loads(cell.read_text())
    assert rec["status"] == "ok" and rec["kernel_calls"] == {"rmsnorm": 5, "flash_attention_tf32": 2}
    skipped = json.loads((out / "nbi-100m__long_500k__single.json").read_text())
    assert skipped["status"] == "skipped" and "500k" in skipped["skip_reason"]
    capsys.readouterr()
    assert dryrun.main(argv) == 0
    assert "[cached] nbi-100m__prefill_32k__single" in capsys.readouterr().out
    assert dryrun.main(argv + ["--force"]) == 0
    assert "[count] nbi-100m__prefill_32k__single" in capsys.readouterr().out

    def broken(*args, **kwargs):
        raise ValueError("a step that fails")

    monkeypatch.setattr(dryrun, "count_cell", broken)
    assert dryrun.main(argv + ["--force"]) == 1
    failed = json.loads(cell.read_text())
    assert failed["status"] == "error" and "a step that fails" in failed["error"]
