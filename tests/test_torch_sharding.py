"""The port's logical-axis sharding (``repro_torch.parallel.sharding``, the
models' logical trees, ``repro_torch.launch.mesh``) against the
reference's, and the kernels' local-shard route, on the CPU.

The rule tables, specs and logical trees must equal the reference's exactly,
for every config of both packages (full and smoke) on duck-typed meshes (the
reference's ``rules_for`` reads only ``axis_names`` and ``devices.shape``, so
no JAX mesh is built and ROADMAP H1 does not apply). The local-shard route
runs on a 1 x 1 mesh over a gloo group of one rank (an in-memory store, made
for this module and destroyed after it).
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro.optim import make_optimizer as jax_make_optimizer
from repro.parallel import sharding as ref
from repro.training.steps import train_state_logical as jax_train_state_logical
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.kernels import ops, ref as plain
from repro_torch.launch.mesh import MeshShape, parse_mesh
from repro_torch.models.common import tree_leaves
from repro_torch.models.registry import build_model
from repro_torch.optim import make_optimizer
from repro_torch.parallel import sharding as port
from repro_torch.training import train_state_logical


class FakeMesh:
    """Duck-typed mesh, as ``tests/test_sharding.py``'s: axis names and
    ``devices.shape`` only."""

    class _Dev:
        def __init__(self, shape):
            self.shape = shape

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = self._Dev(shape)


MESHES = {"16x16": ((16, 16), ("data", "model")), "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "8x1": ((8, 1), ("data", "model")), "1x8": ((1, 8), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")), "1x1": ((1, 1), ("data", "model"))}
BATCHES = (256, 8, 1)
OPTIMIZERS = ("adamw", "adamw8bit", "lion")


@functools.lru_cache(maxsize=None)
def models(arch: str, smoke: bool):
    """(reference model, port model) of a config."""
    jcfg = (jax_get_smoke_config if smoke else jax_get_config)(arch)
    cfg = (get_smoke_config if smoke else get_config)(arch)
    return jax_build_model(jcfg), build_model(cfg)


def test_both_packages_have_the_same_configs():
    assert sorted(ARCHS) == sorted(JAX_ARCHS)


@pytest.mark.parametrize("fsdp", [None, True], ids=["cfg_fsdp", "fsdp"])
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_rules_and_specs_equal_the_reference(arch, smoke, mesh, batch, fsdp):
    jmodel, model = models(arch, smoke)
    fake = FakeMesh(*MESHES[mesh])
    kw = dict(batch_size=batch, extra_dims={"heads": model.cfg.n_heads}, fsdp=fsdp)
    want = ref.rules_for(jmodel.cfg, fake, param_defs=jmodel.param_defs, **kw)
    got = port.rules_for(model.cfg, fake, param_defs=model.param_defs, **kw)
    assert got == want
    assert port.mesh_axis_sizes(fake) == ref.mesh_axis_sizes(fake)
    assert port.dp_axes(fake) == ref.dp_axes(fake)
    logical = [lg for _, lg in tree_leaves(model.param_logical())]
    logical += [lg for _, lg in tree_leaves(model.train_input_logical())]
    for lg in logical:
        assert port.spec_for(lg, got) == tuple(ref.spec_for(lg, want)), lg
    # the same table read through a MeshShape (the sizing's mesh) and a real
    # mesh's attribute names
    shape = MeshShape(*reversed(MESHES[mesh]))
    assert port.rules_for(model.cfg, shape, param_defs=model.param_defs, **kw) == want


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_logical_trees_equal_the_reference(arch, smoke):
    jmodel, model = models(arch, smoke)
    assert model.param_logical() == jmodel.param_logical()
    assert model.train_input_logical() == jmodel.train_input_logical()
    assert model.prefill_input_logical() == jmodel.prefill_input_logical()
    for name in OPTIMIZERS:
        want = jax_train_state_logical(jmodel, jax_make_optimizer(name, lr=1e-3))
        assert train_state_logical(model, make_optimizer(name, lr=1e-3)) == want


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_logical_trees_equal_the_reference(arch, smoke):
    jmodel, model = models(arch, smoke)
    assert model.cache_logical_fn() == jmodel.cache_logical_fn()


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16", "1x8"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_rules_equal_the_reference_engines(arch, mesh):
    """``serve_rules`` at 8 x 1056 gives the reference engines' table
    (``extra_dims={"kv_seq": max_seq, "heads": n_heads}``): every cache dim
    splits where the rules say, so checking them disables nothing here."""
    jmodel, model = models(arch, False)
    fake = FakeMesh(*MESHES[mesh])
    want = ref.rules_for(jmodel.cfg, fake, param_defs=jmodel.param_defs, batch_size=8,
                         extra_dims={"kv_seq": 1056, "heads": jmodel.cfg.n_heads})
    assert port.serve_rules(model, fake, 8, 1056) == want


def test_serve_rules_check_the_cache_dims():
    """Griffin's ring of ``window`` slots: a model axis that does not split
    it turns ``kv_seq`` off, though max_seq splits; a batch of one is whole."""
    _, model = models("recurrentgemma-2b", True)  # window 8
    fake = FakeMesh((1, 16), ("data", "model"))
    assert port.rules_for(model.cfg, fake, param_defs=model.param_defs, batch_size=8,
                          extra_dims={"kv_seq": 64, "heads": model.cfg.n_heads})["kv_seq"] == "model"
    assert port.serve_rules(model, fake, 8, 64)["kv_seq"] is None
    assert port.serve_rules(model, FakeMesh((1, 4), ("data", "model")), 8, 64)["kv_seq"] == "model"
    assert port.serve_rules(model, FakeMesh((1, 4), ("data", "model")), 1, 64)["batch"] is None


@pytest.mark.parametrize("mesh", ["2x16x16", "2x4", "1x8"])
def test_placements_follow_the_specs(mesh):
    fake = FakeMesh(*MESHES[mesh])
    names = MESHES[mesh][1]
    _, model = models("kimi-k2-1t-a32b", False)
    rules = port.rules_for(model.cfg, fake, param_defs=model.param_defs, batch_size=256, fsdp=True)
    for lg in [lg for _, lg in tree_leaves(model.param_logical())] + [("batch", None)]:
        placements = port.placements_for(lg, rules, fake)
        for axis, p in zip(names, placements):
            dims = [d for d, a in enumerate(port.spec_for(lg, rules))
                    if a == axis or (isinstance(a, tuple) and axis in a)]
            assert (p.is_shard() and [p.dim] == dims) or (p.is_replicate() and not dims), (lg, axis, p)


def test_two_dims_on_one_axis_are_refused():
    fake = FakeMesh((2, 4), ("data", "model"))
    with pytest.raises(ValueError, match="two dims"):
        port.placements_for(("heads", "ff"), {"heads": "model", "ff": "model"}, fake)


@pytest.mark.parametrize("spec,world,want", [
    ("data=8,model=8", 64, (("data", "model"), (8, 8))),
    ("model=8", 64, (("data", "model"), (8, 8))),
    ("pod=2,model=4,data=4", 32, (("pod", "data", "model"), (2, 4, 4))),
    ("data=4", None, (("data", "model"), (4, 1))),
])
def test_parse_mesh(spec, world, want):
    shape = parse_mesh(spec, world)
    assert (shape.mesh_dim_names, shape.shape) == want
    assert parse_mesh(shape.spec(), world) == shape


@pytest.mark.parametrize("spec,world", [("data=2,model=2", 8), ("model=3", 8), ("rows=2", 2), ("data=0", 1)])
def test_parse_mesh_refuses(spec, world):
    with pytest.raises(ValueError):
        parse_mesh(spec, world)


def test_local_shapes_split_evenly():
    shape = MeshShape(("pod", "data", "model"), (2, 4, 8))
    placements = port.placements_for(("batch", None, "heads"), {"batch": ("pod", "data"), "heads": "model"}, shape)
    assert port.local_shape((64, 3, 16), placements, shape) == (8, 3, 2)
    with pytest.raises(ValueError, match="split"):
        port.local_shape((12, 3, 16), placements, shape)


# ---------------------------------------------------------------------------
# The kernels' local-shard route, on a 1 x 1 mesh of one gloo rank
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh():
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def placed(t, mesh, *placements):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, mesh, placements, run_check=False)


def draw(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]


def test_route_hands_the_kernels_local_tensors(mesh, monkeypatch):
    """The ops see plain local tensors (never a DTensor), and return the
    plain op's values with the input's placements; gradients flow."""
    from torch.distributed.tensor import Replicate, Shard

    seen = []
    for name in ("attention_ref", "rmsnorm_ref", "moe_gating_ref"):
        fn = getattr(plain, name)
        monkeypatch.setattr(plain, name, lambda *a, _fn=fn, **k: (seen.extend(a), _fn(*a, **k))[1])
    q, k, v = draw((2, 4, 8, 16), (2, 2, 8, 16), (2, 2, 8, 16))
    rows = (Shard(0), Shard(1))
    out = ops.attention(*(placed(t, mesh, *rows) for t in (q, k, v)), causal=True)
    assert tuple(out.placements) == rows and torch.equal(out.to_local(), plain.attention_ref(q, k, v, causal=True))
    x, w = draw((2, 8, 16), (16,))
    xd = placed(x, mesh, Shard(0), Shard(1)).requires_grad_()
    wd = placed(w, mesh, Replicate(), Replicate()).requires_grad_()
    y = ops.rmsnorm(xd, wd)
    assert torch.equal(y.to_local(), plain.rmsnorm_ref(x, w, 1e-6))
    y.sum().backward()
    assert xd.grad is not None and wd.grad is not None
    logits, = draw((4, 8, 16))
    idx, gate, pos = ops.moe_gating(placed(logits, mesh, Shard(0), Replicate()), top_k=2, capacity=4)
    assert torch.equal(idx.to_local(), plain.moe_gating_ref(logits, top_k=2, capacity=4)[0])
    assert seen and not any(ops.is_dtensor(t) for t in seen if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("case", ["attention_head_dim", "attention_seq", "attention_unlike", "rmsnorm_row",
                                  "rmsnorm_weight", "gating_experts", "gating_tokens", "partial"])
def test_route_refuses_a_reduced_dim(mesh, case):
    """A placement on a dim the kernel reduces over (or partial sums) raises:
    nothing is gathered quietly."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    q, k, v = draw((2, 4, 8, 16), (2, 4, 8, 16), (2, 4, 8, 16))
    x, w = draw((2, 8, 16), (16,))
    logits, = draw((4, 8, 16))
    rep = (Replicate(), Replicate())
    calls = {
        "attention_head_dim": lambda: ops.attention(*(placed(t, mesh, Shard(3), Replicate()) for t in (q, k, v))),
        "attention_seq": lambda: ops.attention(*(placed(t, mesh, Replicate(), Shard(2)) for t in (q, k, v))),
        "attention_unlike": lambda: ops.attention(placed(q, mesh, Replicate(), Shard(1)), placed(k, mesh, *rep),
                                                  placed(v, mesh, *rep)),
        "rmsnorm_row": lambda: ops.rmsnorm(placed(x, mesh, Shard(2), Replicate()), placed(w, mesh, *rep)),
        "rmsnorm_weight": lambda: ops.rmsnorm(placed(x, mesh, *rep), placed(w, mesh, Shard(0), Replicate())),
        "gating_experts": lambda: ops.moe_gating(placed(logits, mesh, Replicate(), Shard(2)), top_k=2, capacity=4),
        "gating_tokens": lambda: ops.moe_gating(placed(logits, mesh, Shard(1), Replicate()), top_k=2, capacity=4),
        "partial": lambda: ops.rmsnorm(placed(x, mesh, Partial(), Replicate()), placed(w, mesh, *rep)),
    }
    with pytest.raises(ValueError, match="ops\\.(attention|rmsnorm|moe_gating)"):
        calls[case]()


def recurrence_inputs(op: str):
    """(inputs, their placements on the 1 x 1 mesh: rows and channels or
    heads split, as a mesh step splits them) of ``ops.lru_scan`` / ``ops.wkv6``."""
    from torch.distributed.tensor import Replicate, Shard

    if op == "lru_scan":
        a, b, h0 = draw((2, 9, 8), (2, 9, 8), (2, 8), seed=4)
        ins = {"a": torch.sigmoid(a), "b": b, "h0": h0}
        return ins, {"a": (Shard(0), Shard(2)), "b": (Shard(0), Shard(2)), "h0": (Shard(0), Shard(1))}
    r, k, v, w, u, s0 = draw((2, 4, 16, 8), (2, 4, 16, 8), (2, 4, 16, 8), (2, 4, 16, 8), (4, 8), (2, 4, 8, 8), seed=4)
    ins = {"r": r, "k": k, "v": v, "w": torch.sigmoid(w), "u": u, "s0": s0}
    pl = {n: (Shard(0), Shard(1)) for n in ins}
    pl["u"] = (Replicate(), Shard(0))
    return ins, pl


@pytest.mark.parametrize("op", ["lru_scan", "wkv6"])
def test_recurrence_routes_on_one_rank_are_bitwise(mesh, op):
    """On a mesh of one rank the local-shard route is the plain op: outputs
    and every input's gradient equal bit for bit."""
    ins, pl = recurrence_inputs(op)
    fn = getattr(ops, op)
    leaves = {n: placed(t, mesh, *pl[n]).requires_grad_() for n, t in ins.items()}
    plain = {n: t.clone().requires_grad_() for n, t in ins.items()}
    got, want = fn(*leaves.values()), fn(*plain.values())
    for g, w in zip(got, want):
        assert ops.is_dtensor(g) and torch.equal(g.to_local(), w)
    assert tuple(got[0].placements) == tuple(pl[next(iter(pl))])
    seeds = [torch.ones_like(w) for w in want]
    g_got = torch.autograd.grad(got, list(leaves.values()), [placed(t, mesh, *o.placements)
                                                               for t, o in zip(seeds, got)])
    g_want = torch.autograd.grad(want, list(plain.values()), seeds)
    for name, g, w in zip(ins, g_got, g_want):
        assert torch.equal(g.to_local(), w), name


@pytest.mark.parametrize("op", ["lru_scan", "wkv6"])
def test_recurrence_routes_refuse_a_split_time(mesh, op):
    """T is never split (the ``seq`` rule is off unless ``seq_shard``)."""
    from torch.distributed.tensor import Shard

    ins, pl = recurrence_inputs(op)
    first = next(iter(ins))
    pl[first] = (Shard(1 if op == "lru_scan" else 2), pl[first][1])
    with pytest.raises(ValueError, match=f"ops\\.{op}"):
        getattr(ops, op)(*(placed(t, mesh, *pl[n]) for n, t in ins.items()))


@pytest.mark.parametrize("op", ["lru_scan", "wkv6"])
def test_recurrence_routes_refuse_unlike_splits(mesh, op):
    """Every input split as the first, dim for dim: a state (or bonus) split
    otherwise raises."""
    from torch.distributed.tensor import Replicate

    ins, pl = recurrence_inputs(op)
    last = list(ins)[-1]
    pl[last] = (Replicate(), Replicate())
    with pytest.raises(ValueError, match=f"ops\\.{op}: {last}"):
        getattr(ops, op)(*(placed(t, mesh, *pl[n]) for n, t in ins.items()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 5, "rows"])
def test_split_absorbed_decode_on_one_shard_is_the_plain_function(mesh, dtype, pos):
    """MLA's absorbed decode on a latent cache split over its rows and keys on
    one rank (the split-KV route with no group to reduce over) equals the
    plain function bit for bit, with the queries split over heads."""
    from torch.distributed.tensor import Shard

    from repro_torch.models.transformer import absorbed_attention

    B, H, S, r, rope = 2, 4, 9, 16, 8
    q_abs, q_rope, ckv, krope = (t.to(dtype) for t in draw((B, H, 1, r), (B, H, 1, rope), (B, S, r), (B, S, rope),
                                                             seed=6))
    at = torch.tensor([3, 8]) if pos == "rows" else torch.tensor(pos).expand(B)
    mask = (torch.arange(S)[None, :] <= at[:, None])[:, None, None, :]
    with torch.no_grad():
        got = absorbed_attention(placed(q_abs, mesh, Shard(0), Shard(1)), placed(q_rope, mesh, Shard(0), Shard(1)),
                                 placed(ckv, mesh, Shard(0), Shard(1)), placed(krope, mesh, Shard(0), Shard(1)), mask,
                                 0.2)
    want = absorbed_attention(q_abs, q_rope, ckv, krope, mask, 0.2)
    assert ops.is_dtensor(got) and got.dtype == want.dtype == dtype
    assert torch.equal(got.to_local(), want)


def test_mla_shared_rope_key_on_the_local_heads(mesh):
    """MLA's shared roped key joined to head-split ``k_nope`` on each rank's
    heads: the plain concatenation's values, the heads' placements kept, and
    the shared head's gradient the sum over every head."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.transformer import _with_shared_rope

    k_nope, k_rope = draw((2, 4, 6, 8), (2, 1, 6, 4), seed=7)
    kn = placed(k_nope, mesh, Shard(0), Shard(1)).requires_grad_()
    kr = placed(k_rope, mesh, Shard(0), Replicate()).requires_grad_()
    got = _with_shared_rope(kn, kr)
    plain_kr = k_rope.clone().requires_grad_()
    want = _with_shared_rope(k_nope, plain_kr)
    assert tuple(got.placements) == (Shard(0), Shard(1)) and torch.equal(got.to_local(), want)
    seed, = draw(tuple(want.shape), seed=8)
    got.backward(placed(seed, mesh, Shard(0), Shard(1)))
    want.backward(seed)
    assert torch.equal(kr.grad.full_tensor(), plain_kr.grad)


def test_whisper_cross_decode_on_the_local_heads(mesh):
    """The decode step's cross-attention over a cross cache split over rows
    and heads runs on each rank's heads: the plain values, bit for bit."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.common import attention_single_shot
    from repro_torch.models.whisper import _cross_decode

    q, k, v = draw((2, 4, 1, 8), (2, 4, 10, 8), (2, 4, 10, 8), seed=9)
    with torch.no_grad():
        got = _cross_decode(placed(q, mesh, Shard(0), Replicate()), placed(k, mesh, Shard(0), Shard(1)),
                            placed(v, mesh, Shard(0), Shard(1)))
    assert tuple(got.placements) == (Shard(0), Shard(1))
    assert torch.equal(got.to_local(), attention_single_shot(q, k, v))


def test_visual_prefix_refuses_a_sequence_split_stream(mesh):
    """The patches go before the text on a stream pinned to ("batch", None,
    None); with ``seq_shard`` on (the stream split over its positions) the
    prefix is refused."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models import transformer

    cfg = get_smoke_config("llava-next-mistral-7b").replace(seq_shard=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rules = port.rules_for(model.cfg, mesh, param_defs=model.param_defs, batch_size=2)
    rules["seq"] = "model"  # the rule a model axis wider than one gives seq_shard
    placements = port.resolve_tree(mesh, model.param_logical(), rules)
    tokens = placed(torch.zeros((2, 4), dtype=torch.long), mesh, Shard(0), Replicate())
    patches, = draw((2, cfg.n_patches, cfg.d_model))
    with port.use_rules(rules, mesh), pytest.raises(ValueError, match="seq_shard"):
        transformer.embed_inputs(port.distribute_tree(params, mesh, placements), model.cfg, tokens,
                                 placed(patches, mesh, Shard(0), Replicate()))


# ---------------------------------------------------------------------------
# Sizing a job on a mesh (launch/submit.py, the launcher plugin)
# ---------------------------------------------------------------------------

CALIBRATION = [("nbi-100m", None, 8, 512), ("deepseek-moe-16b", 4, 4, 2048), ("rwkv6-7b", 8, 4, 2048),
               ("recurrentgemma-2b", 14, 2, 2048), ("mistral-large-123b", None, 1, 1024),
               ("minicpm3-4b", 16, 4, 2048), ("llava-next-mistral-7b", 8, 4, 2048), ("whisper-small", None, 8, 448)]


@pytest.mark.parametrize("arch,layers,batch,seq", CALIBRATION)
def test_a_one_by_one_mesh_sizes_as_one_gpu(arch, layers, batch, seq):
    from repro_torch.launch import submit

    cfg = get_config(arch)
    cfg = cfg.replace(n_layers=layers) if layers else cfg
    one = MeshShape(("data", "model"), (1, 1))
    assert submit.train_memory_model(cfg, batch, seq, one) == submit.train_memory_model(cfg, batch, seq)


def test_mistral_large_is_refused_at_8_gpus_and_fits_where_the_refusal_says():
    from repro_torch.launch import submit

    with pytest.raises(submit.DoesNotFit, match=r"gpus=64 with mesh=data=8,model=8") as refused:
        submit.size_train("mistral-large-123b", global_batch=32, seq=1024, steps=10, gpus=8, mesh="data=1,model=8")
    assert "over mesh data=1,model=8" in str(refused.value)
    fit = submit.size_train("mistral-large-123b", global_batch=32, seq=1024, steps=10, gpus=64,
                            mesh="data=8,model=8")
    assert (fit["hosts"], fit["gpus_per_host"], fit["tasks"]) == (8, 8, 64)
    assert fit["bytes_per_gpu"] <= submit.GPU_MEMORY_BYTES
    # each GPU holds 1/64 of the weights, moments and gradients (ZeRO-3 and
    # tensor parallelism): at least an eighth of the 8-GPU figure less
    cfg = get_config("mistral-large-123b")
    eight = submit.train_memory_model(cfg, 32, 1024, MeshShape(("data", "model"), (1, 8)))
    assert fit["bytes_per_gpu"] < eight / 7
    with pytest.raises(ValueError, match="holds 16 ranks"):
        submit.size_train("mistral-large-123b", global_batch=32, seq=1024, steps=10, gpus=64, mesh="data=2,model=8")


SERVE_CALIBRATION = ["nbi-100m", "deepseek-moe-16b", "rwkv6-7b", "recurrentgemma-2b", "kimi-k2-1t-a32b",
                     "mistral-large-123b", "minicpm3-4b", "llava-next-mistral-7b", "whisper-small"]


@pytest.mark.parametrize("arch", SERVE_CALIBRATION)
def test_a_one_by_one_mesh_sizes_serving_as_one_gpu(arch):
    from repro_torch.launch import submit

    cfg = get_config(arch)
    one = MeshShape(("data", "model"), (1, 1))
    assert submit.serve_memory_model(cfg, 8, 1056, one) == submit.serve_memory_model(cfg, 8, 1056)


def serve_cache_bytes(cfg, batch: int, max_seq: int, mesh: MeshShape) -> int:
    """Bytes of one GPU's shards of the decode cache as ``serve_memory_model``
    lays it out: every leaf of ``cache_defs_fn`` by ``cache_logical_fn``
    under the serving rules."""
    import math

    model = build_model(cfg)
    rules = port.serve_rules(model, mesh, batch, max_seq)
    placements = [p for _, p in tree_leaves(port.resolve_tree(mesh, model.cache_logical_fn(), rules))]
    return sum(math.prod(port.local_shape(t.shape, p, mesh)) * t.dtype.itemsize
               for (_, t), p in zip(tree_leaves(model.cache_defs_fn(batch, max_seq)), placements))


@pytest.mark.parametrize("arch", ["minicpm3-4b", "whisper-small"])
def test_serving_counts_each_gpus_cache_shard(arch):
    """The cache layout the serve sizing counts gives each GPU's shards:
    MLA's latents ``ckv`` and ``krope`` over ``kv_seq``; Whisper's
    self-attention K/V over ``kv_seq`` and its cross K/V over ``heads``. A
    1 x 1 mesh holds the whole cache."""
    cfg = get_config(arch)
    B, S, M = 8, 1024, 4
    L, item = cfg.n_layers, torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    if cfg.attention == "mla":
        whole = L * B * S * (cfg.kv_lora_rank + cfg.qk_rope_dim) * item
        split = whole // M
    else:
        H, hd = cfg.n_heads, cfg.resolved_head_dim
        self_kv, cross_kv = 2 * L * B * H * S * hd * item, 2 * L * B * H * cfg.enc_len * hd * item
        whole, split = self_kv + cross_kv, self_kv // M + cross_kv // M
    assert serve_cache_bytes(cfg, B, S, MeshShape(("data", "model"), (1, 1))) == whole
    assert serve_cache_bytes(cfg, B, S, MeshShape(("data", "model"), (1, M))) == split
    # the batch over data divides every leaf
    assert serve_cache_bytes(cfg, B, S, MeshShape(("data", "model"), (2, M))) == split // 2


@pytest.mark.parametrize("arch,batch,max_seq", [("minicpm3-4b", 64, 32768), ("llava-next-mistral-7b", 64, 8192),
                                                ("whisper-small", 1024, 448)])
def test_every_family_is_served_where_the_refusal_says(arch, batch, max_seq):
    """MLA, the visual prefix's backbone and Whisper, too large for one GPU:
    the refusal names the smallest GPU count and mesh that fit, and the
    sizing there fits."""
    import re

    from repro_torch.launch import submit

    with pytest.raises(submit.DoesNotFit, match=r"gpus=\d+ with mesh=") as refused:
        submit.size_serve(arch, batch=batch, max_seq=max_seq)
    gpus, mesh = re.search(r"gpus=(\d+) with mesh=(\S+)", str(refused.value)).groups()
    fit = submit.size_serve(arch, batch=batch, max_seq=max_seq, gpus=int(gpus), mesh=mesh.rstrip(".,;)"))
    assert fit["bytes_per_gpu"] <= submit.GPU_MEMORY_BYTES and fit["tasks"] == int(gpus) > 1


def test_mistral_large_is_served_where_the_refusal_says():
    """245 GB of bf16 weights: refused on one GPU, naming 4 GPUs over
    (1, 4); sized there, each GPU holds a quarter of the weights and the
    cache (its sequence over ``model``)."""
    from repro_torch.launch import submit

    with pytest.raises(submit.DoesNotFit, match=r"gpus=4 with mesh=data=1,model=4"):
        submit.size_serve("mistral-large-123b", batch=8, max_seq=1056)
    fit = submit.size_serve("mistral-large-123b", batch=8, max_seq=1056, gpus=4, mesh="data=1,model=4")
    assert (fit["hosts"], fit["gpus_per_host"], fit["tasks"], fit["mesh"]) == (1, 4, 4, "data=1,model=4")
    assert fit["bytes_per_gpu"] <= submit.GPU_MEMORY_BYTES
    cfg = get_config("mistral-large-123b")
    assert fit["bytes_per_gpu"] < submit.serve_memory_model(cfg, 8, 1056) / 3.5
    with pytest.raises(submit.DoesNotFit, match=r"over mesh data=2,model=1"):
        submit.size_serve("mistral-large-123b", batch=8, max_seq=1056, gpus=2, mesh="data=2,model=1")
    assert submit.size_serve("mistral-large-123b", batch=8, max_seq=1056, gpus=8)["mesh"] == "data=1,model=8"


def test_plugin_passes_the_mesh_to_the_serve_job():
    from repro.core import SimCluster, discover_launchers

    launchers = discover_launchers(str(Path(__file__).resolve().parent.parent / "launchers"))
    job = launchers["torch-serve"](arch="mistral-large-123b", gpus=4, mesh="data=1,model=4", batch=8,
                                   prompt_len=1024, gen_len=32, eco=False, backend=SimCluster())
    command = job.make_command()
    assert command.startswith("srun --kill-on-bad-exit=1 python -m repro_torch.launch.serve")
    assert command.endswith("--mesh data=1,model=4")
    assert job.sizing["gres"] == "gpu:h100:4" and job.opts.ntasks == 4


def test_plugin_passes_the_mesh_to_the_job():
    from repro.core import SimCluster, discover_launchers

    launchers = discover_launchers(str(Path(__file__).resolve().parent.parent / "launchers"))
    job = launchers["torch-train"](arch="mistral-large-123b", gpus=64, mesh="data=8,model=8", global_batch=32,
                                   eco=False, backend=SimCluster())
    command = job.make_command()
    assert command.startswith("srun --kill-on-bad-exit=1 python -m repro_torch.launch.train")
    assert command.endswith("--mesh data=8,model=8")
    assert job.sizing["gres"] == "gpu:h100:8" and job.sizing["hosts"] == 8
