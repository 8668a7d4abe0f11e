"""The rest of the dense family against the JAX package, on the CPU at smoke
size: MLA (``minicpm3-4b``: latent projections, the compressed ``ckv`` /
``krope`` cache and the absorbed-matmul decode) and the visual prefix
(``llava-next-mistral-7b``: seeded patch embeddings before the text).

Weights come from the reference's own init and cross with
``repro_torch.convert.params_from_jax``; tokens and patches come from seeded
numpy generators. The reference is called through its model functions with no
sharding rules (ROADMAP hazard H1); its MLA attention is its XLA
``attention_chunked``, as its own tests run it. Plain prefill and scalar and
vector decode of every dense config (starcoder2-7b and mistral-large-123b
among them) are held in ``tests/test_torch_model.py``, whose parametrisation
covers every dense arch of ``ARCHS``; their forward and loss are held here. Tolerances: f32 1e-4 (as the dense
model tests), bf16 by the bound of :func:`assert_bf16_logits_close`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import assert_bf16_logits_close, bf16_logits

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.launch.serve import pad_cache_to as jax_pad_cache_to
from repro.models import transformer as jtx
from repro.models.registry import build_model as jax_build_model
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.serve import pad_cache_to
from repro_torch.models import common
from repro_torch.models import transformer as tx
from repro_torch.models.registry import build_model

TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 16
ARCHS = ["minicpm3_4b", "llava_next_mistral_7b"]
# the GQA configs this slice adds, held here for what test_torch_model.py
# does not cover: the full forward and the loss with its gradients
GQA_ARCHS = ["starcoder2_7b", "mistral_large_123b"]


@pytest.fixture(scope="module")
def pair():
    """(reference model, reference params, numpy params, port model, port
    params) per arch and remat, built once."""
    built = {}

    def get(arch, remat="none"):
        if (arch, remat) not in built:
            ref_model = jax_build_model(jax_get_smoke_config(arch))
            ref_params = ref_model.init(jax.random.PRNGKey(0))
            np_params = jax.tree_util.tree_map(np.asarray, ref_params)
            model = build_model(get_smoke_config(arch).replace(remat=remat))
            built[arch, remat] = (ref_model, ref_params, np_params, model,
                                  convert.params_from_jax(np_params, device="cpu"))
        return built[arch, remat]

    return get


def inputs(cfg, seed, batch=B, seq=S):
    """Seeded tokens (batch, seq) and, for a visual-prefix config, patches
    (batch, n_patches, d_model), as numpy arrays."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, 512, (batch, seq)).astype(np.int32)}
    if cfg.n_patches:
        out["patches"] = rng.standard_normal((batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def as_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **(tol or TOL))


@pytest.mark.parametrize("arch", ARCHS + GQA_ARCHS)
def test_forward_matches_reference(arch, pair):
    ref_model, ref_params, _, model, params = pair(arch)
    batch = inputs(model.cfg, 1)
    want = jtx.dense_forward(ref_params, ref_model.cfg, jnp.asarray(batch["tokens"]),
                             patches=as_jax(batch).get("patches"))
    got = model.forward_fn(params, torch.from_numpy(batch["tokens"]), patches=as_torch(batch).get("patches"))
    assert got.shape == want.shape == (B, model.cfg.n_patches + S, 512)
    close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_every_cache_leaf_match_reference(arch, pair):
    """Prefill through ``Model.prefill_fn`` (llava with its patches): the last
    logits and each cache leaf, MLA's ``ckv`` (L, B, S, kv_lora_rank) and
    ``krope`` (L, B, S, qk_rope_dim), llava's K/V over patches plus text."""
    ref_model, ref_params, _, model, params = pair(arch)
    batch = inputs(model.cfg, 2)
    want_logits, want_cache = ref_model.prefill_fn(ref_params, as_jax(batch))
    logits, cache = model.prefill_fn(params, as_torch(batch))
    close(logits, want_logits)
    assert set(cache) == set(want_cache)
    cfg, P = model.cfg, model.cfg.n_patches + S
    if cfg.attention == "mla":
        assert set(cache) == {"ckv", "krope"}
        assert cache["ckv"].shape == (cfg.n_layers, B, P, cfg.kv_lora_rank)
        assert cache["krope"].shape == (cfg.n_layers, B, P, cfg.qk_rope_dim)
    else:
        assert cache["k"].shape == (cfg.n_layers, B, cfg.n_kv_heads, P, cfg.resolved_head_dim)
    for name in cache:
        assert cache[name].shape == want_cache[name].shape
        close(cache[name], want_cache[name])


@pytest.mark.parametrize("pos_kind", ["scalar", "vector"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prefill_matches_reference(arch, pos_kind, pair):
    """One decode step after a prefill (llava's over patches plus text), at a
    scalar position and at per-row positions, logits and the written cache."""
    ref_model, ref_params, _, model, params = pair(arch)
    batch = inputs(model.cfg, 3)
    P = model.cfg.n_patches + S
    max_seq = P + 8
    _, ref_cache = ref_model.prefill_fn(ref_params, as_jax(batch))
    ref_cache = jax_pad_cache_to(ref_cache, ref_model.cache_defs_fn(B, max_seq))
    _, cache = model.prefill_fn(params, as_torch(batch))
    cache = pad_cache_to(cache, model.cache_defs_fn(B, max_seq))
    nxt = inputs(model.cfg, 4, seq=1)["tokens"]
    pos = np.array(P, np.int32) if pos_kind == "scalar" else np.array([P, P - 5], np.int32)
    want_logits, want_cache = jax.jit(ref_model.decode_fn)(ref_params, ref_cache, jnp.asarray(nxt), jnp.asarray(pos))
    logits, new_cache = model.decode_fn(params, cache, torch.from_numpy(nxt), torch.from_numpy(pos))
    close(logits, want_logits)
    for name in new_cache:
        close(new_cache[name], want_cache[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_full_forward(arch, pair):
    """The KV-cache law: the decode step at position P equals a full forward
    over the P + 1 inputs (llava: patches, then the text and the new token)."""
    _, _, _, model, params = pair(arch)
    batch = as_torch(inputs(model.cfg, 5, batch=1))
    P = model.cfg.n_patches + S
    last, cache = model.prefill_fn(params, batch)
    cache = pad_cache_to(cache, model.cache_defs_fn(1, P + 8))
    nxt = last[:, -1].argmax(-1)[:, None]
    step, _ = model.decode_fn(params, cache, nxt, P)
    full = model.forward_fn(params, torch.cat([batch["tokens"], nxt], dim=1), patches=batch.get("patches"))
    torch.testing.assert_close(step[:, -1], full[:, -1], **TOL)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-2b"])
def test_forward_fn_takes_patches_only_for_dense(arch):
    """``Model.forward_fn`` passes patches to the dense forward (the tests
    above); a family without a visual prefix refuses them."""
    model = build_model(get_smoke_config(arch))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    assert model.forward_fn(params, tokens).shape[:2] == (1, 4)
    with pytest.raises(ValueError, match="visual prefix"):
        model.forward_fn(params, tokens, patches=torch.zeros((1, 2, model.cfg.d_model)))


def test_mla_vector_pos_equals_per_row_scalar(pair):
    """The reference's vector-pos law on minicpm3 (tests/test_serve.py:169):
    each row of a vector-pos step equals that row alone at its scalar pos."""
    _, _, _, model, params = pair("minicpm3_4b")
    rows, seq = 3, 24
    gen = torch.Generator().manual_seed(1)
    cache = {k: torch.randn(d.shape, generator=gen) for k, d in model.cache_defs_fn(rows, seq).items()}
    tok = torch.randint(0, 512, (rows, 1), generator=gen)
    posv = torch.tensor([2, 7, 11])
    lm, _ = model.decode_fn(params, {k: v.clone() for k, v in cache.items()}, tok, posv)
    for b in range(rows):
        one = {k: v[:, b : b + 1].clone() for k, v in cache.items()}
        lb, _ = model.decode_fn(params, one, tok[b : b + 1], int(posv[b]))
        torch.testing.assert_close(lm[b], lb[0], atol=2e-5, rtol=0)


def lm_batch(cfg, seed):
    """Tokens (and patches), labels over patches plus text: -100 on the
    patches and the last position, the next token elsewhere."""
    batch = inputs(cfg, seed)
    toks = batch["tokens"]
    text = np.concatenate([toks[:, 1:], np.full((B, 1), -100, np.int32)], axis=1)
    batch["labels"] = np.concatenate([np.full((B, cfg.n_patches), -100, np.int32), text], axis=1)
    return batch


@pytest.mark.parametrize("arch,remat", [("minicpm3_4b", "none"), ("minicpm3_4b", "full"),
                                        ("llava_next_mistral_7b", "none"), *((a, "none") for a in GQA_ARCHS)])
def test_loss_and_every_grad_match_reference(arch, remat, pair):
    """``Model.loss_fn`` (``dense_loss``, llava reading ``batch["patches"]``)
    and the gradient of every leaf, MLA's latent projections and norms
    included, against ``jax.value_and_grad`` of the reference's loss."""
    ref_model, ref_params, np_params, model, _ = pair(arch, remat)
    batch = lm_batch(model.cfg, 6)
    (jloss, jmetrics), jgrads = jax.value_and_grad(ref_model.loss_fn, has_aux=True)(ref_params, as_jax(batch))
    params = common.map_defs(lambda p: p.requires_grad_(), convert.params_from_jax(np_params, device="cpu"))
    loss, metrics = model.loss_fn(params, as_torch(batch))
    leaves = common.tree_leaves(params)
    grads = dict(zip([path for path, _ in leaves], torch.autograd.grad(loss, [p for _, p in leaves])))
    close(loss, jloss)
    for k in jmetrics:
        close(metrics[k], jmetrics[k])
    want = dict(common.tree_leaves(jax.tree_util.tree_map(np.asarray, jgrads)))
    assert sorted(grads) == sorted(want)
    if arch == "minicpm3_4b":
        assert {f"['blocks']['attn']['{n}']" for n in ("wdq", "q_ln", "wuq", "wdkv", "kv_ln", "wukv", "wkr")} <= set(want)
    for path in want:
        close(grads[path], want[path])


# MLA stages: norm, wdq, q_ln, wuq, wdkv, kv_ln, wukv, wkr, RoPE, attention,
# out projection, residual, norm, gate and up, SiLU product, down, residual
MLA_BF16_STAGES = 17


def test_mla_bf16_matches_reference():
    """minicpm3 in bf16: prefill and greedy decode steps. The reference's MLA
    prefill runs ``attention_chunked`` (q times the bf16-rounded scale, p cast
    to bf16) where the port's follows the flash kernel (f32 scale, p in f32),
    ROADMAP H8; both sit inside the bf16 rounding bound."""
    cfg, steps = bf16_logits("minicpm3_4b")
    assert_bf16_logits_close(cfg, steps, MLA_BF16_STAGES)


@pytest.mark.parametrize("layout", ["kv_heads", "latent"])
def test_scatter_seq_vector_pos_matches_reference(layout):
    """``scatter_seq`` at per-row positions on the GQA cache's (B, H, S, d)
    and MLA's (B, S, r), against the reference's one-hot form; a scalar
    position writes every row there."""
    rng = np.random.default_rng(9)
    shape, upd = (((3, 2, 10, 4), (3, 2, 1, 4)) if layout == "kv_heads" else ((3, 10, 5), (3, 1, 5)))
    buf, update = rng.standard_normal(shape).astype(np.float32), rng.standard_normal(upd).astype(np.float32)
    for pos in (np.array([0, 9, 4]), np.array(6)):
        want = jtx.scatter_seq(jnp.asarray(buf), jnp.asarray(update), jnp.asarray(pos))
        got = tx.scatter_seq(torch.from_numpy(buf.copy()), torch.from_numpy(update), torch.from_numpy(pos))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["starcoder2_7b", "llava_next_mistral_7b", "minicpm3_4b", "mistral_large_123b"])
def test_full_configs_build_with_the_reference_param_count(arch):
    """Every new dense config builds at full width (no storage: the defs
    only) with the reference's parameter count, MLA's latent leaves under
    the reference's names, and the cache layout the reference declares."""
    cfg = get_config(arch)
    model = build_model(cfg)
    n = sum(int(np.prod(d.shape)) for _, d in common.tree_leaves(model.param_defs))
    ref_model = jax_build_model(jax_get_config(arch))
    assert n == sum(int(np.prod(d.shape)) for d in jax.tree_util.tree_leaves(
        ref_model.param_defs, is_leaf=lambda x: hasattr(x, "logical")))
    want_cache = ref_model.cache_defs_fn(2, 64)
    got_cache = model.cache_defs_fn(2, 64)
    assert {k: tuple(v.shape) for k, v in got_cache.items()} == {k: tuple(v.shape) for k, v in want_cache.items()}
    if cfg.attention == "mla":
        assert set(model.param_defs["blocks"]["attn"]) == {"wdq", "q_ln", "wuq", "wdkv", "kv_ln", "wukv", "wkr", "wo"}


def import_chip_smoke():
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parent.parent)
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


def count_train_calls(chip_smoke, cfg, batch, seq, monkeypatch, steps=2) -> dict:
    """Calls a ``steps``-step train run of ``cfg`` on the CPU makes to the
    attention and RMSNorm kernels' forwards (``ops._attention_fwd``,
    ``ops._rmsnorm_fwd``), ``batch`` rows of ``seq`` tokens (behind seeded
    patches for a visual-prefix config, :func:`chip_smoke.add_patches`)."""
    from repro_torch.kernels import ops
    from repro_torch.optim import make_optimizer
    from repro_torch.training import init_train_state, make_train_step

    calls = {"attention": 0, "rmsnorm": 0}
    for name, fn in (("attention", ops._attention_fwd), ("rmsnorm", ops._rmsnorm_fwd)):
        monkeypatch.setattr(ops, f"_{name}_fwd", lambda *a, _n=name, _f=fn: (calls.__setitem__(_n, calls[_n] + 1),
                                                                              _f(*a))[1])
    model = build_model(cfg)
    opt = make_optimizer(cfg.optimizer, lr=1e-3)
    g = torch.Generator().manual_seed(0)
    data = [{"tokens": torch.randint(0, cfg.vocab_size, (batch, seq), generator=g)}]
    data[0]["labels"] = data[0]["tokens"].roll(-1, 1)
    chip_smoke.add_patches(cfg, data, torch.device("cpu"))
    state = init_train_state(model, opt, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(model, opt)
    for _ in range(steps):
        state, _ = step(state, data[0])
    return calls


@pytest.mark.parametrize("arch", ["minicpm3-4b", "llava-next-mistral-7b"])
def test_chip_smoke_counts_the_mesh_legs_train_launches(arch, monkeypatch):
    """``chip_smoke.py``'s exact train counts for the mesh leg's MLA and
    visual-prefix models (remat ``full``: every forward kernel twice a step;
    MLA's 4 norms a layer, q_ln and kv_ln included) equal the calls a train
    step on the CPU makes to the kernels' forwards (at the CPU rehearsal's
    smoke size; the counts depend on the layers, not the widths)."""
    chip_smoke = import_chip_smoke()
    cfg = chip_smoke.wide_config(arch, False, False).replace(dtype="float32")
    batch, seq = 2, 16
    calls = count_train_calls(chip_smoke, cfg, batch, seq, monkeypatch)
    want = chip_smoke.expected_train_launches(cfg, batch, seq, steps=2)
    assert cfg.remat == "full" and want.pop(chip_smoke.attention_counter(cfg)) == calls["attention"] > 0
    assert want.pop("rmsnorm") == calls["rmsnorm"] and not any(want.values())


@pytest.mark.parametrize("arch", ["minicpm3-4b", "llava-next-mistral-7b"])
def test_chip_smoke_counts_the_family_train_launches(arch, monkeypatch):
    """Phase 5's exact counts for the MLA and visual-prefix train paths at
    ``TRAIN_FAMILIES``' depths (remat ``full``): K1 2L a step through the
    full config's kernel (bf16 (96, 64) for MLA, bf16 d 128 for llava), K2
    (8L + 1) and (4L + 1), nothing else; equal to the calls a train step on
    the CPU makes at that depth (smoke widths: the counts depend on the
    layers, not the widths). Then the small models of the card-against-CPU
    step (``TRAIN_SMALL_MODELS``), counted on ``meta`` as the card's
    ``hold_count`` counts them: the f32 MLA one through K1's f32 (96, 64)
    kernel, forward and recompute, the llava one with its patches."""
    from repro_torch.analysis.opstats import count
    from repro_torch.launch import dryrun

    chip_smoke = import_chip_smoke()
    layers, _, _ = chip_smoke.TRAIN_FAMILIES[arch]
    full = get_config(arch).replace(n_layers=layers)
    kernel = "flash_attention_bf16_mla" if arch == "minicpm3-4b" else "flash_attention_bf16"
    norms = 8 if arch == "minicpm3-4b" else 4
    want = dict.fromkeys(chip_smoke.COUNTERS, 0)
    want.update({kernel: 2 * layers, "rmsnorm": norms * layers + 1})
    assert full.remat == "full" and chip_smoke.attention_counter(full) == kernel
    assert chip_smoke.expected_train_launches(full, 4, 2048, 1) == want
    cfg = get_smoke_config(arch).replace(n_layers=layers, remat=full.remat)
    calls = count_train_calls(chip_smoke, cfg, 2, 16, monkeypatch, steps=1)
    assert calls == {"attention": 2 * layers, "rmsnorm": norms * layers + 1}

    overrides, (batch, seq) = chip_smoke.TRAIN_SMALL_MODELS[arch]
    small = get_smoke_config(arch).replace(**overrides)
    step, args = dryrun.step_and_inputs(build_model(small), "train", batch, seq + small.n_patches)
    stats, _ = count(step, *args)
    small_want = {k: n for k, n in chip_smoke.expected_train_launches(small, batch, seq, 1).items() if n}
    assert stats.kernel_calls == small_want
    if arch == "minicpm3-4b":
        assert small.dtype == "float32" and chip_smoke.attention_counter(small) == "flash_attention_tf32_mla"
        assert stats.kernel_calls["flash_attention_tf32_mla"] == 2 * small.n_layers > 0


# the train paths' exact counts a step at full width: path: (batch, seq, K1's
# count, K1, K2, K5 routings, K5 routings through the slots kernel). Remat
# "full" and "selective" run every forward kernel twice (the forward, then
# the recompute); mistral-large-123b's step runs its 8 microbatches' forwards
NEW_TRAIN_PATHS = {
    "deepseek-moe-16b-mla": (4, 2048, "flash_attention_bf16_mla", 2 * 4, 8 * 4 + 1, 2 * 3, 2 * 3),
    "starcoder2-7b": (4, 2048, "flash_attention_bf16", 2 * 5, 4 * 5 + 1, 0, 0),
    "codeqwen1.5-7b": (4, 2048, "flash_attention_bf16", 2 * 6, 4 * 6 + 1, 0, 0),
    "mistral-large-123b": (8, 2048, "flash_attention_bf16", 8 * 2 * 1, 8 * (4 * 1 + 1), 0, 0),
}


@pytest.mark.parametrize("name", sorted(NEW_TRAIN_PATHS))
def test_chip_smoke_counts_the_moe_mla_and_dense_train_launches(name, monkeypatch):
    """Phase 5's exact counts for MoE with MLA (``chip_smoke.MOE_MLA``) and
    the three dense configs, at ``TRAIN_FAMILIES``' depths and their full
    configs' remat and microbatches (mistral-large-123b: "selective", 8),
    equal the calls a train step on the CPU makes to the kernels' forwards
    (K1, K2 and K5's routings) at smoke widths (the counts depend on the
    layers, the remat and the microbatches, not the widths). Then the small
    models of the card-against-CPU step, counted on ``meta`` as the card's
    ``hold_count`` counts them: the MoE one through K1's f32 (96, 64)
    kernel, the mistral-large one under "selective" over 2 microbatches."""
    from repro_torch.analysis.opstats import count
    from repro_torch.launch import dryrun
    from repro_torch.models import moe

    chip_smoke = import_chip_smoke()
    batch, seq, kernel, k1, k2, routings, slots = NEW_TRAIN_PATHS[name]
    full = chip_smoke.train_config(name, True)
    assert chip_smoke.TRAIN_FAMILIES[name][1:] == (batch, seq) and full.name == name
    want = dict.fromkeys(chip_smoke.COUNTERS, 0)
    want.update({kernel: k1, "rmsnorm": k2, "moe_gating": routings, "moe_gating_slots": slots})
    assert chip_smoke.attention_counter(full) == kernel
    assert chip_smoke.expected_train_launches(full, batch, seq, 1) == want

    _, _, smoke = chip_smoke.TRAIN_VARIANTS.get(name, (None, None, {}))
    cfg = get_smoke_config(chip_smoke.train_arch(name)).replace(
        n_layers=full.n_layers, remat=full.remat, microbatch=full.microbatch, **smoke)
    assert (cfg.remat, cfg.microbatch) == ((("selective", 8) if name == "mistral-large-123b" else ("full", 1)))
    routed = []
    real = moe.ops.moe_gating
    monkeypatch.setattr(moe.ops, "moe_gating", lambda *a, **kw: routed.append(1) or real(*a, **kw))
    calls = count_train_calls(chip_smoke, cfg, 8, 16, monkeypatch, steps=1)
    assert calls == {"attention": k1, "rmsnorm": k2} and len(routed) == routings

    overrides, (b, s) = chip_smoke.TRAIN_SMALL_MODELS[name]
    small = get_smoke_config(chip_smoke.train_arch(name)).replace(**overrides)
    step, args = dryrun.step_and_inputs(build_model(small), "train", b, s)
    stats, _ = count(step, *args)
    small_want = {k: n for k, n in chip_smoke.expected_train_launches(small, b, s, 1).items() if n}
    assert stats.kernel_calls == small_want
    assert small.dtype == "float32" and small.remat == ("selective" if name == "mistral-large-123b" else "full")
    if name == chip_smoke.MOE_MLA:
        assert small.attention == "mla" and chip_smoke.attention_counter(small) == "flash_attention_tf32_mla"
        assert stats.kernel_calls["moe_gating"] == 2 * (small.n_layers - small.n_dense_layers) > 0
    if name == "mistral-large-123b":
        assert small.microbatch == 2 and stats.kernel_calls["rmsnorm"] == 2 * (2 * 2 * small.n_layers + 1)


def test_selective_remat_saves_only_products_without_batch_dims():
    """Under remat "selective" the port saves every ``mm``, ``bmm`` and
    ``addmm`` output (``transformer._MATMULS``); the reference's policy,
    ``dots_with_no_batch_dims_saveable``, saves the dots without batch
    dimensions. Every product of mistral-large-123b's layer forward at full
    width (its attention's in the kernel) is an einsum that reaches
    ``bmm`` with a batch of 1: a dot with no batch dimension, so both
    policies save the same products."""
    from torch.utils._python_dispatch import TorchDispatchMode

    products = []

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in tx._MATMULS or func in (torch.ops.aten.matmul.default, torch.ops.aten.baddbmm.default):
                products.append((func, tuple(args[0].shape)))
            return func(*args, **(kwargs or {}))

    cfg = get_config("mistral-large-123b").replace(n_layers=1)
    assert cfg.remat == "selective"
    model = build_model(cfg)
    with Log():
        model.forward_fn(model.abstract_params(), torch.empty((1, 2048), dtype=torch.int32, device="meta"))
    # q, k, v, o, the SwiGLU's three, the unembedding
    assert len(products) == 8
    assert all(func == torch.ops.aten.bmm.default and shape[0] == 1 for func, shape in products)
