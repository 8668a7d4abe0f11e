"""The engines' decode graph (``launch/serve.py``'s ``_DecodeGraph``, the
counterpart of the reference's ``jax.jit`` over its decode step) on the CPU,
where the same static cache, token and position buffers and the same
copy-in run and the step is called eagerly (the capture itself needs the
card: the ``gpu`` test at the end).

Each family the reference serves runs two batches through one port engine,
the longer prompt first, against the reference's jitted greedy loop over its
``prefill_fn`` / ``decode_fn`` with the same weights (its mesh-built engine
fails under this JAX version, ROADMAP H1): state left in the static cache by
one batch would change the next batch's tokens (Griffin's ring positions,
the recurrent states). JAX is imported in a fixture, so that the card's
machine, which has no JAX, can run the ``gpu`` test of this file
(``python -m pytest -m gpu tests/test_torch_decode_graph.py``).
"""

import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch.serve import ContinuousBatchingEngine, ServeEngine, fill_cache, pad_cache_to
from repro_torch.models.common import map_defs, tree_leaves
from repro_torch.models.registry import build_model

# every family the reference serves: dense GQA, MLA, MoE (E 64 and E 384),
# Griffin, RWKV-6, Whisper fed zero frames
FAMILIES = ["nbi100m", "codeqwen15_7b", "minicpm3_4b", "deepseek_moe_16b", "kimi_k2_1t_a32b", "recurrentgemma_2b",
            "rwkv6_7b", "whisper_small"]
# two batches of 2 rows, the longer prompt first: 12 tokens wrap Griffin's
# 8-slot ring, 5 leave 3 of its slots empty (position -1); 2 x 12 and 2 x 5
# tokens are one MoE routing group each (groups of 32)
B, LENGTHS, GEN, MAX_SEQ = 2, (12, 5), 6, 24


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_get_smoke_config
    from repro.launch.serve import pad_cache_to as jax_pad_cache_to
    from repro.models.registry import build_model as jax_build_model

    return types.SimpleNamespace(jax=jax, jnp=jnp, get_smoke_config=jax_get_smoke_config, build_model=jax_build_model,
                                 pad_cache_to=jax_pad_cache_to)


def with_reference_weights(jx, arch, engine_cls, **kw):
    """(a port engine on the CPU carrying the reference's weights, reference
    model, reference params)."""
    ref_model = jx.build_model(jx.get_smoke_config(arch))
    ref_params = ref_model.init(jx.jax.random.PRNGKey(0))
    engine = engine_cls(get_smoke_config(arch), device="cpu", **kw)
    engine.params = convert.params_from_jax(jx.jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    return engine, ref_model, ref_params


def reference_greedy(jx, model, params, prompts, gen_len, max_seq):
    """The reference engine's greedy loop, jitted, without its mesh (an
    encoder-decoder fed zero frames, as the reference's engine feeds them)."""
    prefill, decode = jx.jax.jit(model.prefill_fn), jx.jax.jit(model.decode_fn)
    Bn, P = prompts.shape
    batch = {"tokens": jx.jnp.asarray(prompts)}
    if model.cfg.family == "encdec":
        batch["frames"] = jx.jnp.zeros((Bn, model.cfg.enc_len, model.cfg.d_model), jx.jnp.float32)
    logits, cache = prefill(params, batch)
    cache = jx.pad_cache_to(cache, model.cache_defs_fn(Bn, max_seq))
    out = np.zeros((Bn, gen_len), np.int32)
    for i in range(gen_len):
        out[:, i] = np.asarray(jx.jnp.argmax(logits[:, -1], axis=-1))
        logits, cache = decode(params, cache, jx.jnp.asarray(out[:, i : i + 1]), jx.jnp.asarray(P + i, jx.jnp.int32))
    return out


def storages(engine) -> list:
    """The addresses of the engine's static buffers."""
    graph = engine._graph
    return [leaf.data_ptr() for _, leaf in tree_leaves(graph.cache)] + [graph.tokens.data_ptr(), graph.pos.data_ptr()]


def prefill_inputs(cfg, prompts) -> dict:
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.long)}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((prompts.shape[0], cfg.enc_len, cfg.d_model))
    return batch


@pytest.mark.parametrize("arch", FAMILIES)
def test_two_batches_through_the_static_cache_match_the_reference(arch, jx):
    """Each batch's greedy tokens equal the reference's, the second batch
    (shorter) after the first has filled the static cache; the buffers keep
    their addresses, and on the CPU no step replays."""
    engine, ref_model, ref_params = with_reference_weights(jx, arch, ServeEngine, batch=B, max_seq=MAX_SEQ)
    addresses = storages(engine)
    rng = np.random.default_rng(5)
    for n in LENGTHS:
        prompts = rng.integers(0, 512, (B, n)).astype(np.int32)
        got = engine.generate_batch(prompts, gen_len=GEN)
        np.testing.assert_array_equal(got, reference_greedy(jx, ref_model, ref_params, prompts, GEN, MAX_SEQ))
    assert storages(engine) == addresses
    assert engine.stats["decode_steps"] == GEN * len(LENGTHS) and engine.stats["decode_replays"] == 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_at_a_tensor_position_equals_the_int(arch):
    """A decode step at a 0-dim long ``pos`` tensor (what the graph feeds)
    equals the step at the Python int, bit for bit: logits and every cache
    leaf."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    prompts = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, LENGTHS[0])).astype(np.int32)
    with torch.inference_mode():
        _, cache = model.prefill_fn(params, prefill_inputs(cfg, prompts))
        caches = [pad_cache_to(cache, model.cache_defs_fn(B, MAX_SEQ)) for _ in range(2)]
        caches[1] = map_defs(torch.clone, caches[1])
        tok = torch.tensor([[3], [7]])
        at_int, cache_int = model.decode_fn(params, caches[0], tok, LENGTHS[0])
        at_tensor, cache_tensor = model.decode_fn(params, caches[1], tok, torch.tensor(LENGTHS[0]))
    assert torch.equal(at_int, at_tensor)
    for (path, a), (_, b) in zip(tree_leaves(cache_int), tree_leaves(cache_tensor)):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("arch", ["codeqwen15_7b", "minicpm3_4b"])
def test_two_continuous_serves_equal_each_other_and_full_recompute(arch, jx):
    """Two ``serve()`` calls on one engine, the second with the requests in
    reverse order (other slots, other neighbours, the static cache zeroed
    between): each request's tokens equal across the calls and equal greedy
    full recompute through the reference's prefill."""
    cb, ref_model, ref_params = with_reference_weights(jx, arch, ContinuousBatchingEngine, batch=B, max_seq=32)
    rng = np.random.default_rng(7)
    reqs = [rng.integers(0, 512, size=n).astype(np.int32) for n in (11, 4, 8, 12, 6)]
    addresses = storages(cb)
    first = cb.serve(reqs, gen_len=4)
    second = cb.serve(reqs[::-1], gen_len=4)[::-1]
    assert storages(cb) == addresses and cb.stats["decode_replays"] == 0
    prefill = jx.jax.jit(ref_model.prefill_fn)
    for i, req in enumerate(reqs):
        toks, want = jx.jnp.asarray(req[None]), []
        for _ in range(4):
            want.append(int(jx.jnp.argmax(prefill(ref_params, {"tokens": toks})[0][0, -1])))
            toks = jx.jnp.concatenate([toks, jx.jnp.full((1, 1), want[-1], jx.jnp.int32)], axis=1)
        assert first[i].tolist() == want and second[i].tolist() == want, i


@pytest.mark.parametrize("arch", FAMILIES)
def test_fill_cache_rewrites_every_element(arch):
    """A static cache holding garbage (NaN, or 99 in integer leaves) takes a
    prefill cache to exactly :func:`pad_cache_to`'s fresh padded cache:
    zeros past the prompt, Griffin's ring positions -1 in its empty slots."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1), "cpu")
    prompts = np.random.default_rng(8).integers(0, cfg.vocab_size, (B, LENGTHS[1])).astype(np.int32)
    defs = model.cache_defs_fn(B, MAX_SEQ)
    static = map_defs(lambda d: torch.full(d.shape, float("nan") if d.dtype.is_floating_point else 99, dtype=d.dtype),
                      defs)
    with torch.inference_mode():
        _, cache = model.prefill_fn(params, prefill_inputs(cfg, prompts))
        fill_cache(static, cache)
        want = pad_cache_to(cache, defs)
    for (path, got), (_, w) in zip(tree_leaves(static), tree_leaves(want)):
        assert got.dtype == w.dtype and torch.equal(got, w), path
    if cfg.family == "rglru":
        assert (static["attn"]["pos"] == -1).sum() == static["attn"]["pos"].shape[0] * (cfg.window - LENGTHS[1])


def test_fill_cache_refuses_other_layouts():
    model = build_model(get_smoke_config("codeqwen1.5-7b"))
    static = map_defs(lambda d: torch.zeros(d.shape, dtype=d.dtype), model.cache_defs_fn(1, 8))
    big = map_defs(lambda d: torch.ones(d.shape, dtype=d.dtype), model.cache_defs_fn(1, 16))
    with pytest.raises(ValueError, match="exceeds"):
        fill_cache(static, big)
    with pytest.raises(ValueError, match="keys"):
        fill_cache(static, {"k": big["k"]})


def test_the_graph_steps_only_its_own_buffers():
    """The graph's call takes ``decode_fn``'s arguments, and only its own
    static cache, tokens and position: the step writes the static cache at
    the position in its buffer."""
    engine = ServeEngine(get_smoke_config("nbi100m"), batch=B, max_seq=16, device="cpu")
    graph = engine._graph
    with torch.inference_mode():
        for args in ((map_defs(torch.clone, graph.cache), graph.tokens, graph.pos),
                     (graph.cache, graph.tokens.clone(), graph.pos), (graph.cache, graph.tokens, 3)):
            with pytest.raises(ValueError, match="its own static cache"):
                graph(engine.params, *args)
        graph.tokens.copy_(torch.tensor([[1], [2]]))
        graph.pos.fill_(3)
        logits, cache = graph(engine.params, graph.cache, graph.tokens, graph.pos)
    assert cache is graph.cache and logits.shape == (B, 1, engine.model.cfg.vocab_size) and graph.replays == 0
    assert graph.cache["k"][:, :, :, 3].any() and not graph.cache["k"][:, :, :, 4:].any()


def test_launch_counts_name_every_wrapper_count():
    """:func:`ops.launch_counts` reads every count ``chip_smoke.py`` reads,
    and :func:`ops.add_launch_counts` adds (and takes back) a capture's."""
    counts = ops.launch_counts()
    names = {(module.__name__.rsplit(".", 1)[1], name) for module, name in counts}
    assert {("rmsnorm", "launches"), ("rmsnorm", "generic_launches"), ("moe_gating", "launches"),
            ("moe_gating", "slots_launches"), ("rglru_scan", "launches"), ("rwkv6_scan", "launches"),
            ("flash_attention", "bf16_launches"), ("flash_attention", "tf32_d256_launches")} <= names
    assert len(counts) == 14
    key = next(k for k in counts if k[0].__name__.endswith("rmsnorm") and k[1] == "launches")
    ops.add_launch_counts({key: 5}, 3)
    assert ops.launch_counts()[key] == counts[key] + 15
    ops.add_launch_counts({key: 5}, -3)
    assert ops.launch_counts() == counts


# smoke configs at the kernels' head widths (the card's wrappers refuse the
# smoke configs' 16-wide heads): K1 f32 (64, 64) and (128, 128), K2, K5 at E 64
CARD_WIDTHS = {
    "nbi100m": dict(n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64, d_ff=256),
    "deepseek_moe_16b": dict(d_model=128, n_heads=2, n_kv_heads=2, head_dim=128, d_ff=256, moe_d_ff=64,
                             n_experts=64, top_k=6, moe_group_tokens=32),
}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", sorted(CARD_WIDTHS))
def test_replay_equals_eager_on_the_card(arch):
    """On the card a warmed engine decodes by replay only, and its greedy
    tokens and every step's logits equal an eager loop's over the model's
    functions with the same weights, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch).replace(**CARD_WIDTHS[arch])
    engine = ServeEngine(cfg, batch=B, max_seq=32, device="cuda")
    prompts = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, 16)).astype(np.int32)
    engine.generate_batch(prompts, gen_len=2)  # the warm-up step and the capture
    seen, decode = [], engine._decode

    def record(*args):
        logits, cache = decode(*args)
        seen.append(logits.clone())
        return logits, cache

    engine._decode = record
    engine.stats.update(decode_steps=0, decode_replays=0)
    got = engine.generate_batch(prompts, gen_len=GEN)
    assert engine.stats["decode_steps"] == GEN and engine.stats["decode_replays"] == GEN
    model, params = engine.model, engine.params
    with torch.inference_mode():
        logits, cache = model.prefill_fn(params, {"tokens": torch.as_tensor(prompts, dtype=torch.long, device="cuda")})
        cache = pad_cache_to(cache, model.cache_defs_fn(B, 32))
        want, eager = np.zeros((B, GEN), np.int32), []
        for i in range(GEN):
            want[:, i] = logits[:, -1].argmax(-1).cpu().numpy()
            logits, cache = model.decode_fn(params, cache, torch.as_tensor(want[:, i : i + 1], device="cuda").long(),
                                            16 + i)
            eager.append(logits)
    np.testing.assert_array_equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(seen, eager))
