"""The port's dense model against the JAX package, on the CPU at smoke size.

Weights come from the reference's own init and cross with
``repro_torch.convert.params_from_jax``; tokens come from a seeded numpy
generator. The reference is called through ``build_model(cfg).prefill_fn`` /
``decode_fn`` directly, with no sharding rules: its mesh-built paths fail under
this JAX version (ROADMAP hazard H1). Tolerance: atol 1e-4 / rtol 1e-4 (f32,
different summation orders).

bf16, the dtype of every served full config, is held to a bound derived from
bf16 rounding (see :func:`assert_bf16_logits_close`); decode attention in bf16
at head dim 128 is held op by op to one output rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.launch.serve import pad_cache_to as jax_pad_cache_to
from repro.models import common as jcommon
from repro.models.registry import build_model as jax_build_model
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.launch.serve import pad_cache_to
from repro_torch.models import common
from repro_torch.models import transformer as tx
from repro_torch.models.registry import build_model

TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 16
DENSE = [a for a in ARCHS if get_smoke_config(a).family == "dense"]


@pytest.fixture(scope="module")
def pair():
    """(reference model, reference params, port model, port params) per arch
    and use_pallas, built once."""
    built = {}

    def get(arch, use_pallas=False):
        if (arch, use_pallas) not in built:
            ref_model = jax_build_model(jax_get_smoke_config(arch).replace(use_pallas=use_pallas))
            ref_params = ref_model.init(jax.random.PRNGKey(0))
            np_params = jax.tree_util.tree_map(np.asarray, ref_params)
            model = build_model(get_smoke_config(arch).replace(use_pallas=use_pallas))
            built[arch, use_pallas] = (
                ref_model, ref_params, model, convert.params_from_jax(np_params, device="cpu"),
            )
        return built[arch, use_pallas]

    return get


def tokens(seed, batch=B, seq=S, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq)).astype(np.int32)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def _common_case(name):
    """(port output, reference output) of one common.py function on seeded inputs."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 4, 6, 16)).astype(np.float32)
    t = torch.from_numpy
    if name == "apply_rope":
        pos = np.arange(3, 9)
        return common.apply_rope(t(x), t(pos), 1e6), jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    if name == "apply_rope_per_row":
        x1 = x[:, :, :1]
        pos = np.array([5, 11])[:, None, None]
        return common.apply_rope(t(x1), t(pos)), jcommon.apply_rope(jnp.asarray(x1), jnp.asarray(pos))
    if name == "attention_single_shot":
        q, k, v = x[:, :, :1], x[:, :2], rng.standard_normal((2, 2, 6, 16)).astype(np.float32)
        mask = np.arange(6)[None, None, None, None, :] <= np.array([3, 5])[:, None, None, None, None]
        got = common.attention_single_shot(t(q), t(k), t(v), mask=t(mask), logit_cap=2.0)
        want = jcommon.attention_single_shot(*map(jnp.asarray, (q, k, v)), mask=jnp.asarray(mask), logit_cap=2.0)
        return got, want
    if name == "causal_mask":
        return common.causal_mask(5, 8, q_offset=3), jcommon.causal_mask(5, 8, q_offset=3)
    if name == "swiglu":
        h = x.reshape(2, 24, 16)
        wg, wi = rng.standard_normal((16, 32)).astype(np.float32), rng.standard_normal((16, 32)).astype(np.float32)
        wo = rng.standard_normal((32, 16)).astype(np.float32)
        got = common.swiglu(t(h), t(wg), t(wi), t(wo), torch.float32)
        return got, jcommon.swiglu(*map(jnp.asarray, (h, wg, wi, wo)), jnp.float32)
    if name == "geglu":
        h = x.reshape(2, 24, 16)
        wg, wi = rng.standard_normal((16, 32)).astype(np.float32), rng.standard_normal((16, 32)).astype(np.float32)
        wo = rng.standard_normal((32, 16)).astype(np.float32)
        got = common.geglu(t(h), t(wg), t(wi), t(wo), torch.float32)
        return got, jcommon.geglu(*map(jnp.asarray, (h, wg, wi, wo)), jnp.float32)
    w = rng.standard_normal(16).astype(np.float32)
    if name == "layer_norm":
        xs = x * 3.0 + 1.5  # a mean and a spread far from 0 and 1
        bias = rng.standard_normal(16).astype(np.float32)
        return (common.layer_norm(t(xs), t(w), t(bias)),
                jcommon.layer_norm(jnp.asarray(xs), jnp.asarray(w), jnp.asarray(bias)))
    return common.rms_norm(t(x), t(w)), jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w))


@pytest.mark.parametrize(
    "name", ["apply_rope", "apply_rope_per_row", "attention_single_shot", "causal_mask", "swiglu", "rms_norm",
             "geglu", "layer_norm"])
def test_common_functions_match_reference(name):
    got, want = _common_case(name)
    assert tuple(got.shape) == tuple(want.shape)
    if got.dtype == torch.bool:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_match_reference(arch):
    for mine, theirs in ((get_config, jax_get_config), (get_smoke_config, jax_get_smoke_config)):
        assert dataclasses.asdict(mine(arch)) == dataclasses.asdict(theirs(arch))
        assert mine(arch).param_count() == theirs(arch).param_count()


def test_unported_archs_and_families_raise():
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("whisper-medium")
    with pytest.raises(NotImplementedError, match="unknown family"):
        build_model(get_smoke_config("nbi-100m").replace(family="encoder-only"))
    # MLA in an MoE model builds and trains, with MLA leaves in both stacks,
    # and refuses to serve, as the reference's prefill fails on it (H11)
    moe_mla = build_model(get_smoke_config("deepseek-moe-16b").replace(
        attention="mla", q_lora_rank=24, kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=8, v_head_dim=8,
    ))
    for stack in ("moe_blocks", "dense_blocks"):
        assert {"wdq", "q_ln", "wdkv", "kv_ln", "wkr"} <= set(moe_mla.param_defs[stack]["attn"])
        assert "wq" not in moe_mla.param_defs[stack]["attn"]
    with pytest.raises(NotImplementedError, match="KeyError: 'wq'"):
        moe_mla.prefill_fn(None, {"tokens": torch.zeros((1, 8), dtype=torch.long)})
    # dense MLA and the visual prefix build: minicpm3-4b's and llava's configs
    # and the same features on another dense config
    mla = build_model(get_smoke_config("minicpm3-4b"))
    assert set(mla.cache_defs_fn(1, 8)) == {"ckv", "krope"}
    assert "wdkv" in build_model(get_smoke_config("codeqwen15_7b").replace(
        attention="mla", q_lora_rank=24, kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=8, v_head_dim=8,
    )).param_defs["blocks"]["attn"]
    for cfg in (get_smoke_config("llava-next-mistral-7b"), get_smoke_config("nbi-100m").replace(n_patches=4)):
        assert build_model(cfg).cfg.n_patches == cfg.n_patches


@pytest.mark.parametrize("arch", ARCHS)
def test_param_defs_and_converter_round_trip(arch, pair):
    ref_model, ref_params, model, params = pair(arch)
    ref_shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), ref_params)
    port_shapes = convert.map_defs(lambda t: tuple(t.shape), params)
    def_shapes = convert.map_defs(lambda d: tuple(d.shape), model.param_defs)
    assert port_shapes == ref_shapes == def_shapes
    # stacked per-layer weights: "blocks" of L layers, Griffin's super-layers
    # and tail pairs, MoE's leading dense layers and MoE layers, or Whisper's
    # encoder and decoder layers
    cfg = model.cfg
    n_super = cfg.n_layers // 3
    stacks = ({"blocks": cfg.n_layers} if "blocks" in params else
              {"dense_blocks": cfg.n_dense_layers, "moe_blocks": cfg.n_layers - cfg.n_dense_layers}
              if cfg.family == "moe" else {"enc_blocks": cfg.n_enc_layers, "dec_blocks": cfg.n_layers}
              if cfg.family == "encdec" else {"super": n_super, "tail": cfg.n_layers - 3 * n_super})
    for key, n in stacks.items():
        assert all(t.shape[0] == n for t in jax.tree_util.tree_leaves(params[key]))
    back = convert.params_to_numpy(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(ref_params)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))


def test_converter_carries_bf16_bits():
    x = jnp.asarray(np.random.default_rng(0).standard_normal((3, 5)), jnp.bfloat16)
    t = convert.params_from_jax({"w": x}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(x, np.float32))
    np.testing.assert_array_equal(convert.params_to_numpy({"w": t})["w"], np.asarray(x, np.float32))


def test_seeded_init_is_deterministic_and_scaled():
    model = build_model(get_smoke_config("nbi-100m"))
    a = model.init(torch.Generator().manual_seed(5), device="cpu")
    b = model.init(torch.Generator().manual_seed(5), device="cpu")
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        assert torch.equal(x, y)
    assert torch.equal(a["final_ln"], torch.ones(64))
    # the reference's fan-in: every axis but the last and the stacked layers
    # axis, so (D, H, hd) = (64, 4, 16) gives std 1/sqrt(64·4)
    wq = a["blocks"]["attn"]["wq"]
    assert abs(float(wq.std()) - 256**-0.5) < 0.005


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_reference(arch, use_pallas, pair):
    ref_model, ref_params, model, params = pair(arch, use_pallas)
    toks = tokens(1)
    want_logits, want_cache = jax.jit(ref_model.prefill_fn)(ref_params, {"tokens": jnp.asarray(toks)})
    logits, cache = model.prefill_fn(params, {"tokens": torch.from_numpy(toks)})
    assert logits.shape == want_logits.shape == (B, 1, 512)
    close(logits, want_logits)
    # (L, B, Hkv, S, hd) K/V, or MLA's (L, B, S, r) latents
    assert set(cache) == set(want_cache) == ({"ckv", "krope"} if model.cfg.attention == "mla" else {"k", "v"})
    for name in cache:
        assert cache[name].shape == want_cache[name].shape
        close(cache[name], want_cache[name])


@pytest.mark.parametrize("pos_kind", ["scalar", "vector"])
@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_reference(arch, pos_kind, pair):
    ref_model, ref_params, model, params = pair(arch)
    toks = tokens(2)
    max_seq = S + 8
    _, ref_cache = jax.jit(ref_model.prefill_fn)(ref_params, {"tokens": jnp.asarray(toks)})
    ref_cache = jax_pad_cache_to(ref_cache, ref_model.cache_defs_fn(B, max_seq))
    _, cache = model.prefill_fn(params, {"tokens": torch.from_numpy(toks)})
    cache = pad_cache_to(cache, model.cache_defs_fn(B, max_seq))
    nxt = tokens(3, seq=1)
    pos = np.array(S, np.int32) if pos_kind == "scalar" else np.array([S, S - 5], np.int32)
    want_logits, want_cache = jax.jit(ref_model.decode_fn)(
        ref_params, ref_cache, jnp.asarray(nxt), jnp.asarray(pos))
    logits, new_cache = model.decode_fn(params, cache, torch.from_numpy(nxt), torch.from_numpy(pos))
    close(logits, want_logits)
    for name in new_cache:
        close(new_cache[name], want_cache[name])


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_then_decode_matches_full_forward(arch, pair):
    """The port's KV-cache law (tests/test_archs.py:88): the decode-step logits
    at position S equal a full forward over the S+1 tokens."""
    _, _, model, params = pair(arch)
    toks = torch.from_numpy(tokens(4, batch=1))
    last, cache = model.prefill_fn(params, {"tokens": toks})
    cache = pad_cache_to(cache, model.cache_defs_fn(1, S + 8))
    nxt = last[:, -1].argmax(-1)[:, None]
    step, _ = model.decode_fn(params, cache, nxt, S)
    full = tx.dense_forward(params, model.cfg, torch.cat([toks, nxt], dim=1))
    torch.testing.assert_close(step[:, -1], full[:, -1], **TOL)


def test_vector_pos_equals_per_row_scalar(pair):
    _, _, model, params = pair("codeqwen15_7b")
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


def test_model_init_without_device_raises_on_cpu_host():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = build_model(get_smoke_config("nbi-100m"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_jax({"w": np.zeros(3, np.float32)})


# bf16 decode attention: both sides sum in f32 and round once at the output
BF16_OUT_TOL = dict(atol=1e-3, rtol=2**-7)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_attention_single_shot_bf16_matches_reference(d):
    """bf16 decode attention scales q the reference's way: in bf16, by
    ``d**-0.5`` rounded to bf16 (not a power of two at d 128, so an f32 scale
    moves outputs past one rounding step); d 64 and 256 have exact scales."""
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((4, 16, 1, d), (4, 4, 300, d), (4, 4, 300, d)))
    mask = np.arange(300)[None, None, None, None, :] < np.array([300, 217, 64, 1])[:, None, None, None, None]
    got = common.attention_single_shot(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), mask=torch.from_numpy(mask))
    want = jcommon.attention_single_shot(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), mask=jnp.asarray(mask))
    assert got.dtype == torch.bfloat16
    close(got.float(), np.asarray(want, np.float32), **BF16_OUT_TOL)


# bf16 parity of whole models: prefill, then greedy decode steps
BF16_STEPS = 3


def bf16_logits(arch, seq=64, liven=None, **overrides):
    """(port cfg, [(port logits, reference logits)] for a prefill of 2 × seq
    tokens and BF16_STEPS decode steps) of the smoke config in bf16
    (``dtype`` and ``param_dtype``), the reference's prefill through its
    Pallas attention kernel in interpret mode, which scales in f32 as the card
    does (ROADMAP H3). Each step feeds both sides the reference's greedy token,
    so that they stay on one sequence. ``liven`` may redraw reference leaves
    (a numpy tree) before they cross to the port."""
    over = dict(dtype="bfloat16", param_dtype="bfloat16", use_pallas=True, **overrides)
    ref_model = jax_build_model(jax_get_smoke_config(arch).replace(**over))
    np_params = jax.tree_util.tree_map(np.asarray, ref_model.init(jax.random.PRNGKey(0)))
    if liven:
        np_params = liven(np_params)
    ref_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    model = build_model(get_smoke_config(arch).replace(**over))
    params = convert.params_from_jax(np_params, device="cpu")
    toks = tokens(11, seq=seq)
    want, ref_cache = jax.jit(ref_model.prefill_fn)(ref_params, {"tokens": jnp.asarray(toks)})
    got, cache = model.prefill_fn(params, {"tokens": torch.from_numpy(toks)})
    out = [(got, want)]
    ref_cache = jax_pad_cache_to(ref_cache, ref_model.cache_defs_fn(B, seq + BF16_STEPS))
    cache = pad_cache_to(cache, model.cache_defs_fn(B, seq + BF16_STEPS))
    decode = jax.jit(ref_model.decode_fn)
    for i in range(BF16_STEPS):
        nxt = np.asarray(want, np.float32)[:, -1].argmax(-1)[:, None].astype(np.int32)
        want, ref_cache = decode(ref_params, ref_cache, jnp.asarray(nxt), jnp.asarray(seq + i, jnp.int32))
        got, cache = model.decode_fn(params, cache, torch.from_numpy(nxt), seq + i)
        out.append((got, want))
    return model.cfg, out


def assert_bf16_logits_close(cfg, steps, stages_per_layer: int) -> None:
    """The bound, from bf16 rounding alone. bf16 keeps 8 significant bits, so
    each side rounds a value to within 2**-8 of it relative, and two sides
    that round at different places (fused or not, other summation orders)
    differ by up to 2**-7 relative at each stage that rounds. Carried to
    first order with unit gain through every rounding stage on the path to
    the logits (``stages_per_layer`` per layer, then the final norm and the
    unembedding), the logits differ by at most
    (stages_per_layer * L + 2) * 2**-7 * max |logit|."""
    n = stages_per_layer * cfg.n_layers + 2
    for i, (got, want) in enumerate(steps):
        want = np.asarray(want, np.float32)
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        bound = n * 2**-7 * float(np.abs(want).max())
        err = float(np.abs(got.float().numpy() - want).max())
        assert err <= bound, f"step {i}: max abs logit err {err} > {bound}"


# dense stages: norm, q/k/v, RoPE, attention, out projection, residual, norm,
# gate and up, SiLU product, down, residual
DENSE_BF16_STAGES = 11


@pytest.mark.parametrize("arch,head_dim", [("nbi-100m", None), ("codeqwen15_7b", 128)])
def test_bf16_matches_reference(arch, head_dim):
    """bf16 prefill and decode of the dense family; codeqwen15_7b at its real
    head width 128, where decode's q scale (0.0883789 in bf16) is not a power
    of two."""
    cfg, steps = bf16_logits(arch, **({"head_dim": head_dim} if head_dim else {}))
    assert_bf16_logits_close(cfg, steps, DENSE_BF16_STAGES)
