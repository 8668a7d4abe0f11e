"""The port's RWKV-6 serving path against the JAX package, on the CPU at
smoke size.

Weights come from the reference's own init and cross with
``repro_torch.convert.params_from_jax``; tokens come from a seeded numpy
generator. The reference is called through ``build_model(cfg).prefill_fn`` /
``decode_fn`` with no sharding rules (ROADMAP hazard H1), with ``use_pallas``
both ways: its Pallas WKV kernel in interpret mode, or its chunked XLA form.
Both need S % 64 == 0 (ROADMAP hazard H4), so the parity prefills are 64 and
128 tokens long; the port's own laws also run at lengths that are not.
Tolerance: atol 1e-4 / rtol 1e-4 (f32, different summation orders; the WKV
state is compared at the same rtol with atol 2e-4, as it sums 128 outer
products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.launch.serve import pad_cache_to as jax_pad_cache_to
from repro.models import rwkv6 as jrwkv
from repro.models.registry import build_model as jax_build_model
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import rmsnorm as trn
from repro_torch.kernels import rwkv6_scan as twkv
from repro_torch.launch.serve import ServeEngine, pad_cache_to
from repro_torch.models import rwkv6
from repro_torch.models.registry import build_model
from test_torch_model import assert_bf16_logits_close, bf16_logits

ARCH = "rwkv6_7b"
TOL = dict(atol=1e-4, rtol=1e-4)
STATE_TOL = dict(atol=2e-4, rtol=1e-4)
B = 2
USE_PALLAS = pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])


def liven(np_params):
    """Redraws the zero-initialised mixes, bonus and biases of a numpy
    reference tree in place, so that every term of the block is live."""
    rng = np.random.default_rng(9)
    blocks = np_params["blocks"]
    for group, name in (("tm", "mu_x"), ("tm", "mu_rkvgw"), ("tm", "u"), ("tm", "gn_b"),
                        ("cm", "mu_k"), ("cm", "mu_r")):
        leaf = blocks[group][name]
        blocks[group][name] = (rng.standard_normal(leaf.shape) * 0.3).astype(leaf.dtype)
    return np_params


@pytest.fixture(scope="module")
def pair():
    """(reference model, reference params, port model, port params) per
    use_pallas, built once; the port's weights are the reference's, with the
    zero-initialised mixes, bonus and biases redrawn so that every term of
    the block is live."""
    built = {}

    def get(use_pallas=False):
        if use_pallas not in built:
            ref_model = jax_build_model(jax_get_smoke_config(ARCH).replace(use_pallas=use_pallas))
            ref_params = liven(jax.tree_util.tree_map(np.asarray, ref_model.init(jax.random.PRNGKey(0))))
            ref_params = jax.tree_util.tree_map(jnp.asarray, ref_params)
            model = build_model(get_smoke_config(ARCH).replace(use_pallas=use_pallas))
            params = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
            built[use_pallas] = (ref_model, ref_params, model, params)
        return built[use_pallas]

    return get


@pytest.fixture(scope="module")
def prefilled(pair):
    """Reference and port prefill outputs per (use_pallas, S), computed once."""
    done = {}

    def get(use_pallas, S):
        if (use_pallas, S) not in done:
            ref_model, ref_params, model, params = pair(use_pallas)
            toks = tokens(S, S)
            want = jax.jit(ref_model.prefill_fn)(ref_params, {"tokens": jnp.asarray(toks)})
            got = model.prefill_fn(params, {"tokens": torch.from_numpy(toks)})
            done[use_pallas, S] = (want, got)
        return done[use_pallas, S]

    return get


def tokens(seed, seq, batch=B, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq)).astype(np.int32)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **(tol or TOL))


def check_cache(got, want):
    assert set(got) == set(want) == {"tm_shift", "cm_shift", "wkv"}
    for name in want:
        assert tuple(got[name].shape) == tuple(want[name].shape), name
        close(got[name], want[name], **(STATE_TOL if name == "wkv" else TOL))


@USE_PALLAS
@pytest.mark.parametrize("S", [64, 128])
def test_prefill_matches_reference(S, use_pallas, prefilled):
    (want_logits, want_cache), (logits, cache) = prefilled(use_pallas, S)
    assert logits.shape == want_logits.shape == (B, 1, 512)
    close(logits, want_logits)
    check_cache(cache, want_cache)


@USE_PALLAS
@pytest.mark.parametrize("S", [64, 128])
def test_decode_matches_reference(S, use_pallas, pair, prefilled):
    ref_model, ref_params, model, params = pair(use_pallas)
    (_, want_cache), (_, cache) = prefilled(use_pallas, S)
    want_cache = jax_pad_cache_to(want_cache, ref_model.cache_defs_fn(B, S + 8))
    cache = pad_cache_to(convert.map_defs(torch.clone, cache), model.cache_defs_fn(B, S + 8))
    nxt = tokens(3, 1)
    want_logits, want_new = jax.jit(ref_model.decode_fn)(
        ref_params, want_cache, jnp.asarray(nxt), jnp.asarray(S, jnp.int32))
    logits, new = model.decode_fn(params, cache, torch.from_numpy(nxt), S)
    close(logits, want_logits)
    check_cache(new, want_new)


@pytest.mark.parametrize("S", [64, 100])
def test_prefill_then_decode_matches_full_forward(S, pair):
    """The recurrent-state law, also at a length the reference's prefill
    cannot take (H4): each decode step's logits equal a full forward."""
    _, _, model, params = pair()
    toks = torch.from_numpy(tokens(4, S, batch=1))
    last, cache = model.prefill_fn(params, {"tokens": toks})
    cache = pad_cache_to(cache, model.cache_defs_fn(1, S + 8))
    for _ in range(3):
        nxt = last[:, -1].argmax(-1)[:, None]
        last, cache = model.decode_fn(params, cache, nxt, toks.shape[1])
        toks = torch.cat([toks, nxt], dim=1)
        full = rwkv6.rwkv_forward(params, model.cfg, toks)
        torch.testing.assert_close(last[:, -1], full[:, -1], **TOL)


def test_prefill_takes_any_length_and_splits_like_decode(pair):
    """A prefill of 37 tokens equals a prefill of 29 followed by 8 decode
    steps, state for state."""
    _, _, model, params = pair()
    toks = torch.from_numpy(tokens(8, 37))
    want_last, want_cache = model.prefill_fn(params, {"tokens": toks})
    last, cache = model.prefill_fn(params, {"tokens": toks[:, :29]})
    for i in range(29, 37):
        last, cache = model.decode_fn(params, cache, toks[:, i : i + 1], i)
    torch.testing.assert_close(last, want_last, **TOL)
    for name in cache:
        torch.testing.assert_close(cache[name], want_cache[name], atol=2e-4, rtol=1e-4)


@USE_PALLAS
def test_greedy_tokens_match_reference(use_pallas, pair):
    ref_model, ref_params, model, params = pair(use_pallas)
    engine = ServeEngine(get_smoke_config(ARCH), batch=B, max_seq=80, device="cpu")
    engine.params = params
    prompts = tokens(5, 64)
    got = engine.generate_batch(prompts, gen_len=6)
    # the reference engine's greedy loop, without its mesh (H1)
    prefill, decode = jax.jit(ref_model.prefill_fn), jax.jit(ref_model.decode_fn)
    logits, cache = prefill(ref_params, {"tokens": jnp.asarray(prompts)})
    cache = jax_pad_cache_to(cache, ref_model.cache_defs_fn(B, 80))
    want = np.zeros((B, 6), np.int32)
    for i in range(6):
        want[:, i] = np.asarray(jnp.argmax(logits[:, -1], axis=-1))
        logits, cache = decode(ref_params, cache, jnp.asarray(want[:, i : i + 1]),
                               jnp.asarray(64 + i, jnp.int32))
    np.testing.assert_array_equal(got, want)


def _block_case(name, params):
    """(port output, reference output) of one block function at S 1, where the
    reference needs no chunking, with seeded inputs and a seeded state."""
    rng = np.random.default_rng(12)
    cfg = get_smoke_config(ARCH)
    D, H, dk = cfg.d_model, cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
    p = convert.map_defs(lambda t: t[0], params["blocks"])
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), p)
    x = rng.standard_normal((B, 1, D)).astype(np.float32)
    shift = rng.standard_normal((B, D)).astype(np.float32)
    wkv = (rng.standard_normal((B, H, dk, dk)) * 0.5).astype(np.float32)
    t = torch.from_numpy
    if name == "ddlerp":
        sx = shift[:, None] - x
        return rwkv6._ddlerp(p["tm"], t(x), t(sx)), jrwkv._ddlerp(jp["tm"], jnp.asarray(x), jnp.asarray(sx))
    if name == "time_mix":
        return (rwkv6.time_mix(p["tm"], t(x), cfg, t(shift), t(wkv)),
                jrwkv.time_mix(jp["tm"], jnp.asarray(x), jax_get_smoke_config(ARCH), jnp.asarray(shift), jnp.asarray(wkv)))
    if name == "channel_mix":
        return rwkv6.channel_mix(p["cm"], t(x), t(shift)), jrwkv.channel_mix(jp["cm"], jnp.asarray(x), jnp.asarray(shift))
    r, k, w = (rng.uniform(0.1, 0.9, (B, H, dk)).astype(np.float32) for _ in range(3))
    v = rng.standard_normal((B, H, dk)).astype(np.float32)
    u = rng.standard_normal((H, dk)).astype(np.float32)
    args = (r, k, v, w, u, wkv)
    return rwkv6.wkv6_step(*map(t, args)), jrwkv.wkv6_step(*map(jnp.asarray, args))


@pytest.mark.parametrize("name", ["ddlerp", "time_mix", "channel_mix", "wkv6_step"])
def test_block_functions_match_reference(name, pair):
    got, want = _block_case(name, pair()[3])
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        close(g, w, atol=1e-5, rtol=1e-5)


def test_pad_cache_to_keeps_recurrent_state_and_casts():
    model = build_model(get_smoke_config(ARCH).replace(dtype="bfloat16"))
    defs = model.cache_defs_fn(B, 64)
    gen = torch.Generator().manual_seed(1)
    cache = {name: torch.randn(d.shape, generator=gen) for name, d in defs.items()}
    out = pad_cache_to(cache, defs)
    for name, leaf in out.items():
        assert leaf.dtype == defs[name].dtype and leaf.shape == defs[name].shape
        torch.testing.assert_close(leaf, cache[name].to(defs[name].dtype), rtol=0, atol=0)
    assert out["wkv"].dtype == torch.float32 and out["tm_shift"].dtype == torch.bfloat16


def test_cpu_path_launches_no_kernel(pair):
    _, _, model, params = pair()
    before = (twkv.launches, trn.launches)
    model.prefill_fn(params, {"tokens": torch.from_numpy(tokens(6, 10))})
    assert (twkv.launches, trn.launches) == before


# RWKV-6 stages: LayerNorm, token shift and mixes, r/k/v/g projections, decay
# LoRA, the WKV recurrence, group norm, gate, output projection, residual,
# LayerNorm, channel-mix shift, key projection, squared ReLU, value and
# receptance, residual
RWKV6_BF16_STAGES = 16


def test_bf16_matches_reference():
    """bf16 prefill (64 tokens: the reference needs S % 64 == 0, H4) and
    decode, held to the bound from bf16 rounding."""
    cfg, steps = bf16_logits(ARCH, seq=64, liven=liven)
    assert_bf16_logits_close(cfg, steps, RWKV6_BF16_STAGES)
