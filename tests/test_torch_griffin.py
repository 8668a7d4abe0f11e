"""The port's Griffin (recurrentgemma) serving path against the JAX package,
on the CPU at smoke size.

Weights come from the reference's own init, its zero leaves redrawn, and
cross with ``repro_torch.convert.params_from_jax``; tokens come from a seeded
numpy generator. The reference is called through ``build_model(cfg).prefill_fn`` /
``decode_fn`` with no sharding rules (ROADMAP hazard H1), with ``use_pallas``
both ways: at S 128 its Pallas RG-LRU kernel runs in interpret mode, at S 4 its
associative scan. The smoke window is 8, so S 128 takes the ring path of the
local-attention cache and S 4 the padded one. Tolerance: atol 1e-4 / rtol 1e-4
(f32, different summation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.launch.serve import pad_cache_to as jax_pad_cache_to
from repro.models import rglru as jrglru
from repro.models.registry import build_model as jax_build_model
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import rglru_scan as tlru
from repro_torch.kernels import rmsnorm as trn
from repro_torch.launch.serve import ServeEngine, pad_cache_to
from repro_torch.models import rglru
from repro_torch.models.registry import build_model
from test_torch_model import assert_bf16_logits_close, bf16_logits

ARCH = "recurrentgemma_2b"
TOL = dict(atol=1e-4, rtol=1e-4)
B = 2
USE_PALLAS = pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])


def liven(np_params):
    """Redraws the zero leaves of a numpy reference tree (both RG-LRU gates'
    weights and biases and the conv bias), so that the gates depend on the
    input."""
    rng = np.random.default_rng(9)
    return jax.tree_util.tree_map(
        lambda a: a if a.any() else (rng.standard_normal(a.shape) * 0.3).astype(a.dtype), np_params)


@pytest.fixture(scope="module")
def pair():
    """(reference model, reference params, port model, port params) per
    use_pallas, built once; the port's weights are the reference's, with the
    zero-initialised leaves (both RG-LRU gates' weights and biases and the
    conv bias) redrawn so that the gates depend on the input."""
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


def leaves(tree, prefix=""):
    """{path: leaf} of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(leaves(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **(tol or TOL))


@USE_PALLAS
@pytest.mark.parametrize("S", [128, 4])
def test_prefill_matches_reference(S, use_pallas, prefilled):
    (want_logits, want_cache), (logits, cache) = prefilled(use_pallas, S)
    assert logits.shape == want_logits.shape == (B, 1, 512)
    close(logits, want_logits)
    got, want = leaves(cache), leaves(want_cache)
    assert set(got) == set(want) == {
        f"/{g}/{n}" for g in ("rec1", "rec2", "tail") for n in ("conv", "h")
    } | {"/attn/k", "/attn/v", "/attn/pos"}
    for name in want:
        assert tuple(got[name].shape) == tuple(want[name].shape), name
        if name == "/attn/pos":
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
        else:
            close(got[name], want[name])


@USE_PALLAS
@pytest.mark.parametrize("S", [128, 4])
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
    got, want = leaves(new), leaves(want_new)
    for name in want:
        close(got[name], want[name])


def test_prefill_then_decode_matches_full_forward(pair):
    """The recurrent-state and ring-cache law: after a prefill past the
    window, each decode step's logits equal a full forward over the tokens."""
    _, _, model, params = pair()
    toks = torch.from_numpy(tokens(4, 13, batch=1))
    last, cache = model.prefill_fn(params, {"tokens": toks})
    cache = pad_cache_to(cache, model.cache_defs_fn(1, 32))
    for step in range(3):
        nxt = last[:, -1].argmax(-1)[:, None]
        last, cache = model.decode_fn(params, cache, nxt, toks.shape[1])
        toks = torch.cat([toks, nxt], dim=1)
        full = rglru.griffin_forward(params, model.cfg, toks)
        torch.testing.assert_close(last[:, -1], full[:, -1], **TOL)


@USE_PALLAS
def test_greedy_tokens_match_reference(use_pallas, pair):
    ref_model, ref_params, model, params = pair(use_pallas)
    engine = ServeEngine(get_smoke_config(ARCH), batch=B, max_seq=32, device="cpu")
    engine.params = params
    prompts = tokens(5, 12)
    got = engine.generate_batch(prompts, gen_len=6)
    # the reference engine's greedy loop, without its mesh (H1)
    prefill, decode = jax.jit(ref_model.prefill_fn), jax.jit(ref_model.decode_fn)
    logits, cache = prefill(ref_params, {"tokens": jnp.asarray(prompts)})
    cache = jax_pad_cache_to(cache, ref_model.cache_defs_fn(B, 32))
    want = np.zeros((B, 6), np.int32)
    for i in range(6):
        want[:, i] = np.asarray(jnp.argmax(logits[:, -1], axis=-1))
        logits, cache = decode(ref_params, cache, jnp.asarray(want[:, i : i + 1]),
                               jnp.asarray(12 + i, jnp.int32))
    np.testing.assert_array_equal(got, want)


def test_pad_cache_to_maps_over_the_nested_cache():
    """Every leaf of Griffin's nested cache already has its decode shape: the
    result is the same values cast to the layout's dtypes, as the reference's
    tree_map; a smaller axis is right-padded with zeros at any depth."""
    model = build_model(get_smoke_config(ARCH))
    defs = model.cache_defs_fn(B, 64)
    gen = torch.Generator().manual_seed(0)
    cache = convert.map_defs(lambda d: torch.randn(d.shape, generator=gen), defs)
    padded = pad_cache_to(cache, defs)
    want = jax_pad_cache_to(jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), cache),
                            jax_build_model(jax_get_smoke_config(ARCH)).cache_defs_fn(B, 64))
    for name, leaf in leaves(padded).items():
        assert leaf.dtype == leaves(defs)[name].dtype and leaf.shape == leaves(defs)[name].shape
        np.testing.assert_array_equal(leaf.float().numpy(), np.asarray(leaves(want)[name], np.float32))
    nested = {"a": {"b": torch.ones(2, 3)}, "c": torch.ones(4)}
    meta = {"a": {"b": torch.empty(2, 5, device="meta")}, "c": torch.empty(4, dtype=torch.float64, device="meta")}
    out = pad_cache_to(nested, meta)
    assert torch.equal(out["a"]["b"], torch.cat([torch.ones(2, 3), torch.zeros(2, 2)], dim=1))
    assert out["c"].dtype == torch.float64
    with pytest.raises(ValueError, match="exceeds"):
        pad_cache_to({"a": {"b": torch.ones(2, 6)}, "c": torch.ones(4)}, meta)


@pytest.mark.parametrize("S", [13, 5])
def test_ring_from_full_orders_slots_by_position(S):
    cfg = get_smoke_config(ARCH)  # window 8
    ks = torch.arange(S, dtype=torch.float32).reshape(1, 1, 1, S, 1).repeat(2, 1, 1, 1, 1)
    ring = rglru._ring_from_full(ks, ks.clone(), cfg, S)
    want = jrglru._ring_from_full(jnp.asarray(ks.numpy()), jnp.asarray(ks.numpy()), jax_get_smoke_config(ARCH), S)
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(ring[name].numpy(), np.asarray(want[name]))
    pos = ring["pos"][0]
    live = pos >= 0
    assert torch.equal(pos[live] % 8, torch.arange(8)[live])
    assert int((~live).sum()) == max(0, 8 - S)


def _recurrence_case(name):
    rng = np.random.default_rng(11)
    W, K = 64, 4
    p = {"a_gate_w": rng.standard_normal(W), "a_gate_b": rng.standard_normal(W),
         "in_gate_w": rng.standard_normal(W), "in_gate_b": rng.standard_normal(W),
         "lam": rng.standard_normal(W) + 0.7, "conv_w": rng.standard_normal((W, K)) * 0.5,
         "conv_b": rng.standard_normal(W)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    xb = rng.standard_normal((2, 6, W)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    if name == "rglru_coeffs":
        return rglru.rglru_coeffs(tp, torch.from_numpy(xb)), jrglru.rglru_coeffs(jp, jnp.asarray(xb))
    if name == "rglru_step":
        h = rng.standard_normal((2, W)).astype(np.float32)
        return (rglru.rglru_step(tp, torch.from_numpy(xb[:, 0]), torch.from_numpy(h)),
                jrglru.rglru_step(jp, jnp.asarray(xb[:, 0]), jnp.asarray(h)))
    if name == "rglru_scan_h0":
        h = rng.standard_normal((2, W)).astype(np.float32)
        return (rglru.rglru_scan(tp, torch.from_numpy(xb), torch.from_numpy(h)),
                jrglru.rglru_scan(jp, jnp.asarray(xb), jnp.asarray(h)))
    if name == "causal_conv":
        return rglru.causal_conv(tp, torch.from_numpy(xb)), jrglru.causal_conv(jp, jnp.asarray(xb))
    state = rng.standard_normal((2, K - 1, W)).astype(np.float32)
    return (rglru.causal_conv(tp, torch.from_numpy(xb[:, :1]), torch.from_numpy(state)),
            jrglru.causal_conv(jp, jnp.asarray(xb[:, :1]), jnp.asarray(state)))


@pytest.mark.parametrize("name", ["rglru_coeffs", "rglru_step", "rglru_scan_h0", "causal_conv", "causal_conv_state"])
def test_recurrence_functions_match_reference(name):
    got, want = _recurrence_case(name)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        close(g, w, atol=1e-5, rtol=1e-5)


def test_cpu_path_launches_no_kernel(pair):
    _, _, model, params = pair()
    def counts():
        return (*(getattr(tfa, name) for name in ("bf16_launches", *tfa.TF32_COUNTS.values())),
                tlru.launches, trn.launches)

    before = counts()
    model.prefill_fn(params, {"tokens": torch.from_numpy(tokens(6, 10))})
    assert counts() == before


# Griffin stages per layer (the deeper of its two blocks, the recurrent one):
# norm, input and gate projections, conv, RG-LRU gates, the scan, GeLU
# product, output projection, residual, norm, gate and up, GeLU product,
# down, residual
GRIFFIN_BF16_STAGES = 14


def test_bf16_matches_reference():
    """bf16 prefill past the window of 8 (the ring cache) and decode, held to
    the bound from bf16 rounding."""
    cfg, steps = bf16_logits(ARCH, seq=64, liven=liven)
    assert_bf16_logits_close(cfg, steps, GRIFFIN_BF16_STAGES)
