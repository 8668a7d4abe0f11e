"""The port's MoE serving path (deepseek-moe-16b; kimi-k2-1t-a32b's prefill and
decode too) against the JAX package, on the CPU at smoke size.

Weights come from the reference's own init and cross with
``repro_torch.convert.params_from_jax``; tokens come from a seeded numpy
generator. The reference is called through ``build_model(cfg).prefill_fn`` /
``decode_fn`` with no sharding rules (ROADMAP hazard H1), with ``use_pallas``
both ways. The smoke config routes groups of 32 tokens over 8 experts, top-2,
capacity 10 per group, so a 2 × 16 prefill is one group and a 4 × 16 prefill
two (G > 1), and picks are dropped; kimi-k2's smoke config routes the same
groups with one shared expert and GQA (4 query heads over 2 KV heads). Tolerance: atol 1e-4 / rtol 1e-4 (f32,
different summation orders); the routing decision itself is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.launch.serve import pad_cache_to as jax_pad_cache_to
from repro.models import moe as jmoe
from repro.models.registry import build_model as jax_build_model
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ref
from repro_torch.launch.serve import ServeEngine, pad_cache_to
from repro_torch.models import moe
from repro_torch.models.registry import build_model
from test_torch_model import assert_bf16_logits_close, bf16_logits

ARCH = "deepseek_moe_16b"
KIMI = "kimi_k2_1t_a32b"
TOL = dict(atol=1e-4, rtol=1e-4)
USE_PALLAS = pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
SHAPES = pytest.mark.parametrize("batch,seq", [(2, 16), (4, 16)], ids=["one_group", "two_groups"])


@pytest.fixture(scope="module")
def pair():
    """(reference model, reference params, port model, port params) per
    use_pallas and arch, built once."""
    built = {}

    def get(use_pallas=False, arch=ARCH):
        if (arch, use_pallas) not in built:
            ref_model = jax_build_model(jax_get_smoke_config(arch).replace(use_pallas=use_pallas))
            ref_params = ref_model.init(jax.random.PRNGKey(0))
            model = build_model(get_smoke_config(arch).replace(use_pallas=use_pallas))
            params = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
            built[arch, use_pallas] = (ref_model, ref_params, model, params)
        return built[arch, use_pallas]

    return get


@pytest.fixture(scope="module")
def prefilled(pair):
    """Reference and port prefill outputs per (use_pallas, batch, seq, arch)."""
    done = {}

    def get(use_pallas, batch, seq, arch=ARCH):
        key = (use_pallas, batch, seq, arch)
        if key not in done:
            ref_model, ref_params, model, params = pair(use_pallas, arch)
            toks = tokens(seq, batch, seq)
            want = jax.jit(ref_model.prefill_fn)(ref_params, {"tokens": jnp.asarray(toks)})
            got = model.prefill_fn(params, {"tokens": torch.from_numpy(toks)})
            done[key] = (want, got)
        return done[key]

    return get


def tokens(seed, batch, seq, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq)).astype(np.int32)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **(tol or TOL))


def check_cache(got, want):
    assert set(got) == set(want) == {"dense", "moe"}
    for stack in want:
        assert set(got[stack]) == set(want[stack]) == {"k", "v"}
        for name in want[stack]:
            assert tuple(got[stack][name].shape) == tuple(want[stack][name].shape)
            close(got[stack][name], want[stack][name])


def check_prefill(arch, batch, seq, use_pallas, prefilled):
    (want_logits, want_cache), (logits, cache) = prefilled(use_pallas, batch, seq, arch)
    assert logits.shape == want_logits.shape == (batch, 1, 512)
    close(logits, want_logits)
    check_cache(cache, want_cache)


def check_decode(arch, batch, seq, use_pallas, pair, prefilled):
    ref_model, ref_params, model, params = pair(use_pallas, arch)
    (_, want_cache), (_, cache) = prefilled(use_pallas, batch, seq, arch)
    want_cache = jax_pad_cache_to(want_cache, ref_model.cache_defs_fn(batch, seq + 8))
    cache = pad_cache_to(convert.map_defs(torch.clone, cache), model.cache_defs_fn(batch, seq + 8))
    nxt = tokens(3, batch, 1)
    want_logits, want_new = jax.jit(ref_model.decode_fn)(
        ref_params, want_cache, jnp.asarray(nxt), jnp.asarray(seq, jnp.int32))
    logits, new = model.decode_fn(params, cache, torch.from_numpy(nxt), seq)
    close(logits, want_logits)
    check_cache(new, want_new)


@USE_PALLAS
@SHAPES
def test_prefill_matches_reference(batch, seq, use_pallas, prefilled):
    check_prefill(ARCH, batch, seq, use_pallas, prefilled)


@USE_PALLAS
@SHAPES
def test_decode_matches_reference(batch, seq, use_pallas, pair, prefilled):
    check_decode(ARCH, batch, seq, use_pallas, pair, prefilled)


@USE_PALLAS
@SHAPES
def test_kimi_prefill_matches_reference(batch, seq, use_pallas, prefilled):
    check_prefill(KIMI, batch, seq, use_pallas, prefilled)


@USE_PALLAS
@SHAPES
def test_kimi_decode_matches_reference(batch, seq, use_pallas, pair, prefilled):
    check_decode(KIMI, batch, seq, use_pallas, pair, prefilled)


@USE_PALLAS
def test_greedy_tokens_match_reference(use_pallas, pair):
    """Greedy generation of four rows (prefill in two groups), against the
    reference engine's loop over its own model functions."""
    ref_model, ref_params, _, params = pair(use_pallas)
    engine = ServeEngine(get_smoke_config(ARCH), batch=4, max_seq=24, device="cpu")
    engine.params = params
    prompts = tokens(5, 4, 16)
    got = engine.generate_batch(prompts, gen_len=6)
    prefill, decode = jax.jit(ref_model.prefill_fn), jax.jit(ref_model.decode_fn)
    logits, cache = prefill(ref_params, {"tokens": jnp.asarray(prompts)})
    cache = jax_pad_cache_to(cache, ref_model.cache_defs_fn(4, 24))
    want = np.zeros((4, 6), np.int32)
    for i in range(6):
        want[:, i] = np.asarray(jnp.argmax(logits[:, -1], axis=-1))
        logits, cache = decode(ref_params, cache, jnp.asarray(want[:, i : i + 1]), jnp.asarray(16 + i, jnp.int32))
    np.testing.assert_array_equal(got, want)


def test_prefill_drops_picks(pair, monkeypatch):
    """The parity cases run with dropped picks: the plain gating on the first
    MoE layer's router logits of the 4 × 16 prefill marks some pick -1."""
    _, _, model, params = pair()
    seen = []
    gating = moe.ops.moe_gating

    def record(logits, **kw):
        seen.append((logits.clone(), kw))
        return gating(logits, **kw)

    monkeypatch.setattr(moe.ops, "moe_gating", record)
    model.prefill_fn(params, {"tokens": torch.from_numpy(tokens(16, 4, 16))})
    assert len(seen) == model.cfg.n_layers - model.cfg.n_dense_layers
    logits, kw = seen[0]
    assert logits.shape == (2, 32, 8) and kw == {"top_k": 2, "capacity": 10}
    _, _, pos = ref.moe_gating_ref(logits, **kw)
    assert bool((pos < 0).any())


def test_group_that_does_not_divide_raises(pair):
    """2 × 50 tokens do not split into groups of 32: the reference asserts
    (ROADMAP hazard H7) and the port raises on the same condition."""
    ref_model, ref_params, model, params = pair()
    toks = tokens(6, 2, 50)
    with pytest.raises(AssertionError):
        jax.jit(ref_model.prefill_fn)(ref_params, {"tokens": jnp.asarray(toks)})
    with pytest.raises(ValueError, match="groups of 32"):
        model.prefill_fn(params, {"tokens": torch.from_numpy(toks)})


def test_prefill_then_decode_matches_full_forward(pair):
    """The KV-cache law holds where no pick is dropped: at capacity_factor
    E / k every group's capacity is at least its token count, so routing is
    per token and a decode step equals the last position of a full forward."""
    _, _, _, params = pair()
    cfg = get_smoke_config(ARCH)
    law = build_model(cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k))
    toks = torch.from_numpy(tokens(7, 2, 15))
    last, cache = law.prefill_fn(params, {"tokens": toks})
    cache = pad_cache_to(cache, law.cache_defs_fn(2, 24))
    nxt = last[:, -1].argmax(-1)[:, None]
    step, _ = law.decode_fn(params, cache, nxt, 15)
    full = law.forward_fn(params, torch.cat([toks, nxt], dim=1))
    torch.testing.assert_close(step[:, -1], full[:, -1], **TOL)


# (n_experts, top_k, capacity, logit skew): tests/test_kernels.py's case, then
# one with popular experts and many drops
ROUTING_CASES = {"kernel_test": (16, 3, 16, 0.0), "skewed": (16, 3, 6, 1.0)}


@pytest.mark.parametrize("case", sorted(ROUTING_CASES))
def test_top_k_routing_matches_reference(case):
    """Dispatch and combine rebuilt from the gating's (idx, gate, pos) equal
    the reference's one-hot top_k_routing: dispatch exact, combine 1e-5, aux
    1e-6."""
    E, k, cap, skew = ROUTING_CASES[case]
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((2, 64, E)) + skew * rng.standard_normal(E)).astype(np.float32)
    dispatch, combine, aux = moe.top_k_routing(
        torch.from_numpy(x), get_smoke_config(ARCH).replace(n_experts=E, top_k=k), cap)
    want_d, want_c, want_aux = jmoe.top_k_routing(
        jnp.asarray(x), jax_get_smoke_config(ARCH).replace(n_experts=E, top_k=k), cap)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(want_d))
    np.testing.assert_allclose(combine.numpy(), np.asarray(want_c), atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6)
    assert int(dispatch.sum()) < 2 * 64 * k  # some picks are dropped


def test_index_dispatch_equals_one_hot_einsums(pair):
    """The MoE layer's index dispatch and combine equal the reference's
    einsums over top_k_routing's one-hot tensors, in the port."""
    _, _, model, params = pair()
    cfg = model.cfg
    p = moe.layer_params(params["moe_blocks"], 0)["moe"]
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((4, 16, cfg.d_model)).astype(np.float32))
    got, _ = moe.moe_ffn(p, x, cfg)
    xg = x.reshape(2, 32, cfg.d_model)
    dispatch, combine, _ = moe.top_k_routing(xg @ p["router"], cfg, moe.capacity(cfg, 32))
    expert_in = torch.einsum("gnec,gnd->egcd", dispatch.float(), xg)
    g = torch.einsum("egcd,edf->egcf", expert_in, p["wg"])
    h = torch.einsum("egcd,edf->egcf", expert_in, p["wi"])
    out = torch.einsum("egcf,efd->egcd", torch.nn.functional.silu(g) * h, p["wo"])
    want = torch.einsum("gnec,egcd->gnd", combine, out).reshape(4, 16, cfg.d_model)
    want = want + moe.swiglu(x, p["shared"]["wg"], p["shared"]["wi"], p["shared"]["wo"], torch.float32)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


# MoE stages per layer: norm, q/k/v, RoPE, attention, out projection,
# residual, norm, gate and up, SiLU product, down, gate weighting, combine
# with the shared experts, residual
MOE_BF16_STAGES = 14


def test_bf16_matches_reference():
    """bf16 prefill (2 × 16 tokens: one routing group) and decode at
    deepseek-moe-16b's real head width 128, where decode's q scale (0.0883789
    in bf16) is not a power of two, held to the bound from bf16 rounding."""
    cfg, steps = bf16_logits(ARCH, seq=16, head_dim=128)
    assert_bf16_logits_close(cfg, steps, MOE_BF16_STAGES)
