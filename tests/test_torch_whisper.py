"""The port's Whisper (the ``encdec`` family) against the JAX package, on the
CPU at smoke size; on a card, a small f32 Whisper against the CPU.

Weights come from the reference's own init, with its all-zero leaves (the
MLP and LayerNorm biases) redrawn and its all-one leaves (the LayerNorm
weights) perturbed, so that every term is live; they cross with
``repro_torch.convert.params_from_jax``. Frames and tokens come from seeded
numpy generators. The reference is called through its ``build_model(cfg)``
functions with no sharding rules (ROADMAP hazard H1). Its attention is its
XLA ``attention_chunked`` (not Pallas) at the smoke ``attn_chunk`` 8, so the
encoder's 24 frames and the prompts span several chunks.

Tolerances: f32 atol/rtol 1e-4 (the encoder, the prefill's logits and cache,
decode steps, every gradient leaf), 1e-5 for the loss and its metrics;
``sinusoid`` within two f32 rounding steps of its angle (the two libraries'
``exp`` and ``sin`` differ in the last bit); bf16 under
:func:`test_torch_model.assert_bf16_logits_close`'s bound (ROADMAP H8: the
reference rounds q's scale and the probabilities to bf16, the port's plain
attention does not).

JAX is imported inside a fixture, so that the card's machine, which has no
JAX, can run the ``gpu`` tests of this file (``python -m pytest -m gpu``).
"""

import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch.serve import ServeEngine, pad_cache_to
from repro_torch.models import common
from repro_torch.models import whisper as wh
from repro_torch.models.registry import build_model
from repro_torch.optim import make_optimizer
from repro_torch.training import make_train_step

ARCH = "whisper_small"
TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
B, S = 2, 12
ENC_LEN, D = 24, 64  # the smoke config's


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_get_smoke_config
    from repro.launch.serve import pad_cache_to as jax_pad_cache_to
    from repro.models import whisper as jwh
    from repro.models.registry import build_model as jax_build_model

    return types.SimpleNamespace(jax=jax, jnp=jnp, get_smoke_config=jax_get_smoke_config, build_model=jax_build_model,
                                 pad_cache_to=jax_pad_cache_to, wh=jwh)


def liven(np_params, seed=9):
    """Every all-zero leaf redrawn at 0.3 standard deviations and every
    all-one leaf at 1 + 0.1 standard deviations."""
    rng = np.random.default_rng(seed)

    def draw(a):
        if not a.any():
            return (rng.standard_normal(a.shape) * 0.3).astype(a.dtype)
        if (a == 1).all():
            return (1.0 + rng.standard_normal(a.shape) * 0.1).astype(a.dtype)
        return a

    return common.map_defs(draw, np_params)


@pytest.fixture(scope="module")
def pair(jx):
    """(reference model, reference params, port model, port params, numpy
    params) per dtype, built once."""
    built = {}

    def get(dtype="float32"):
        if dtype not in built:
            over = dict(dtype=dtype, param_dtype=dtype)
            ref_model = jx.build_model(jx.get_smoke_config(ARCH).replace(**over))
            np_params = liven(jx.jax.tree_util.tree_map(np.asarray, ref_model.init(jx.jax.random.PRNGKey(0))))
            ref_params = jx.jax.tree_util.tree_map(jx.jnp.asarray, np_params)
            model = build_model(get_smoke_config(ARCH).replace(**over))
            built[dtype] = (ref_model, ref_params, model, convert.params_from_jax(np_params, device="cpu"),
                            np_params)
        return built[dtype]

    return get


def frames(seed, batch=B, enc_len=ENC_LEN, d=D):
    return np.random.default_rng(seed).standard_normal((batch, enc_len, d)).astype(np.float32)


def tokens(seed, seq=S, batch=B, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq)).astype(np.int32)


def lm_batch(seed, batch=B, seq=S):
    toks = tokens(seed, seq, batch)
    labels = np.concatenate([toks[:, 1:], np.full((batch, 1), -100, np.int32)], axis=1)
    return {"frames": frames(seed + 100, batch), "tokens": toks, "labels": labels}


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **{**TOL, **tol})


# ---------------------------------------------------------------------------
# Functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim", [2, 3, 64, 768])
@pytest.mark.parametrize("positions", ["first_30", "enc_len_1500", "scattered"])
def test_sinusoid_matches_reference(jx, dim, positions):
    """[sin, cos] of f32 angles at the reference's frequencies (the divisor
    max(1, dim/2 − 1)). The two libraries' ``exp`` and ``sin`` round their last
    bit differently, so an entry may differ by two rounding steps of its
    angle (pos · freq) and of its value; a decode step's one position equals
    that row of the whole table bit for bit."""
    pos = {"first_30": np.arange(30), "enc_len_1500": np.arange(1500),
           "scattered": np.array([0, 1, 447, 1499, 32767])}[positions]
    got = wh.sinusoid(torch.from_numpy(pos), dim, torch.float32)
    want = np.asarray(jx.wh.sinusoid(jx.jnp.asarray(pos), dim, jx.jnp.float32))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (len(pos), 2 * (dim // 2))
    half = dim // 2
    freqs = np.exp(-np.log(1e4) * np.arange(half) / max(1, half - 1))
    angle = np.tile(pos[:, None] * freqs[None, :], 2)
    assert (np.abs(got.numpy() - want) <= 2 * 2**-23 * (angle + 1.0)).all()
    for p in pos[::7]:
        one = wh.sinusoid(torch.tensor([int(p)]), dim, torch.float32)
        assert torch.equal(one[0], got[list(pos).index(p)])
    bf = wh.sinusoid(torch.from_numpy(pos), dim, torch.bfloat16)
    assert bf.dtype == torch.bfloat16 and torch.equal(bf, got.to(torch.bfloat16))


def test_mlp_and_mha_match_reference(jx, pair):
    """``_mlp`` (tanh GELU, biases) and ``_mha`` (no biases) of one layer,
    cross-attention from 12 queries over the 24 frames, and its K and V."""
    ref_model, ref_params, model, params, _ = pair()
    rng = np.random.default_rng(3)
    x, mem = rng.standard_normal((B, S, D)).astype(np.float32), frames(4)
    jp = jx.jax.tree_util.tree_map(lambda a: a[0], ref_params["dec_blocks"])
    tp = common.map_defs(lambda a: a[0], params["dec_blocks"])
    close(wh._mlp(tp["mlp"], torch.from_numpy(x)), jx.wh._mlp(jp["mlp"], jx.jnp.asarray(x)))
    got = wh._mha(tp["cross_attn"], torch.from_numpy(x), torch.from_numpy(mem), model.cfg, causal=False, collect=True)
    want = jx.wh._mha(jp["cross_attn"], jx.jnp.asarray(x), jx.jnp.asarray(mem), ref_model.cfg, causal=False,
                      collect=True)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        close(g, w)


def test_encode_matches_reference(jx, pair):
    ref_model, ref_params, model, params, _ = pair()
    fr = frames(5)
    got = wh.encode(params, model.cfg, torch.from_numpy(fr))
    want = jx.jax.jit(lambda p, f: jx.wh.encode(p, ref_model.cfg, f))(ref_params, jx.jnp.asarray(fr))
    assert tuple(got.shape) == tuple(want.shape) == (B, ENC_LEN, D)
    close(got, want)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_every_grad_match_reference(jx, pair, remat):
    ref_model, ref_params, _, _, np_params = pair()
    batch = lm_batch(11)
    (jloss, jmetrics), jgrads = jx.jax.value_and_grad(ref_model.loss_fn, has_aux=True)(
        ref_params, jx.jax.tree_util.tree_map(jx.jnp.asarray, batch))
    model = build_model(get_smoke_config(ARCH).replace(remat=remat))
    leaves = common.map_defs(lambda p: p.requires_grad_(), convert.params_from_jax(np_params, device="cpu"))
    loss, metrics = model.loss_fn(leaves, {k: torch.from_numpy(v) for k, v in batch.items()})
    flat = [p for _, p in common.tree_leaves(leaves)]
    grads = dict(zip((k for k, _ in common.tree_leaves(leaves)), torch.autograd.grad(loss, flat)))
    close(loss, jloss, **LOSS_TOL)
    assert sorted(metrics) == sorted(jmetrics) == ["accuracy", "ce"]
    for k in jmetrics:
        close(metrics[k], jmetrics[k], **LOSS_TOL)
    want = dict(common.tree_leaves(jx.jax.tree_util.tree_map(np.asarray, jgrads)))
    assert sorted(grads) == sorted(want)
    assert any("cross_attn" in k for k in want) and any("enc_blocks" in k for k in want)
    for path, w in want.items():
        close(grads[path], w, err_msg=path, **TOL)


def test_loss_needs_the_frames_and_forward_is_the_loss_logits(pair):
    _, _, model, params, _ = pair()
    batch = {k: torch.from_numpy(v) for k, v in lm_batch(12).items()}
    with pytest.raises(KeyError):
        model.loss_fn(params, {k: v for k, v in batch.items() if k != "frames"})
    logits = model.forward_fn(params, batch["tokens"], frames=batch["frames"])
    assert tuple(logits.shape) == (B, S, 512)
    loss, _ = common.cross_entropy(logits, batch["labels"], z_loss=model.cfg.z_loss)
    assert torch.equal(loss, model.loss_fn(params, batch)[0])
    with pytest.raises(ValueError, match="frames"):
        model.forward_fn(params, batch["tokens"])
    with pytest.raises(ValueError, match="visual prefix"):
        model.forward_fn(params, batch["tokens"], patches=batch["frames"], frames=batch["frames"])
    dense = build_model(get_smoke_config("nbi-100m"))
    with pytest.raises(ValueError, match="takes no audio frames"):
        dense.forward_fn(dense.init(torch.Generator().manual_seed(0), "cpu"), batch["tokens"], frames=batch["frames"])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def prefilled(jx, pair):
    """Reference and port prefill outputs of one batch, computed once."""
    ref_model, ref_params, model, params, _ = pair()
    fr, toks = frames(6), tokens(7)
    want = jx.jax.jit(ref_model.prefill_fn)(ref_params, {"frames": jx.jnp.asarray(fr), "tokens": jx.jnp.asarray(toks)})
    got = model.prefill_fn(params, {"frames": torch.from_numpy(fr), "tokens": torch.from_numpy(toks)})
    return want, got, toks


def test_prefill_matches_reference(prefilled):
    (want_logits, want_cache), (logits, cache), _ = prefilled
    assert logits.shape == want_logits.shape == (B, 1, 512)
    close(logits, want_logits)
    assert set(cache) == set(want_cache) == {"self_k", "self_v", "cross_k", "cross_v"}
    shapes = {"self_k": (2, B, 4, S, 16), "cross_k": (2, B, 4, ENC_LEN, 16)}
    for name in cache:
        assert tuple(cache[name].shape) == tuple(want_cache[name].shape) == shapes[name.replace("_v", "_k")]
        close(cache[name], want_cache[name], err_msg=name)


def test_decode_steps_match_reference(jx, pair, prefilled):
    """Three greedy decode steps after the prefill, each side fed the
    reference's token, logits and every cache leaf after each step."""
    ref_model, ref_params, model, params, _ = pair()
    (want, ref_cache), (_, cache), _ = prefilled
    max_seq = S + 8
    ref_cache = jx.pad_cache_to(ref_cache, ref_model.cache_defs_fn(B, max_seq))
    cache = pad_cache_to(common.map_defs(torch.clone, cache), model.cache_defs_fn(B, max_seq))
    decode = jx.jax.jit(ref_model.decode_fn)
    for i in range(3):
        nxt = np.asarray(want, np.float32)[:, -1].argmax(-1)[:, None].astype(np.int32)
        want, ref_cache = decode(ref_params, ref_cache, jx.jnp.asarray(nxt), jx.jnp.asarray(S + i, jx.jnp.int32))
        got, cache = model.decode_fn(params, cache, torch.from_numpy(nxt), S + i)
        close(got, want, err_msg=f"step {i}")
        for name in cache:
            close(cache[name], ref_cache[name], err_msg=f"step {i} {name}")


def test_prefill_then_decode_matches_full_forward(pair):
    """The KV-cache law: each decode step's logits equal a full forward over
    the tokens so far, against the same frames."""
    _, _, model, params, _ = pair()
    fr, toks = torch.from_numpy(frames(8, batch=1)), torch.from_numpy(tokens(9, batch=1))
    last, cache = model.prefill_fn(params, {"frames": fr, "tokens": toks})
    cache = pad_cache_to(cache, model.cache_defs_fn(1, S + 8))
    for _ in range(3):
        nxt = last[:, -1].argmax(-1)[:, None]
        last, cache = model.decode_fn(params, cache, nxt, toks.shape[1])
        toks = torch.cat([toks, nxt], dim=1)
        full = model.forward_fn(params, toks, frames=fr)
        torch.testing.assert_close(last[:, -1], full[:, -1], **TOL)


def test_bf16_matches_reference(jx, pair):
    """bf16 prefill and three greedy decode steps under the bound of bf16
    rounding; each step feeds both sides the reference's token."""
    from test_torch_model import assert_bf16_logits_close

    ref_model, ref_params, model, params, _ = pair("bfloat16")
    fr, toks, seq = frames(13), tokens(14, seq=32), 32
    want, ref_cache = jx.jax.jit(ref_model.prefill_fn)(ref_params, {"frames": jx.jnp.asarray(fr),
                                                                    "tokens": jx.jnp.asarray(toks)})
    got, cache = model.prefill_fn(params, {"frames": torch.from_numpy(fr), "tokens": torch.from_numpy(toks)})
    assert cache["cross_k"].dtype == torch.bfloat16
    steps = [(got, want)]
    ref_cache = jx.pad_cache_to(ref_cache, ref_model.cache_defs_fn(B, seq + 3))
    cache = pad_cache_to(cache, model.cache_defs_fn(B, seq + 3))
    decode = jx.jax.jit(ref_model.decode_fn)
    for i in range(3):
        nxt = np.asarray(want, np.float32)[:, -1].argmax(-1)[:, None].astype(np.int32)
        want, ref_cache = decode(ref_params, ref_cache, jx.jnp.asarray(nxt), jx.jnp.asarray(seq + i, jx.jnp.int32))
        got, cache = model.decode_fn(params, cache, torch.from_numpy(nxt), seq + i)
        steps.append((got, want))
    # stages that round, an encoder layer and a decoder layer together (the
    # smoke config has as many of each): the encoder's norm, q/k/v,
    # attention, out projection, residual, norm, wi, + bi, GELU, wo, + bo,
    # residual (12); the decoder's the same with a cross-attention's norm,
    # q, k/v of the memory, attention, out projection and residual (18)
    assert_bf16_logits_close(model.cfg, steps, stages_per_layer=30)


def test_greedy_tokens_match_reference(jx, pair):
    """``ServeEngine`` on the smoke config against the reference's functions
    fed zero frames, as the reference's engine feeds them."""
    ref_model, ref_params, _, params, _ = pair()
    engine = ServeEngine(get_smoke_config(ARCH), batch=B, max_seq=32, device="cpu")
    engine.params = params
    prompts = tokens(15)
    got = engine.generate_batch(prompts, gen_len=6)
    prefill, decode = jx.jax.jit(ref_model.prefill_fn), jx.jax.jit(ref_model.decode_fn)
    zero = jx.jnp.zeros((B, ENC_LEN, D), jx.jnp.float32)
    logits, cache = prefill(ref_params, {"frames": zero, "tokens": jx.jnp.asarray(prompts)})
    cache = jx.pad_cache_to(cache, ref_model.cache_defs_fn(B, 32))
    want = np.zeros((B, 6), np.int32)
    for i in range(6):
        want[:, i] = np.asarray(jx.jnp.argmax(logits[:, -1], axis=-1))
        logits, cache = decode(ref_params, cache, jx.jnp.asarray(want[:, i : i + 1]), jx.jnp.asarray(S + i, jx.jnp.int32))
    np.testing.assert_array_equal(got, want)
    assert engine.stats["prefill_tokens"] == B * S and engine.stats["decode_tokens"] == B * 6


def test_pad_cache_to_keeps_the_cross_cache(jx):
    """The cross-attention K/V already have their decode shape (enc_len
    keys): they are only cast, as the reference's; the self-attention K/V are
    right-padded to max_seq."""
    model = build_model(get_smoke_config(ARCH).replace(dtype="bfloat16"))
    defs = model.cache_defs_fn(B, 20)
    assert tuple(defs["cross_k"].shape) == (2, B, 4, ENC_LEN, 16) and tuple(defs["self_k"].shape) == (2, B, 4, 20, 16)
    gen = torch.Generator().manual_seed(0)
    cache = {k: torch.randn((2, B, 4, ENC_LEN if k.startswith("cross") else S, 16), generator=gen) for k in defs}
    padded = pad_cache_to(cache, defs)
    ref_defs = jx.build_model(jx.get_smoke_config(ARCH).replace(dtype="bfloat16")).cache_defs_fn(B, 20)
    want = jx.pad_cache_to({k: jx.jnp.asarray(v.numpy()) for k, v in cache.items()}, ref_defs)
    for name, leaf in padded.items():
        assert leaf.dtype == torch.bfloat16 and leaf.shape == defs[name].shape
        np.testing.assert_array_equal(leaf.float().numpy(), np.asarray(want[name], np.float32))
    assert torch.equal(padded["cross_k"], cache["cross_k"].bfloat16())
    assert not padded["self_k"][..., S:, :].any()


def test_full_config_builds_with_its_cache_layout():
    cfg = get_config("whisper-small")
    model = build_model(cfg)
    assert model.cfg.vocab_size == 52224 and cfg.param_count() == model.cfg.replace(vocab_size=51865).param_count()
    defs = model.cache_defs_fn(8, 448)
    assert tuple(defs["self_k"].shape) == (12, 8, 12, 448, 64)
    assert tuple(defs["cross_v"].shape) == (12, 8, 12, 1500, 64) and defs["cross_v"].dtype == torch.bfloat16
    shapes = common.map_defs(lambda d: d.shape, model.param_defs)
    assert shapes["enc_blocks"]["attn"]["wq"] == (12, 768, 12, 64) and shapes["dec_blocks"]["mlp"]["bi"] == (12, 3072)
    assert "bq" not in shapes["dec_blocks"]["self_attn"]  # attention has no biases


def test_cpu_path_launches_no_kernel(pair):
    _, _, model, params, _ = pair()
    before = (tfa.bf16_launches, tfa.tf32_launches)
    model.prefill_fn(params, {"frames": torch.from_numpy(frames(16)), "tokens": torch.from_numpy(tokens(17))})
    assert (tfa.bf16_launches, tfa.tf32_launches) == before


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# the small f32 Whisper of chip_smoke.py's card-against-CPU check: 2 + 2
# layers, 2 heads of 64 (K1's f32 (64, 64) 3xTF32 kernel), a ragged
# 100-frame memory
SMALL = dict(n_layers=2, n_enc_layers=2, d_model=128, n_heads=2, n_kv_heads=2, d_ff=256, enc_len=100)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
def test_small_whisper_on_the_card_matches_the_cpu():
    """Prefill (the encoder, self- and cross-attention through K1's f32
    (64, 64) kernel) and one decode step of a small f32 Whisper, on the card
    and on the CPU from the same host-drawn weights: within 1e-4, with 6 K1
    launches (2 encoder, 2 self, 2 cross)."""
    _need_card()
    model = build_model(get_smoke_config(ARCH).replace(**SMALL))
    host = common.map_defs(lambda t: t if bool(t.any()) else 0.3 * torch.randn(t.shape),
                           model.init(torch.Generator().manual_seed(3), "cpu"))
    gen = torch.Generator().manual_seed(4)
    batch = {"frames": torch.randn((2, 100, 128), generator=gen), "tokens": torch.randint(0, 512, (2, 40), generator=gen)}
    outs = {}
    for dev in ("cuda", "cpu"):
        params = common.map_defs(lambda t: t.to(dev), host)
        before = tfa.tf32_launches
        with torch.inference_mode():
            last, cache = model.prefill_fn(params, {k: v.to(dev) for k, v in batch.items()})
            launched = tfa.tf32_launches - before
            cache = pad_cache_to(cache, model.cache_defs_fn(2, 48))
            step, _ = model.decode_fn(params, cache, torch.full((2, 1), 7, device=dev), 40)
        outs[dev] = (last.cpu(), step.cpu(), launched)
    assert outs["cuda"][2] == 6 and outs["cpu"][2] == 0
    for a, b in zip(outs["cuda"][:2], outs["cpu"][:2]):
        assert float((a - b).abs().max()) <= 1e-4


@pytest.mark.gpu
def test_small_whisper_train_step_on_the_card_matches_the_cpu():
    """One AdamW step of the small f32 Whisper under remat ``full`` on the
    card (12 K1 launches: the forward's 6 and the backward's recompute) and
    on the CPU: loss rtol 1e-5, grad norm rtol 1e-4, the clipped gradients
    (read from the first moment, 0.1 g) within 1e-4 of each leaf's largest."""
    _need_card()
    model = build_model(get_smoke_config(ARCH).replace(remat="full", **SMALL))
    opt = make_optimizer("adamw", lr=1e-3)
    host = common.map_defs(lambda t: t if bool(t.any()) else 0.3 * torch.randn(t.shape),
                           model.init(torch.Generator().manual_seed(3), "cpu"))
    batch = {k: torch.from_numpy(v) for k, v in lm_batch(5, batch=4, seq=64).items()}
    batch["frames"] = torch.from_numpy(frames(6, batch=4, enc_len=100, d=128))
    batch["tokens"], batch["labels"] = batch["tokens"].long(), batch["labels"].long()
    outs = {}
    for dev in ("cuda", "cpu"):
        params = common.map_defs(lambda t: t.to(dev), host)
        state = {"params": params, "opt": opt.init(params), "step": torch.zeros((), dtype=torch.int32, device=dev)}
        before = tfa.tf32_launches
        new_state, metrics = make_train_step(model, opt)(state, {k: v.to(dev) for k, v in batch.items()})
        outs[dev] = (float(metrics["loss"]), float(metrics["grad_norm"]), tfa.tf32_launches - before,
                     {p: t.cpu() / 0.1 for p, t in common.tree_leaves(new_state["opt"]["m"])})
    (loss_c, gn_c, n_c, g_c), (loss_h, gn_h, n_h, g_h) = outs["cuda"], outs["cpu"]
    assert (n_c, n_h) == (12, 0)
    assert loss_c == pytest.approx(loss_h, rel=1e-5) and gn_c == pytest.approx(gn_h, rel=1e-4)
    for k in g_h:
        assert float((g_c[k] - g_h[k]).abs().max()) <= 1e-4 * float(g_h[k].abs().max()) + 1e-30, k


def test_chip_smoke_counts_whisper_launches():
    """``chip_smoke.py``'s exact counts for whisper-small at full depth: 36
    bf16 K1 launches a prefill batch (12 encoder, 12 self-, 12
    cross-attentions) and none in decode; 72 a train step under remat
    ``full`` (the forward's 36 and the backward's recompute); no other
    kernel."""
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parent.parent)
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    cfg = get_config("whisper-small")
    serve = chip_smoke.expected_launches(cfg, {32: 5, 128: 8, 384: 3}, batch=8, gen_len=32)
    assert serve.pop("flash_attention_bf16") == 36 * (1 + 1 + 1) and not any(serve.values())
    train = chip_smoke.expected_train_launches(cfg, 8, 448, steps=10)
    assert train.pop("flash_attention_bf16") == 720 and not any(train.values())
