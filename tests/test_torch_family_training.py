"""Training of the MoE, RWKV-6 and Griffin families in the port against the
JAX package, on the CPU at smoke size; on a card, their train steps against
the CPU.

Inputs come from seeded numpy generators; weights come from the reference's
own init (its zero-initialised leaves redrawn, so that every term is live)
and cross with ``repro_torch.convert.params_from_jax``. The oracle is
``jax.value_and_grad(ref_model.loss_fn, has_aux=True)`` with no sharding
rules (ROADMAP hazard H1), and ``jax.vjp`` of the reference's
``repro.kernels.ops.lru_scan`` / ``wkv6`` with ``use_pallas=False``.

Tolerances: the loss, its metrics and every gradient leaf f32 atol/rtol
1e-4; ``ops.lru_scan`` 1e-5 and ``ops.wkv6`` atol 5e-4 / rtol 1e-3 (values
and gradients), ROADMAP's tolerances.

JAX is imported inside a fixture, so that the card's machine, which has no
JAX, can run the ``gpu`` tests of this file (``python -m pytest -m gpu``).
"""

import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import moe_gating as tgate
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as tlru
from repro_torch.kernels import rwkv6_scan as twkv
from repro_torch.models import common, moe
from repro_torch.models.registry import build_model
from repro_torch.optim import make_optimizer
from repro_torch.training import make_train_step

TOL = dict(atol=1e-4, rtol=1e-4)
LRU_TOL = dict(atol=1e-5, rtol=1e-5)
WKV_TOL = dict(atol=5e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_get_smoke_config
    from repro.kernels import ops as jops
    from repro.models.registry import build_model as jax_build_model

    return types.SimpleNamespace(jax=jax, jnp=jnp, ops=jops, get_smoke_config=jax_get_smoke_config,
                                 build_model=jax_build_model)


def draw(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **(tol or TOL))


def lm_batch(seed, B, S, vocab=512):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -100, np.int32)], axis=1)
    return {"tokens": tokens, "labels": labels}


def liven(np_params, seed=9):
    """The reference's numpy weights with every all-zero leaf (gates, biases,
    RWKV's mixes and bonus) redrawn at 0.3 standard deviations."""
    rng = np.random.default_rng(seed)
    return common.map_defs(
        lambda a: a if a.any() else (rng.standard_normal(a.shape) * 0.3).astype(a.dtype), np_params)


@pytest.fixture(scope="module")
def ref_pair(jx):
    """(reference model, reference params as jax arrays, livened numpy params)
    per arch, built once."""
    built = {}

    def get(arch):
        if arch not in built:
            ref_model = jx.build_model(jx.get_smoke_config(arch))
            np_params = liven(jx.jax.tree_util.tree_map(np.asarray, ref_model.init(jx.jax.random.PRNGKey(0))))
            built[arch] = (ref_model, jx.jax.tree_util.tree_map(jx.jnp.asarray, np_params), np_params)
        return built[arch]

    return get


def ref_value_and_grad(jx, ref_model, ref_params, batch):
    (loss, metrics), grads = jx.jax.value_and_grad(ref_model.loss_fn, has_aux=True)(
        ref_params, jx.jax.tree_util.tree_map(jx.jnp.asarray, batch))
    return loss, metrics, dict(common.tree_leaves(jx.jax.tree_util.tree_map(np.asarray, grads)))


def port_value_and_grad(model, np_params, batch):
    params = convert.params_from_jax(np_params, device="cpu")
    leaves = common.map_defs(lambda p: p.requires_grad_(), params)
    loss, metrics = model.loss_fn(leaves, {k: torch.from_numpy(v) for k, v in batch.items()})
    flat = [p for _, p in common.tree_leaves(leaves)]
    grads = torch.autograd.grad(loss, flat)
    return loss, metrics, {path: g for (path, _), g in zip(common.tree_leaves(leaves), grads)}


def assert_loss_and_grads_match(jx, ref_pair, arch, batch, **overrides):
    """The port's loss, metrics and every gradient leaf against the
    reference's value_and_grad, the same weights and batch; returns the port's
    gradients."""
    ref_model, ref_params, np_params = ref_pair(arch)
    jloss, jmetrics, jgrads = ref_value_and_grad(jx, ref_model, ref_params, batch)
    model = build_model(get_smoke_config(arch).replace(**overrides))
    loss, metrics, grads = port_value_and_grad(model, np_params, batch)
    close(loss, jloss)
    assert sorted(metrics) == sorted(jmetrics)
    for k in jmetrics:
        close(metrics[k], jmetrics[k])
    assert sorted(grads) == sorted(jgrads)
    for path, want in jgrads.items():
        close(grads[path], want, err_msg=path, **TOL)
    return grads


# ---------------------------------------------------------------------------
# The three families' losses and every gradient
# ---------------------------------------------------------------------------

# (arch, B, S): MoE's 2 x 16 tokens are one routing group of 32; RWKV-6 at
# S 64 and 128, one and two chunks of the gradient's chunked form (H4)
FAMILY_CASES = [("deepseek_moe_16b", 2, 16), ("kimi_k2_1t_a32b", 2, 16), ("rwkv6_7b", 2, 64),
                ("rwkv6_7b", 2, 128), ("recurrentgemma_2b", 2, 16)]


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch,B,S", FAMILY_CASES, ids=[f"{a}-S{s}" for a, _, s in FAMILY_CASES])
def test_family_loss_and_every_grad_match_reference(jx, ref_pair, arch, B, S, remat):
    """``build_model(cfg).loss_fn``'s loss, metrics (MoE's ``aux_loss`` too)
    and every gradient leaf, with remat ``none`` and ``full`` (the reference
    runs its own smoke config's, ``none``: remat recomputes, so the values do
    not change)."""
    assert_loss_and_grads_match(jx, ref_pair, arch, lm_batch(11, B, S), remat=remat)


def test_griffin_window_below_attn_chunk_grads_match_reference(jx, monkeypatch):
    """Griffin with a window (8) below attn_chunk (16): the local attention's
    backward recomputes ``attention_chunked`` at KV chunks of
    min(attn_chunk, window), as the reference's ``local_attention``, while
    the dense path keeps attn_chunk; every gradient matches the reference's
    at 32 tokens (four windows)."""
    arch = "recurrentgemma_2b"
    ref_model = jx.build_model(jx.get_smoke_config(arch).replace(attn_chunk=16))
    assert ref_model.cfg.window == 8
    np_params = liven(jx.jax.tree_util.tree_map(np.asarray, ref_model.init(jx.jax.random.PRNGKey(0))))
    built = (ref_model, jx.jax.tree_util.tree_map(jx.jnp.asarray, np_params), np_params)
    chunks = []
    real = ops.attention
    monkeypatch.setattr(ops, "attention", lambda *a, **kw: chunks.append(kw["kv_chunk"]) or real(*a, **kw))
    assert_loss_and_grads_match(jx, lambda _: built, arch, lm_batch(12, 2, 32), attn_chunk=16)
    assert chunks and set(chunks) == {8}
    chunks.clear()
    dense = build_model(get_smoke_config("nbi100m").replace(attn_chunk=16))
    dense.forward_fn(dense.init(torch.Generator().manual_seed(0), "cpu"), torch.zeros((1, 8), dtype=torch.long))
    assert set(chunks) == {16}


def test_router_grads_match_reference_where_picks_are_dropped(jx, ref_pair, monkeypatch):
    """deepseek-moe-16b's 4 x 16 batch: two routing groups of 32 at capacity
    10, where the gating drops picks. The routers' gradients (through the
    recomputed gates and the aux loss) and the aux loss match the
    reference's."""
    dropped = []
    real = moe.ops.moe_gating

    def record(logits, **kw):
        out = real(logits, **kw)
        dropped.append(int((out[2] < 0).sum()))
        return out

    monkeypatch.setattr(moe.ops, "moe_gating", record)
    grads = assert_loss_and_grads_match(jx, ref_pair, "deepseek_moe_16b", lm_batch(16, 4, 16))
    assert len(dropped) == 2 and sum(dropped) > 0
    router = grads["['moe_blocks']['moe']['router']"]
    assert router.shape == (2, 64, 8) and bool(router.abs().sum(dim=(1, 2)).gt(0).all())


def test_router_gates_are_the_kernel_picks_renormalised():
    """Under autograd the gates are the softmax at the gating's picks,
    renormalised, equal to the gating's own gates to an f32 rounding; under
    torch.no_grad they are the gating's gates, unchanged."""
    cfg = get_smoke_config("deepseek_moe_16b")
    (x,) = draw(17, (2, 32, 8))
    logits = torch.from_numpy(x).requires_grad_()
    idx, gate, pos = moe._routing(logits, cfg, 10)
    assert gate.grad_fn is not None and moe._aux_loss(logits, idx, pos >= 0).grad_fn is not None
    want_idx, want_gate, want_pos = ref.moe_gating_ref(logits.detach(), top_k=2, capacity=10)
    assert torch.equal(idx, want_idx) and torch.equal(pos, want_pos)
    torch.testing.assert_close(gate.detach(), want_gate, atol=1e-6, rtol=1e-6)
    with torch.no_grad():
        _, plain_gate, _ = moe._routing(logits, cfg, 10)
    assert torch.equal(plain_gate, want_gate)


def test_only_the_train_path_computes_the_aux_loss():
    """A routing computes the aux loss only where it is asked for (the
    training forward); serving's routings skip it and give the same output.
    The aux loss asked for is top_k_routing's, the reference's counterpart."""
    cfg = get_smoke_config("deepseek_moe_16b")
    E, D, F = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    xg, router, wg, wi, wo = draw(19, (2, 32, D), (D, E), (E, D, F), (E, D, F), (E, F, D), scale=0.5)
    p = {name: torch.from_numpy(w) for name, w in (("router", router), ("wg", wg), ("wi", wi), ("wo", wo))}
    xg = torch.from_numpy(xg)
    cap = moe.capacity(cfg, 32)
    y_serve, aux_serve = moe._route(p, xg, cfg, cap)
    y_train, aux_train = moe._route(p, xg, cfg, cap, aux=True)
    assert aux_serve is None and torch.equal(y_serve, y_train)
    _, _, want_aux = moe.top_k_routing(xg @ p["router"], cfg, cap)
    torch.testing.assert_close(aux_train, want_aux, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# ops.lru_scan and ops.wkv6 under autograd
# ---------------------------------------------------------------------------

# name: (B, T, W): T off every power of two, one step, one power of two
LRU_CASES = {"T37": (2, 37, 24), "T1": (2, 1, 8), "T64": (1, 64, 16)}


def lru_inputs(B, T, W, seed=30):
    a, b, h0, g_seq, g_final = draw(seed, (B, T, W), (B, T, W), (B, W), (B, T, W), (B, W))
    a = 1.0 / (1.0 + np.exp(-2.0 * a))  # in (0, 1), as exp(-c·softplus(Λ)·r)
    return a.astype(np.float32), b, h0, g_seq, g_final


@pytest.mark.parametrize("case", sorted(LRU_CASES))
def test_lru_scan_values_and_grads_match_reference(jx, case):
    """``ops.lru_scan``'s values and the gradients of a, b and h0 (the
    backward recomputing :func:`ops.lru_assoc`) against ``jax.vjp`` of the
    reference's XLA scan, at 1e-5."""
    a, b, h0, g_seq, g_final = lru_inputs(*LRU_CASES[case])
    ta, tb, th = (torch.from_numpy(x).requires_grad_() for x in (a, b, h0))
    seq, final = ops.lru_scan(ta, tb, th)
    assert seq.grad_fn is not None
    grads = torch.autograd.grad((seq, final), (ta, tb, th), (torch.from_numpy(g_seq), torch.from_numpy(g_final)))
    jnp = jx.jnp
    (jseq, jfinal), vjp = jx.jax.vjp(lambda *x: jx.ops.lru_scan(*x, use_pallas=False),
                                     *map(jnp.asarray, (a, b, h0)))
    for got, want in zip((seq, final, *grads), (jseq, jfinal, *vjp((jnp.asarray(g_seq), jnp.asarray(g_final))))):
        close(got, want, **LRU_TOL)


@pytest.mark.parametrize("T", [37, 64])
def test_lru_assoc_is_the_recurrence(T):
    """The backward's log-depth scan equals the recurrence token by token
    (``ref.lru_ref``) at 1e-5, with h0 folded into the first step."""
    a, b, h0, _, _ = lru_inputs(2, T, 16, seed=31)
    got = ops.lru_assoc(*map(torch.from_numpy, (a, b, h0)))
    want = ref.lru_ref(*map(torch.from_numpy, (a, b, h0)))
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, **LRU_TOL)


def wkv_inputs(B, H, T, d, seed=40):
    r, k, v, w, u, s0, gy, gs = draw(seed, (B, H, T, d), (B, H, T, d), (B, H, T, d), (B, H, T, d), (H, d),
                                     (B, H, d, d), (B, H, T, d), (B, H, d, d))
    w = np.exp(-np.exp(0.5 * w - 1.0)).astype(np.float32)  # decays in (0, 1), as exp(-exp(w0 + lora))
    return r, k, v, w, u, s0, gy, gs


# (B, H, T, d): under one chunk, one chunk, two chunks
@pytest.mark.parametrize("B,H,T,d", [(1, 2, 16, 8), (2, 2, 64, 16), (1, 3, 128, 8)])
def test_wkv6_values_and_grads_match_reference(jx, B, H, T, d):
    """``ops.wkv6``'s values and the gradients of r, k, v, w, u and s0 (the
    backward recomputing ``wkv6_chunked``) against ``jax.vjp`` of the
    reference's chunked form, at atol 5e-4 / rtol 1e-3."""
    r, k, v, w, u, s0, gy, gs = wkv_inputs(B, H, T, d)
    ts = [torch.from_numpy(x).requires_grad_() for x in (r, k, v, w, u, s0)]
    y, s = ops.wkv6(*ts)
    assert y.grad_fn is not None
    grads = torch.autograd.grad((y, s), ts, (torch.from_numpy(gy), torch.from_numpy(gs)))
    jnp = jx.jnp
    (jy, js), vjp = jx.jax.vjp(lambda *x: jx.ops.wkv6(*x, use_pallas=False), *map(jnp.asarray, (r, k, v, w, u, s0)))
    for got, want in zip((y, s, *grads), (jy, js, *vjp((jnp.asarray(gy), jnp.asarray(gs))))):
        close(got, want, **WKV_TOL)


def test_wkv6_refuses_a_gradient_its_chunked_form_cannot_chunk():
    """T = 100 is no multiple of min(64, T): under grad ``ops.wkv6`` raises
    before the forward (the backward's chunked form would fail); without grad
    the forward takes any T."""
    r, k, v, w, u, s0, _, _ = wkv_inputs(1, 2, 100, 8)
    ts = [torch.from_numpy(x) for x in (r, k, v, w, u, s0)]
    with pytest.raises(ValueError, match="T = 100"):
        ops.wkv6(*(t.clone().requires_grad_() for t in ts))
    y, _ = ops.wkv6(*ts)
    assert y.shape == (1, 2, 100, 8)


@pytest.mark.parametrize("op", ["lru_scan", "wkv6"])
def test_differentiable_scans_reach_the_kernel_off_the_cpu(op):
    """Off the CPU (``meta`` here, CUDA on the card) ``lru_scan`` and ``wkv6``
    take a tensor that requires grad to their kernel's path, with grad and
    without: no fallback to a plain version. On ``meta`` that is the
    kernel's meta route, which records one kernel call under a count (the
    plain version records none) and gives the kernel's outputs; the
    kernel's wrapper refuses a device that is not CUDA."""
    from repro_torch.analysis.opstats import count
    from repro_torch.kernels import rglru_scan, rwkv6_scan

    def args(requires_grad):
        t = lambda *s: torch.empty(s, device="meta", requires_grad=requires_grad)  # noqa: E731
        if op == "lru_scan":
            return t(1, 4, 8), t(1, 4, 8), t(1, 8)
        return t(1, 2, 4, 16), t(1, 2, 4, 16), t(1, 2, 4, 16), t(1, 2, 4, 16), t(2, 16), t(1, 2, 16, 16)

    wrapper = rglru_scan.lru_scan if op == "lru_scan" else rwkv6_scan.wkv6
    for requires_grad in (True, False):
        stats, (seq, state) = count(getattr(ops, op), *args(requires_grad))
        assert stats.kernel_calls == {op: 1} and seq.device.type == state.device.type == "meta"
        assert seq.requires_grad == requires_grad
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(*(t.detach() for t in args(requires_grad)))


# ---------------------------------------------------------------------------
# Train steps and the launcher
# ---------------------------------------------------------------------------


def test_moe_adamw_train_steps_match_reference(jx, ref_pair):
    """Three AdamW train steps of deepseek-moe-16b's smoke config against the
    reference's: loss, unclipped grad norm and params (atol 1e-4, as the
    dense family's check). Full batches only: routing groups span the
    batch's rows, so microbatching would route differently (H6)."""
    from test_torch_training import ref_train_steps

    ref_model, ref_params, np_params = ref_pair("deepseek_moe_16b")
    batches = [lm_batch(30 + i, B=4, S=16) for i in range(3)]
    from repro.optim import make_optimizer as jax_make_optimizer

    jp, _, jout = ref_train_steps(ref_model, ref_params, jax_make_optimizer("adamw", lr=1e-3), batches)
    model = build_model(get_smoke_config("deepseek_moe_16b"))
    optimizer = make_optimizer("adamw", lr=1e-3)
    params = convert.params_from_jax(np_params, device="cpu")
    state = {"params": params, "opt": optimizer.init(params), "step": torch.zeros((), dtype=torch.int32)}
    step = make_train_step(model, optimizer)
    for b, (jloss, jgnorm) in zip(batches, jout):
        state, metrics = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert metrics["loss"].item() == pytest.approx(jloss, rel=1e-5)
        assert metrics["grad_norm"].item() == pytest.approx(jgnorm, rel=1e-4)
        assert "aux_loss" in metrics
    got = dict(common.tree_leaves(convert.params_to_numpy(state["params"])))
    for path, want in common.tree_leaves(jx.jax.tree_util.tree_map(np.asarray, jp)):
        np.testing.assert_allclose(got[path], want, atol=1e-4, rtol=0, err_msg=path)


# one config a family: kimi-k2-1t-a32b's 8-bit AdamW diverges after its first
# steps in both packages (a second moment quantised to 0 gives an update of
# m / eps), so the launcher's loss-falls test runs deepseek-moe-16b's AdamW;
# then the dense family's MLA and visual prefix (llava on text only: the data
# pipeline makes no patches, as the reference's), codeqwen1.5-7b, and
# mistral-large-123b's smoke config over its 2 microbatches
TRAIN_ARCHS = ["deepseek-moe-16b", "rwkv6-7b", "recurrentgemma-2b", "minicpm3-4b", "llava-next-mistral-7b",
               "codeqwen1.5-7b", "mistral-large-123b"]


def run_train(arch, *argv):
    from repro_torch.launch.train import build_argparser, train

    return train(build_argparser().parse_args(["--arch", arch, "--smoke", "--device", "cpu", *map(str, argv)]))


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_driver_trains_each_family(arch, capsys):
    """``repro_torch.launch.train --arch ARCH --smoke --device cpu``: 30 steps
    of 4 x 32 tokens, the loss falls; MoE logs its aux loss."""
    result = run_train(arch, "--steps", 30, "--global-batch", 4, "--seq", 32, "--log-every", 10, "--lr", 1e-3)
    losses = [m["loss"] for m in result["metrics"]]
    assert result["completed_steps"] == 30 and len(losses) == 3 and losses[-1] < losses[0]
    out = capsys.readouterr().out
    assert ("aux_loss=" in out) == (arch == "deepseek-moe-16b")


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_driver_resume_is_bitwise_for_each_family(arch, tmp_path):
    """10 straight steps ≡ 5 steps + checkpoint + restart + 5 steps, bitwise
    on every leaf of the train state."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.training import init_train_state

    def run(steps, name, every):
        return run_train(arch, "--steps", steps, "--global-batch", 2, "--seq", 32, "--ckpt-dir", tmp_path / name,
                         "--ckpt-every", every, "--log-every", 100)

    run(10, "straight", 10)
    run(5, "split", 5)
    run(10, "split", 5)
    model = build_model(get_smoke_config(arch))
    trees = {}
    for name in ("straight", "split"):
        manager = CheckpointManager(tmp_path / name)
        assert manager.latest_step() == 10
        target = init_train_state(model, make_optimizer(model.cfg.optimizer), torch.Generator().manual_seed(0), "cpu")
        trees[name], extra, _ = manager.restore(target)
        assert extra["data_cursor"] == 10
    for (pa, a), (pb, b) in zip(common.tree_leaves(trees["straight"]), common.tree_leaves(trees["split"])):
        assert pa == pb and torch.equal(a, b), pa


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
def test_lru_scan_grads_on_the_card_match_the_cpu():
    """f32 ``ops.lru_scan`` under autograd: the forward is one launch of the
    LRU kernel, the backward the associative scan recomputed (no launch);
    values and gradients agree with the CPU's at 1e-5."""
    _need_card()
    arrays = lru_inputs(2, 300, 96)
    results = {}
    for dev in ("cuda", "cpu"):
        ts = [torch.from_numpy(x).to(dev).requires_grad_() for x in arrays[:3]]
        before = tlru.launches
        seq, final = ops.lru_scan(*ts)
        grads = torch.autograd.grad((seq, final), ts, tuple(torch.from_numpy(x).to(dev) for x in arrays[3:]))
        torch.cuda.synchronize()
        assert tlru.launches == before + (dev == "cuda")
        results[dev] = [t.cpu() for t in (seq, final, *grads)]
    for got, want in zip(results["cuda"], results["cpu"]):
        torch.testing.assert_close(got, want, **LRU_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_wkv6_grads_on_the_card_match_the_cpu(dtype_name):
    """``ops.wkv6`` at RWKV-6's head size 64 under autograd: one launch of the
    WKV kernel, the backward the chunked form recomputed (no launch). f32 at
    WKV's atol 5e-4 / rtol 1e-3; bf16 values to one bf16 rounding and
    gradients at atol 0.05 plus two rounding steps relative."""
    _need_card()
    dt = getattr(torch, dtype_name)
    arrays = wkv_inputs(1, 2, 128, 64, seed=41)
    results = {}
    for dev in ("cuda", "cpu"):
        ts = [torch.from_numpy(x).to(dev, dt if i < 4 else torch.float32).requires_grad_()
              for i, x in enumerate(arrays[:6])]
        before = twkv.launches
        y, s = ops.wkv6(*ts)
        grads = torch.autograd.grad((y, s), ts, (torch.from_numpy(arrays[6]).to(dev, dt),
                                                 torch.from_numpy(arrays[7]).to(dev)))
        torch.cuda.synchronize()
        assert twkv.launches == before + (dev == "cuda")
        results[dev] = [t.float().cpu() for t in (y, s, *grads)]
    tol = WKV_TOL if dt == torch.float32 else dict(atol=0.05, rtol=2**-6)
    for got, want in zip(results["cuda"], results["cpu"]):
        torch.testing.assert_close(got, want, **tol)


@pytest.mark.gpu
def test_moe_gating_still_refuses_grad_on_the_card():
    """The gating kernel has no backward: on the card it raises for logits
    that require grad, and routes detached logits."""
    _need_card()
    logits = torch.randn((1, 64, 8), device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.moe_gating(logits, top_k=2, capacity=20)
    before = tgate.launches
    ops.moe_gating(logits.detach(), top_k=2, capacity=20)
    assert tgate.launches == before + 1


# small f32 models with the kernels' real head widths: arch, overrides, batch
# x sequence of the train step
CARD_TRAIN_MODELS = {
    "deepseek-moe-16b": (dict(d_model=128, n_heads=2, n_kv_heads=2, head_dim=128, d_ff=256, moe_d_ff=64,
                              n_experts=64, top_k=6, moe_group_tokens=32), (4, 64)),
    "rwkv6-7b": (dict(d_model=128, n_heads=2, n_kv_heads=2, rwkv_head_size=64, d_ff=256), (2, 128)),
    "recurrentgemma-2b": (dict(d_model=256, n_heads=2, n_kv_heads=1, head_dim=256, lru_width=256, d_ff=512,
                               window=16), (2, 64)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", sorted(CARD_TRAIN_MODELS))
def test_family_train_step_on_the_card_matches_the_cpu(arch):
    """One AdamW train step of a small f32 model of each family from the same
    host-drawn weights and batch on the card (its kernels in the forward,
    remat ``full``) and on the CPU: loss rtol 1e-5, grad norm rtol 1e-4, the
    clipped gradients (read from the first moment, 0.1 g) within 1e-4 of
    each leaf's largest."""
    _need_card()
    overrides, (B, S) = CARD_TRAIN_MODELS[arch]
    model = build_model(get_smoke_config(arch).replace(remat="full", **overrides))
    opt = make_optimizer("adamw", lr=1e-3)
    host_params = model.init(torch.Generator().manual_seed(3), "cpu")
    host_params = common.map_defs(lambda t: t if bool(t.any()) else 0.3 * torch.randn(t.shape), host_params)
    batch = {k: torch.from_numpy(v).long() for k, v in lm_batch(5, B, S).items()}
    outs = {}
    for dev in ("cuda", "cpu"):
        params = common.map_defs(lambda t: t.to(dev), host_params)
        state = {"params": params, "opt": opt.init(params), "step": torch.zeros((), dtype=torch.int32, device=dev)}
        new_state, metrics = make_train_step(model, opt)(state, {k: v.to(dev) for k, v in batch.items()})
        outs[dev] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                     {p: t.cpu() / 0.1 for p, t in common.tree_leaves(new_state["opt"]["m"])})
    (loss_c, gn_c, g_c), (loss_h, gn_h, g_h) = outs["cuda"], outs["cpu"]
    assert loss_c == pytest.approx(loss_h, rel=1e-5) and gn_c == pytest.approx(gn_h, rel=1e-4)
    for k in g_h:
        assert float((g_c[k] - g_h[k]).abs().max()) <= 1e-4 * float(g_h[k].abs().max()) + 1e-30, k
