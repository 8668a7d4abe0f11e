"""The port's training path against the JAX package, on the CPU at smoke size.

Inputs come from seeded numpy generators; weights and train states come from
the reference's own init and cross with :mod:`repro_torch.convert`. Reference
gradients and updates are ``jax.value_and_grad(ref_model.loss_fn)`` and the
reference optimizer's ``update`` called directly, with no sharding rules
(its mesh-built paths fail under this JAX version, ROADMAP hazard H1).

Tolerances: the loss and its metrics f32 1e-6; ``attention_chunked`` f32
atol 2e-5 / rtol 1e-4 and bf16 atol 0.05 (values and q/k/v gradients);
RMSNorm gradients 1e-5; the dense loss and every parameter gradient 1e-4;
optimizer updates 1e-6 (8-bit moments exact, or one step apart where the
reference and the port round a value that sits on a tie differently).
"""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.core.eco import EcoScheduler
from repro.models import common as jcommon
from repro.models.registry import build_model as jax_build_model
from repro.optim import constant as jax_constant
from repro.optim import cosine_warmup as jax_cosine_warmup
from repro.optim import make_optimizer as jax_make_optimizer
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.registry import build_model
from repro_torch.optim import constant, cosine_warmup, make_optimizer
from repro_torch.training import make_train_step

F32 = dict(atol=2e-5, rtol=1e-4)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


def draw(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

CE_CASES = {
    # (B, S, V, rows of -100 labels, logit scale)
    "masked_rows": (3, 7, 512, (1,), 3.0),
    "no_mask": (2, 5, 96, (), 1.0),
    "all_masked": (2, 4, 64, (0, 1), 1.0),
}


@pytest.mark.parametrize("case", sorted(CE_CASES) + ["argmax_ties_on_padded_vocab"])
def test_cross_entropy_matches_reference(case):
    if case == "argmax_ties_on_padded_vocab":
        # 500 real tokens padded to 512; every row's maximum is tied between a
        # real and a padded entry, so the first index must win as in JAX
        rng = np.random.default_rng(3)
        logits = rng.standard_normal((2, 6, 512)).astype(np.float32)
        labels = rng.integers(0, 500, (2, 6)).astype(np.int32)
        logits[..., 505] = 9.0
        logits[..., labels[0, 0]] = 9.0
        logits[1, 2, 3] = 9.0
        labels[1, 2] = 3
    else:
        B, S, V, masked, scale = CE_CASES[case]
        (logits,) = draw(1, (B, S, V), scale=scale)
        labels = np.random.default_rng(2).integers(0, V, (B, S)).astype(np.int32)
        for r in masked:
            labels[r] = -100
    loss, metrics = common.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), z_loss=1e-4)
    jloss, jmetrics = jcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), z_loss=1e-4)
    close(loss, jloss, atol=1e-6, rtol=1e-6)
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        close(metrics[k], jmetrics[k], atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# attention_chunked and the autograd Functions of ops
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # (B, Hq, Hkv, Sq, Skv, d, causal, window, q_offset, cap, kv_chunk)
    "causal": (2, 4, 4, 32, 32, 16, True, 0, 0, 0.0, 8),
    "causal_gqa": (1, 6, 2, 24, 24, 16, True, 0, 0, 0.0, 8),
    "window": (1, 4, 2, 40, 40, 16, True, 12, 0, 0.0, 8),
    "logit_cap": (2, 2, 2, 16, 16, 32, True, 0, 0, 5.0, 8),
    "ragged": (1, 4, 4, 21, 21, 16, True, 0, 0, 0.0, 8),
    "ragged_cross": (2, 4, 2, 9, 19, 16, False, 0, 0, 0.0, 8),
    "q_offset": (1, 4, 4, 8, 24, 16, True, 0, 16, 0.0, 8),
    "one_chunk": (1, 2, 1, 12, 12, 16, True, 0, 0, 0.0, 1024),
}


def _attn_inputs(case, dtype_name):
    B, Hq, Hkv, Sq, Skv, d, *_ = ATTN_CASES[case]
    q, k, v, g = draw(5, (B, Hq, Sq, d), (B, Hkv, Skv, d), (B, Hkv, Skv, d), (B, Hq, Sq, d))
    if dtype_name == "bfloat16":  # the bf16 values themselves, in f32 (exact widening)
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32) for a in (q, k, v))
    return q, k, v, g


def _ref_attention(case, dtype_name, q, k, v, g):
    *_, causal, window, q_offset, cap, chunk = ATTN_CASES[case]
    dt = jnp.dtype(dtype_name)

    def f(q, k, v):
        return jcommon.attention_chunked(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                         kv_chunk=chunk, logit_cap=cap)

    out, vjp = jax.vjp(f, *(jnp.asarray(a, dt) for a in (q, k, v)))
    return (out, *vjp(jnp.asarray(g, dt)))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_chunked_values_and_grads_match_reference(case, dtype_name):
    *_, causal, window, q_offset, cap, chunk = ATTN_CASES[case]
    q, k, v, g = _attn_inputs(case, dtype_name)
    dt = getattr(torch, dtype_name)
    leaves = [torch.from_numpy(a).to(dt).requires_grad_() for a in (q, k, v)]
    out = common.attention_chunked(*leaves, causal=causal, window=window, q_offset=q_offset,
                                   kv_chunk=chunk, logit_cap=cap)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g).to(dt))
    want = _ref_attention(case, dtype_name, q, k, v, g)
    assert out.dtype == dt
    tol = F32 if dtype_name == "float32" else dict(atol=0.05, rtol=0.0)
    for got, ref in zip((out, *grads), want):
        close(got, np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("case", [c for c in sorted(ATTN_CASES) if ATTN_CASES[c][8] == 0])
def test_ops_attention_grad_is_the_reference_recompute(case):
    """``ops.attention`` on the CPU: the plain forward, and the gradient of
    ``attention_chunked`` recomputed from the saved inputs (the reference's
    ``_attention_bwd``)."""
    *_, causal, window, _, cap, chunk = ATTN_CASES[case]
    q, k, v, g = _attn_inputs(case, "float32")
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ops.attention(*leaves, causal=causal, window=window, logit_cap=cap, kv_chunk=chunk)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    want = _ref_attention(case, "float32", q, k, v, g)
    for got, ref in zip((out, *grads), want):
        close(got, ref, **F32)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_ops_rmsnorm_grads_match_reference(dtype_name):
    x, w, g = draw(8, (3, 5, 48), (48,), (3, 5, 48))
    w = 1.0 + 0.3 * w
    dt = getattr(torch, dtype_name)
    jdt = jnp.dtype(dtype_name)
    xt, wt = torch.from_numpy(x).to(dt).requires_grad_(), torch.from_numpy(w).requires_grad_()
    out = ops.rmsnorm(xt, wt)
    assert out.grad_fn is not None and out.dtype == dt
    dx, dw = torch.autograd.grad(out, (xt, wt), torch.from_numpy(g).to(dt))
    jout, vjp = jax.vjp(jcommon.rms_norm, jnp.asarray(x, jdt), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g, jdt))
    tol = dict(atol=1e-5, rtol=1e-5) if dtype_name == "float32" else dict(atol=0.05, rtol=2**-7)
    for got, want in ((out, jout), (dx, jdx), (dw, jdw)):
        close(got, np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("op", ["moe_gating"])
def test_forward_only_ops_raise_off_the_cpu_when_grad_is_required(op):
    """Off the CPU (``meta`` here, CUDA on the card) the gating kernel, which
    has no backward, refuses a tensor that requires grad instead of returning
    a result cut from the graph; without grad it takes the kernel's path:
    on ``meta`` the kernel's meta route, which records one kernel call under
    a count (the plain version records none), and the kernel's wrapper
    refuses a device that is not CUDA. (``lru_scan`` and ``wkv6`` have a
    backward: their cases are in tests/test_torch_family_training.py.)"""
    from repro_torch.analysis.opstats import count
    from repro_torch.kernels import moe_gating as gating_kernel

    def args(requires_grad):
        t = lambda *s: torch.empty(s, device="meta", requires_grad=requires_grad)  # noqa: E731
        return (t(1, 8, 4),), dict(top_k=2, capacity=4)

    a, kw = args(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        getattr(ops, op)(*a, **kw)
    a, kw = args(False)
    assert count(lambda x: getattr(ops, op)(x, **kw), *a)[0].kernel_calls == {op: 1}
    with pytest.raises(ValueError, match="CUDA"):  # the kernel's wrapper: meta is not a CUDA device
        gating_kernel.moe_gating(*a, **kw)
    with torch.no_grad():
        a, kw = args(True)
        assert count(lambda x: getattr(ops, op)(x, **kw), *a)[0].kernel_calls == {op: 1}


# ---------------------------------------------------------------------------
# The dense loss and its gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dense_pair():
    built = {}

    def get(arch):
        if arch not in built:
            ref_model = jax_build_model(jax_get_smoke_config(arch))
            ref_params = ref_model.init(jax.random.PRNGKey(0))
            built[arch] = (ref_model, ref_params, to_numpy(ref_params))
        return built[arch]

    return get


def lm_batch(seed, B=2, S=16, vocab=512):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -100, np.int32)], axis=1)
    return {"tokens": tokens, "labels": labels}


def port_value_and_grad(model, np_params, batch):
    params = convert.params_from_jax(np_params, device="cpu")
    leaves = common.map_defs(lambda p: p.requires_grad_(), params)
    loss, metrics = model.loss_fn(leaves, {k: torch.from_numpy(v) for k, v in batch.items()})
    flat = [p for _, p in common.tree_leaves(leaves)]
    grads = torch.autograd.grad(loss, flat)
    return loss, metrics, common.tree_unflatten(leaves, grads)


@pytest.mark.parametrize("arch,remat", [("nbi100m", "none"), ("nbi100m", "full"), ("nbi100m", "selective"),
                                        ("codeqwen15_7b", "none")])
def test_dense_loss_and_every_grad_match_reference(dense_pair, arch, remat):
    ref_model, ref_params, np_params = dense_pair(arch)
    batch = lm_batch(11)
    (jloss, jmetrics), jgrads = jax.value_and_grad(ref_model.loss_fn, has_aux=True)(ref_params, to_jax(batch))
    model = build_model(get_smoke_config(arch).replace(remat=remat))
    loss, metrics, grads = port_value_and_grad(model, np_params, batch)
    close(loss, jloss, atol=1e-4, rtol=1e-4)
    for k in jmetrics:
        close(metrics[k], jmetrics[k], atol=1e-4, rtol=1e-4)
    want = dict(common.tree_leaves(to_numpy(jgrads)))
    got = dict(common.tree_leaves(grads))
    assert sorted(got) == sorted(want)
    for path in want:
        close(got[path], want[path], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("family_arch", ["whisper_small"])
def test_loss_fn_of_unported_families_raises(family_arch):
    """Every family trains now, Whisper's ``encdec`` the last (its gradients
    are held in tests/test_torch_whisper.py): the reference's config, copied
    field by field into the port's ArchConfig, builds, and its ``loss_fn``
    on the reference's weights and a seeded batch equals the reference's."""
    import dataclasses

    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    from repro_torch.models.config import ArchConfig

    cfg = ArchConfig(**dataclasses.asdict(jax_get_config(family_arch)))
    assert cfg.family == "encdec" and cfg == get_config(family_arch)
    small = dict(n_layers=1, n_enc_layers=1, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512,
                 enc_len=24, attn_chunk=8, param_dtype="float32", dtype="float32")
    ref_model = jax_build_model(jax_get_config(family_arch).replace(**small))
    model = build_model(cfg.replace(**small))
    assert model.cfg.family == "encdec" and model.cfg.remat == "full"
    np_params = to_numpy(ref_model.init(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(12)
    batch = {**lm_batch(12), "frames": rng.standard_normal((2, 24, 64)).astype(np.float32)}
    jloss, jmetrics = ref_model.loss_fn(to_jax(np_params), to_jax(batch))
    loss, metrics = model.loss_fn(convert.params_from_jax(np_params, device="cpu"),
                                  {k: torch.from_numpy(v) for k, v in batch.items()})
    close(loss, jloss, atol=1e-5, rtol=1e-5)
    for k in jmetrics:
        close(metrics[k], jmetrics[k], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Optimizers and schedules
# ---------------------------------------------------------------------------


def opt_params():
    a, b, c = draw(21, (6, 40), (40,), (3, 5, 8))
    return {"w": a, "blocks": {"ln": 1.0 + 0.1 * b, "proj": c}}


def three_updates(name, sched_jax, sched_port):
    """The same three gradient trees through the reference's and the port's
    optimizer; returns (reference (params, state), port (params, state))."""
    params = opt_params()
    jo = jax_make_optimizer(name, lr=sched_jax)
    po = make_optimizer(name, lr=sched_port)
    jp, pp = to_jax(params), convert.params_from_jax(params, device="cpu")
    js, ps = jo.init(jp), po.init(pp)
    rng = np.random.default_rng(22)
    for i in range(3):
        # the last update's grads exceed the clip norm of 1
        g = jax.tree_util.tree_map(lambda x: (rng.standard_normal(x.shape) * (0.01 if i < 2 else 1.0))
                                   .astype(np.float32), params)
        jp, js = jo.update(to_jax(g), js, jp)
        pp, ps = po.update(convert.params_from_jax(g, device="cpu"), ps, pp)
    return (to_numpy(jp), to_numpy(js)), (convert.params_to_numpy(pp), convert.params_to_numpy(ps))


@pytest.mark.parametrize("name", ["adamw", "adamw8bit", "lion"])
def test_three_updates_match_reference(name):
    (jp, js), (pp, ps) = three_updates(name, jax_cosine_warmup(1e-2, 2, 10), cosine_warmup(1e-2, 2, 10))
    for path, want in common.tree_leaves(jp):
        np.testing.assert_allclose(dict(common.tree_leaves(pp))[path], want, atol=1e-6, rtol=1e-6)
    want_state, got_state = dict(common.tree_leaves(js)), dict(common.tree_leaves(ps))
    assert sorted(got_state) == sorted(want_state)
    ties = 0
    for path, want in want_state.items():
        got = got_state[path]
        assert got.dtype == want.dtype and got.shape == want.shape, path
        if want.dtype == np.int8:
            # exact, or one step apart where a value sits on a rounding tie
            # that an f32 rounding difference moves across (none of the 800
            # entries here is: the run on this host is exact)
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1, path
            ties += int((diff == 1).sum())
        elif want.dtype == np.int32:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert ties <= 2, f"{ties} int8 moment entries one step apart"


def test_optimizer_state_has_the_reference_tree():
    params = opt_params()
    for name in ("adamw", "adamw8bit", "lion"):
        want = jax_make_optimizer(name).init(to_jax(params))
        got = make_optimizer(name).init(convert.params_from_jax(params, device="cpu"))
        w, g = common.tree_leaves(to_numpy(want)), common.tree_leaves(convert.params_to_numpy(got))
        assert [(p, a.shape, a.dtype) for p, a in w] == [(p, a.shape, a.dtype) for p, a in g], name


SCHEDULES = {
    # (peak, warmup, total, floor); steps 0 .. total + 20
    "short": (3e-4, 10, 30, 0.0),
    "floor": (1e-3, 10, 100, 1e-4),
    "long": (3e-4, 20, 300, 1e-5),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_schedules_match_reference(case):
    """``constant`` and the warmup are exact in f32. The cosine is the
    correctly rounded one: it equals XLA's f32 cos except where that is not
    correctly rounded, then one unit in the last place away (0, 1 and 3
    steps of these three runs), which moves the lr by at most
    (peak - floor)·2⁻²³."""
    peak, warmup, total, floor = SCHEDULES[case]
    steps = np.arange(total + 20, dtype=np.int32)
    js, ps = jax_cosine_warmup(peak, warmup, total, floor), cosine_warmup(peak, warmup, total, floor)
    want = np.array([np.float32(js(jnp.asarray(s))) for s in steps])
    got = np.array([ps(torch.tensor(int(s), dtype=torch.int32)).item() for s in steps], np.float32)
    np.testing.assert_array_equal(got[:warmup], want[:warmup])
    np.testing.assert_allclose(got, want, rtol=0, atol=(peak - floor) * 2**-23)
    assert (got != want).sum() <= 3
    const = np.array([constant(peak)(torch.tensor(int(s))).item() for s in steps[:5]], np.float32)
    np.testing.assert_array_equal(const, [np.float32(jax_constant(peak)(jnp.asarray(s))) for s in steps[:5]])


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------


def ref_train_steps(ref_model, ref_params, optimizer, batches):
    """The reference's train step without a mesh: value_and_grad of loss_fn,
    f32 grads, the optimizer's update, the unclipped grad norm."""
    params, opt = ref_params, optimizer.init(ref_params)
    out = []
    for b in batches:
        (loss, _), grads = jax.value_and_grad(ref_model.loss_fn, has_aux=True)(params, to_jax(b))
        grads = jax.tree_util.tree_map(lambda g: g.astype(jnp.float32), grads)
        params, opt = optimizer.update(grads, opt, params)
        gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(g)) for g in jax.tree_util.tree_leaves(grads)))
        out.append((float(loss), float(gnorm)))
    return params, opt, out


@pytest.mark.parametrize("opt_name", ["adamw", "adamw8bit", "lion"])
def test_train_steps_match_reference(dense_pair, opt_name):
    """Three train steps (one for 8-bit AdamW) of the port against the
    reference's loss, unclipped grad norm and params. Params: atol 1e-4, a
    tenth of one lr=1e-3 update, as the reference's own microbatch check
    allows, since Adam's m/√v̂ amplifies f32 reassociation noise where a
    gradient is near 0. 8-bit AdamW stops at one step: after it, a ``v`` entry
    quantised to 0 gives an update of m/eps, so an int8 moment one step apart
    on a rounding tie sends the two runs apart (0.036 in a param after the
    second step, 2.7 after the third)."""
    ref_model, ref_params, np_params = dense_pair("nbi100m")
    batches = [lm_batch(30 + i, B=4) for i in range(1 if opt_name == "adamw8bit" else 3)]
    jp, jopt, jout = ref_train_steps(ref_model, ref_params, jax_make_optimizer(opt_name, lr=1e-3), batches)

    model = build_model(get_smoke_config("nbi100m"))
    optimizer = make_optimizer(opt_name, lr=1e-3)
    params = convert.params_from_jax(np_params, device="cpu")
    state = {"params": params, "opt": optimizer.init(params), "step": torch.zeros((), dtype=torch.int32)}
    step = make_train_step(model, optimizer)
    for b, (jloss, jgnorm) in zip(batches, jout):
        state, metrics = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert metrics["loss"].item() == pytest.approx(jloss, rel=1e-5)
        assert metrics["grad_norm"].item() == pytest.approx(jgnorm, rel=1e-4)
    assert int(state["step"]) == len(batches) and state["step"].dtype == torch.int32
    got = dict(common.tree_leaves(convert.params_to_numpy(state["params"])))
    for path, want in common.tree_leaves(to_numpy(jp)):
        np.testing.assert_allclose(got[path], want, atol=1e-4, rtol=0, err_msg=path)


def test_microbatched_equals_full_batch():
    """mb=4 gradient accumulation reproduces the mb=1 update (the tolerances
    of tests/test_training.py's reference check)."""
    cfg = get_smoke_config("codeqwen15_7b")
    batch = {"tokens": torch.arange(16, dtype=torch.int32)[None].repeat(8, 1),
             "labels": torch.arange(16, dtype=torch.int32)[None].repeat(8, 1)}
    results = {}
    for mb in (1, 4):
        model = build_model(cfg.replace(microbatch=mb))
        opt = make_optimizer("adamw", lr=1e-3)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        state = {"params": params, "opt": opt.init(params), "step": torch.zeros((), dtype=torch.int32)}
        new_state, metrics = make_train_step(model, opt)(state, batch)
        results[mb] = (new_state["params"], float(metrics["loss"]))
    np.testing.assert_allclose(results[1][1], results[4][1], rtol=1e-5)
    for (_, a), (_, b) in zip(common.tree_leaves(results[1][0]), common.tree_leaves(results[4][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4)


@pytest.mark.parametrize("opt_name", ["adamw", "adamw8bit", "lion"])
def test_train_state_crosses_both_ways(opt_name):
    """A reference train state (params, optimizer state, step) through
    ``convert`` into tensors and back is unchanged, leaf by leaf and dtype by
    dtype."""
    from repro.training.steps import init_train_state as jax_init_train_state

    cfg = jax_get_smoke_config("nbi100m").replace(param_dtype="bfloat16")
    jstate = jax_init_train_state(jax_build_model(cfg), jax_make_optimizer(opt_name), jax.random.PRNGKey(1))
    np_state = to_numpy(jstate)
    state = convert.params_from_jax(np_state, device="cpu")
    assert state["step"].dtype == torch.int32 and state["params"]["embed"].dtype == torch.bfloat16
    back = convert.params_to_numpy(state)
    for (path, want), (gpath, got) in zip(common.tree_leaves(np_state), common.tree_leaves(back)):
        assert path == gpath
        np.testing.assert_array_equal(got, np.asarray(want, got.dtype))
        assert got.dtype == (np.float32 if want.dtype.name == "bfloat16" else want.dtype)


# ---------------------------------------------------------------------------
# The train driver
# ---------------------------------------------------------------------------


@pytest.fixture
def nano(monkeypatch):
    """nbi-100m at the reference driver tests' nano size, for both packages."""
    import repro.configs.nbi100m as jmod
    import repro_torch.configs.nbi100m as mod

    nano_kw = dict(name="nano", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
                   vocab_size=512)
    for m in (mod, jmod):
        orig = m.config
        monkeypatch.setattr(m, "config", lambda orig=orig: orig().replace(**nano_kw))


def run_train(*argv, **kw):
    from repro_torch.launch.train import build_argparser, train

    return train(build_argparser().parse_args(["--arch", "nbi-100m", "--device", "cpu", *map(str, argv)]), **kw)


def test_train_driver_loss_decreases(nano):
    result = run_train("--steps", 30, "--global-batch", 8, "--seq", 64, "--log-every", 5)
    losses = [m["loss"] for m in result["metrics"]]
    assert len(losses) == 6 and losses[-1] < losses[0]
    assert result["completed_steps"] == 30 and result["stopped"] is None
    assert all(m["tokens_per_s"] > 0 for m in result["metrics"])


def test_train_driver_resume_is_bitwise(nano, tmp_path):
    """20 straight steps ≡ 10 steps + checkpoint + restart + 10 steps, bitwise
    on every leaf of the train state (the fault-tolerance guarantee), and
    the resumed run's losses of steps 11 to 20 equal the straight run's."""
    def run(steps, name, every):
        return run_train("--steps", steps, "--global-batch", 4, "--seq", 32, "--ckpt-dir", tmp_path / name,
                         "--ckpt-every", every, "--log-every", 1)

    straight = run(20, "straight", 20)
    run(10, "split", 10)
    assert CheckpointManager(tmp_path / "split").latest_step() == 10
    resumed = run(20, "split", 10)
    assert [m["step"] for m in resumed["metrics"]] == list(range(11, 21))
    assert [m["loss"] for m in resumed["metrics"]] == [m["loss"] for m in straight["metrics"][10:]]
    trees = {}
    for name in ("straight", "split"):
        manager = CheckpointManager(tmp_path / name)
        assert manager.latest_step() == 20
        target = _state_target()
        trees[name], extra, _ = manager.restore(target)
        assert extra["data_cursor"] == 20
    for (pa, a), (pb, b) in zip(common.tree_leaves(trees["straight"]), common.tree_leaves(trees["split"])):
        assert pa == pb and torch.equal(a, b), pa


def _state_target():
    from repro_torch.training import init_train_state

    model = build_model(get_smoke_config("nbi100m").replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                                                            head_dim=16, d_ff=128, vocab_size=512))
    return init_train_state(model, make_optimizer("adamw"), torch.Generator().manual_seed(0), "cpu")


def test_train_driver_stop_request_saves(nano, tmp_path):
    """A SIGTERM during the run ends it after the current step with a final
    synchronous save that records why."""
    def on_metrics(m):
        if m["step"] == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    result = run_train("--steps", 1000, "--global-batch", 2, "--seq", 16, "--ckpt-dir", tmp_path / "c",
                       "--log-every", 1, on_metrics=on_metrics)
    assert result["stopped"] == f"signal {int(signal.SIGTERM)}" and result["completed_steps"] == 3
    manager = CheckpointManager(tmp_path / "c")
    assert manager.latest_step() == 3
    _, extra, _ = manager.restore(_state_target())
    assert extra["stopped"] == result["stopped"] and extra["data_cursor"] == 3


def test_train_driver_eco_preempt_with_the_reference_scheduler(nano, tmp_path):
    """The reference's EcoScheduler injected at a pinned clock: the loop
    checkpoints and exits at the 17:00 peak boundary and returns the next eco
    window's --begin."""
    result = run_train("--steps", 100000, "--global-batch", 4, "--seq", 32, "--ckpt-dir", tmp_path / "eco",
                       "--now", "2026-03-18T16:59:58", "--log-every", 50, eco=EcoScheduler())
    assert result["stopped"] == "eco-preempt"
    assert result["resubmit_begin"].startswith("2026-03-19T00:00:00")
    manager = CheckpointManager(tmp_path / "eco")
    assert manager.latest_step() == result["completed_steps"] > 0


def test_train_cli_runs_on_the_cpu_and_refuses_cuda_without_a_card(nano, capsys):
    from repro_torch.launch.train import main

    assert main(["--arch", "nbi-100m", "--device", "cpu", "--steps", "2", "--global-batch", "2", "--seq", "8",
                 "--log-every", "1"]) == 0
    assert "final_loss=" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--arch", "nbi-100m", "--steps", "1"])


def test_train_driver_flags_are_the_references():
    """The port's driver takes the reference's flags, ``--eco-preempt``
    included (its scheduler comes from the launcher plugin), plus
    ``--device`` and ``--mesh`` (the reference's ``train`` takes its mesh as
    an argument from code; a Slurm job of the port names it on the command
    line)."""
    from repro.launch.train import build_argparser as jax_argparser
    from repro_torch.launch.train import build_argparser

    ref_flags = {a.dest for a in jax_argparser()._actions}
    port_flags = {a.dest for a in build_argparser()._actions}
    assert ref_flags - port_flags == set()
    assert port_flags - ref_flags == {"device", "mesh"}
