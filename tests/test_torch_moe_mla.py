"""An MoE model with MLA attention in the port against the JAX package, on the
CPU at smoke size: deepseek-moe-16b's smoke config (one leading dense layer,
two MoE layers, 8 experts top-2 in groups of 32) with MLA at ranks 24 / 16
and head dims 8 + 8 / 8.

The reference trains such a model (its ``moe_block`` and ``dense_block``
call ``mla_attention`` when ``cfg.attention == "mla"``) but cannot serve it:
its ``moe_prefill`` and ``moe_decode_step`` call the GQA functions, which
raise ``KeyError: 'wq'`` on MLA's parameters (ROADMAP H11). So the port
trains it and refuses to serve it, naming that failure.

Weights come from the reference's own init (its zero-initialised leaves
redrawn, so that every term is live) and cross with
``repro_torch.convert.params_from_jax``. The oracles are the reference's
``value_and_grad`` of its loss and its optimizer's update, without a mesh
(ROADMAP H1). On a device mesh the oracle is the port's plain step.

Tolerances: the loss, its metrics and every gradient leaf f32 atol/rtol 1e-4
(``tests/test_torch_family_training.py``'s); three AdamW steps at
``tests/test_torch_dense_training.py``'s: the loss rel 1e-5, the unclipped
grad norm rel 1e-4, every param atol 1e-4 plus Adam's first-step allowance
of each entry, lr |f(g1) - f(g2)| with f(g) = g / (|g| + eps); the mesh
step at ``tests/test_torch_mesh_train.py``'s.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_dp import adam_first_step
from test_torch_family_training import assert_loss_and_grads_match, jx, lm_batch, liven  # noqa: F401
from test_torch_mesh_train import run_ranks
from test_torch_mesh_train import test_sharded_step_matches_the_plain_step as hold_to_plain_step
from test_torch_training import ref_train_steps, to_numpy

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro.optim import make_optimizer as jax_make_optimizer
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.serve import ServeEngine
from repro_torch.launch.submit import serve_memory_model, train_memory_model
from repro_torch.models import common, moe
from repro_torch.models.registry import build_model
from repro_torch.optim import make_optimizer
from repro_torch.training import make_train_step

ARCH = "deepseek_moe_16b"
MLA = dict(attention="mla", q_lora_rank=24, kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=8, v_head_dim=8)
MLA_LEAVES = {"wdq", "q_ln", "wuq", "wdkv", "kv_ln", "wukv", "wkr", "wo"}
# 4 x 16 tokens: two routing groups of 32, where the gating drops picks
B, S, STEPS, LR = 4, 16, 3, 1e-3
H11 = r"KeyError: 'wq'.*H11"


def port_cfg(**overrides):
    return get_smoke_config(ARCH).replace(**MLA, **overrides)


@pytest.fixture(scope="module")
def reference():
    """(reference model, its params as jax arrays, livened numpy params)."""
    ref_model = jax_build_model(jax_get_smoke_config(ARCH).replace(**MLA))
    np_params = liven(jax.tree_util.tree_map(np.asarray, ref_model.init(jax.random.PRNGKey(0))))
    return ref_model, jax.tree_util.tree_map(jax.numpy.asarray, np_params), np_params


def test_param_defs_are_the_references_with_mla_leaves(reference):
    """Every leaf's path, shape and dtype equal the reference's; the leading
    dense layer and the MoE layers both carry MLA's leaves, and the
    converter carries them across and back."""
    _, _, np_params = reference
    model = build_model(port_cfg())
    port = dict(common.tree_leaves(common.map_defs(lambda d: (d.shape, d.dtype), model.param_defs)))
    ref = dict(common.tree_leaves(common.map_defs(lambda a: a.shape, np_params)))
    assert {p: s for p, (s, _) in port.items()} == ref
    for stack in ("dense_blocks", "moe_blocks"):
        assert set(model.param_defs[stack]["attn"]) == MLA_LEAVES
    params = convert.params_from_jax(np_params, device="cpu")
    back = dict(common.tree_leaves(convert.params_to_numpy(params)))
    dtypes = {path: t.dtype for path, t in common.tree_leaves(params)}
    for path, want in common.tree_leaves(np_params):
        np.testing.assert_array_equal(back[path], want, err_msg=path)
        assert dtypes[path] == port[path][1]


@pytest.mark.parametrize("remat", ["none", "full", "selective"])
def test_loss_and_every_grad_match_reference(jx, reference, remat):  # noqa: F811
    """The loss, its metrics (``aux_loss`` too) and every gradient leaf of
    both MLA stacks, the routers and the experts, under each remat policy
    (the reference runs its own, ``none``: remat recomputes, so the values do
    not change)."""
    grads = assert_loss_and_grads_match(jx, lambda _: reference, ARCH, lm_batch(16, B, S), **MLA, remat=remat)
    for stack in ("dense_blocks", "moe_blocks"):
        for leaf in MLA_LEAVES:
            assert bool(grads[f"['{stack}']['attn']['{leaf}']"].abs().gt(0).any()), (stack, leaf)


def test_routing_drops_picks_in_the_parity_batch(reference, monkeypatch):
    """The parity batch exercises capacity: both routings of each MoE layer
    drop picks (two layers, two groups each)."""
    _, _, np_params = reference
    dropped = []
    real = moe.ops.moe_gating

    def record(logits, **kw):
        out = real(logits, **kw)
        dropped.append(int((out[2] < 0).sum()))
        return out

    monkeypatch.setattr(moe.ops, "moe_gating", record)
    batch = {k: torch.from_numpy(v) for k, v in lm_batch(16, B, S).items()}
    build_model(port_cfg()).loss_fn(convert.params_from_jax(np_params, device="cpu"), batch)
    assert len(dropped) == 2 and sum(dropped) > 0


@pytest.fixture(scope="module")
def reference_steps(reference):
    """The reference's params after STEPS AdamW steps, its (loss, grad norm)
    per step and its first clipped gradient of each leaf."""
    ref_model, params, _ = reference
    batches = [lm_batch(40 + i, B, S) for i in range(STEPS)]
    jp, _, jout = ref_train_steps(ref_model, params, jax_make_optimizer("adamw", lr=LR), batches)
    _, jopt, _ = ref_train_steps(ref_model, params, jax_make_optimizer("adamw", lr=LR), batches[:1])
    first = {path: m / 0.1 for path, m in common.tree_leaves(to_numpy(jopt["m"]))}  # m = 0.1 g
    return batches, dict(common.tree_leaves(to_numpy(jp))), jout, first


@pytest.mark.parametrize("remat", ["none", "full"])
def test_adamw_train_steps_match_reference(reference, reference_steps, remat):
    """Three AdamW train steps against the reference's: loss, unclipped grad
    norm, the aux loss logged, and every param."""
    _, _, np_params = reference
    batches, want, jout, ref_first = reference_steps
    model = build_model(port_cfg(remat=remat))
    optimizer = make_optimizer("adamw", lr=LR)
    params = convert.params_from_jax(np_params, device="cpu")
    state = {"params": params, "opt": optimizer.init(params), "step": torch.zeros((), dtype=torch.int32)}
    step = make_train_step(model, optimizer)
    first = None
    for b, (jloss, jgnorm) in zip(batches, jout):
        state, metrics = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert metrics["loss"].item() == pytest.approx(jloss, rel=1e-5)
        assert metrics["grad_norm"].item() == pytest.approx(jgnorm, rel=1e-4)
        assert "aux_loss" in metrics
        if first is None:
            first = {path: m.numpy() / 0.1 for path, m in common.tree_leaves(state["opt"]["m"])}
    got = dict(common.tree_leaves(convert.params_to_numpy(state["params"])))
    assert sorted(got) == sorted(want) == sorted(first) == sorted(ref_first)
    for path, w in want.items():
        bound = 1e-4 + LR * np.abs(adam_first_step(first[path]) - adam_first_step(ref_first[path]))
        excess = float((np.abs(got[path] - w) - bound).max())
        assert excess <= 0, f"{path}: past its bound by {excess:.3e}"


def test_reference_cannot_serve_it(reference):
    """The reference's prefill fails on the config (ROADMAP H11): the reason
    the port refuses to serve it."""
    ref_model, params, _ = reference
    with pytest.raises(KeyError, match="wq"):
        ref_model.prefill_fn(params, {"tokens": jax.numpy.zeros((2, 16), jax.numpy.int32)})


def test_serving_refuses_naming_the_references_failure(reference):
    """Prefill, decode, the cache's layout and logical axes, ``ServeEngine``,
    serve sizing and the dry-run's prefill and decode steps raise
    ``NotImplementedError`` naming the reference's ``KeyError: 'wq'``
    (H11); the train step's count does not."""
    _, _, np_params = reference
    cfg = port_cfg()
    model = build_model(cfg)
    params = convert.params_from_jax(np_params, device="cpu")
    tokens = torch.zeros((2, 16), dtype=torch.long)
    for call in (lambda: model.prefill_fn(params, {"tokens": tokens}),
                 lambda: model.decode_fn(params, {}, tokens[:, :1], 16),
                 lambda: model.cache_defs_fn(2, 32),
                 model.cache_logical_fn,
                 lambda: ServeEngine(cfg, batch=2, max_seq=32, device="cpu"),
                 lambda: dryrun.step_and_inputs(model, "decode", 2, 32)):
        with pytest.raises(NotImplementedError, match=H11):
            call()
    wide = build_model(dryrun.kernel_widths(cfg))
    step, args = dryrun.step_and_inputs(wide, "prefill", 2, 32)
    with pytest.raises(NotImplementedError, match=H11):
        step(*args)
    with pytest.raises(NotImplementedError, match=H11):
        serve_memory_model(get_config(ARCH).replace(**MLA), 8, 2048)
    with pytest.raises(NotImplementedError, match="visual prefix"):
        build_model(cfg.replace(n_patches=4))


def test_train_memory_model_counts_the_train_step():
    """``train_memory_model`` counts the full-width config's train step:
    chip_smoke.py's 4 layers (1 dense + 3 MoE) at 4 x 2048 fit under the GQA
    path's, by the MLA projections' smaller weights."""
    mla = get_config(ARCH).replace(attention="mla", q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64,
                                   qk_rope_dim=32, v_head_dim=64)
    for layers in (3, 4):
        got = train_memory_model(mla.replace(n_layers=layers), 4, 2048)
        assert 0 < got < train_memory_model(get_config(ARCH).replace(n_layers=layers), 4, 2048)
    assert train_memory_model(mla.replace(n_layers=4), 4, 2048) < 66 * 2**30


# ---------------------------------------------------------------------------
# On a device mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The (2, 2) mesh's gradients and two steps of the config and the plain
    step's on the same batches, in a gloo group of four CPU ranks
    (``tests/test_torch_mesh_train.py``'s worker)."""
    out = tmp_path_factory.mktemp("moe_mla_2x2")
    arch = "deepseek-moe-16b"
    run_ranks({"shape": [2, 2], "fsdp": None, "archs": [arch], "overrides": {arch: MLA}, "out": str(out),
               "save": None, "restore": None, "ref_weights": None, "plain": True})
    return {"2x2": out}


def test_sharded_step_matches_the_plain_step(mesh_run):
    """On a (2, 2) mesh, MLA's heads and the experts over ``model`` and the
    batch over ``data`` (each rank's rows whole routing groups): the
    gradients and two AdamW steps equal the plain step's."""
    r = torch.load(mesh_run["2x2"] / "deepseek-moe-16b.pt", weights_only=False)
    assert r["rules"]["heads"] == "model" and r["rules"]["experts"] == "model" and r["rules"]["batch"] == "data"
    assert set(dict(common.tree_leaves(r["grads"]))) >= {f"['moe_blocks']['attn']['{leaf}']" for leaf in MLA_LEAVES}
    hold_to_plain_step(mesh_run, "2x2", "deepseek-moe-16b")
