"""The port's int8 error-feedback compression and data-parallel step
(``repro_torch.parallel.compression``, ``repro_torch.training.dp_step``)
against the reference's, on the CPU.

The port's collectives run in a gloo process group of one rank (made for
this module and destroyed after it); the reference's ``shard_map`` runs on a
one-device mesh of ``AxisType.Auto`` axes (its Explicit-axes meshes fail
under this JAX version, ROADMAP hazard H1).

Tolerances: quantisation bit for bit (int8 payload, f32 scales, the
dequantised values and the carry); the DP step within the train-step
tolerance of ``tests/test_torch_training.py`` (loss rel 1e-5, grad_norm rel
1e-4, params atol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AxisType, PartitionSpec

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro.optim import make_optimizer as jax_make_optimizer
from repro.parallel import compression as ref
from repro.training.dp_step import init_dp_state as jax_init_dp_state
from repro.training.dp_step import make_dp_train_step as jax_make_dp_train_step
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.launch.distributed import dp_groups
from repro_torch.models.common import tree_leaves
from repro_torch.models.registry import build_model
from repro_torch.optim import make_optimizer
from repro_torch.parallel import compression as port
from repro_torch.training import init_dp_state, init_train_state, make_dp_train_step, make_train_step


@pytest.fixture(scope="module")
def groups():
    """A gloo group of one rank (an in-memory store: no port), its DP groups."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield dp_groups()
    finally:
        dist.destroy_process_group()


def auto_mesh():
    return jax.make_mesh((1, 1), ("pod", "data"), axis_types=(AxisType.Auto, AxisType.Auto))


def seeded(seed, shape, spread=True):
    """Normal values; with ``spread``, each row scaled by its own power of ten
    (1e-6 to 1e2) so that rows quantise at very different scales."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if spread and len(shape) > 1:
        x *= (10.0 ** rng.integers(-6, 3, shape[:-1]))[..., None].astype(np.float32)
    return x


QUANT_CASES = {
    "rows": (16, 256), "stacked": (3, 5, 7), "one_column": (4, 1), "vector": (33,), "wide": (2, 4096),
}


@pytest.mark.parametrize("case", sorted(QUANT_CASES) + ["zero_rows", "ties"])
def test_quant_int8_matches_reference_bitwise(case):
    if case == "zero_rows":
        x = seeded(1, (4, 64))
        x[1] = 0.0
        x[3] = -0.0
    elif case == "ties":
        # values at k + 0.5 quanta: round half to even, as jnp.round
        x = (np.arange(-20, 21, dtype=np.float32) + 0.5)[None].repeat(2, 0)
        x[:, 0] = 127.0
    else:
        x = seeded(2, QUANT_CASES[case])
    q, s = port.quant_int8(torch.from_numpy(x))
    jq, js = ref.quant_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.int32), np.asarray(js).view(np.int32))
    np.testing.assert_array_equal(port.dequant_int8(q, s).numpy(), np.asarray(ref.dequant_int8(jq, js)))


def test_ef_state_and_wire_accounting_match_reference():
    grads = {"a": torch.ones((2, 3), dtype=torch.bfloat16), "b": {"c": torch.ones(4)}}
    ef = port.init_ef_state(grads)
    assert ef["a"].dtype == torch.float32 and ef["a"].shape == (2, 3) and float(ef["b"]["c"].abs().max()) == 0.0
    for compressed in (False, True):
        assert port.wire_bytes_per_param(compressed) == ref.wire_bytes_per_param(compressed)


def test_ef_compressed_psum_with_one_participant_matches_reference(groups):
    """Ten steps of a seeded constant gradient tree (a scalar leaf included)
    through both: the synced mean and the carry bit for bit each step."""
    tree = {"w": seeded(3, (8, 64)), "b": {"v": seeded(4, (5,), spread=False), "s": np.float32(0.25)}}
    mesh = auto_mesh()

    def ref_sync(g, e):
        return jax.shard_map(lambda e: ref.ef_compressed_psum(g, e, "pod", 1), mesh=mesh,
                             in_specs=(PartitionSpec(),), out_specs=(PartitionSpec(),) * 2, check_vma=False)(e)

    jgrads = jax.tree_util.tree_map(jnp.asarray, tree)
    grads = convert.params_from_jax(tree, device="cpu")
    je, e = ref.init_ef_state(jgrads), port.init_ef_state(grads)
    for _ in range(10):
        jsynced, je = ref_sync(jgrads, je)
        synced, e = port.ef_compressed_psum(grads, e, groups["pod"], 1)
        for got, want in ((synced, jsynced), (e, je)):
            for (path, a), (_, b) in zip(tree_leaves(got), tree_leaves(convert.params_from_jax(
                    jax.tree_util.tree_map(np.asarray, want), device="cpu"))):
                assert torch.equal(a, b), path


def test_error_feedback_recycles_the_quantisation_loss(groups):
    """tests/test_compression.py's check: over 50 steps the mean of the synced
    gradient of a constant tracks the constant (rtol 0.02); and for a
    constant spread over six decades per row, the carry bounds the mean's
    error by half a quantum over the steps."""
    g = {"w": torch.full((4, 64), 0.003)}
    e = port.init_ef_state(g)
    total = torch.zeros(4, 64)
    for _ in range(50):
        synced, e = port.ef_compressed_psum(g, e, groups["pod"], 1)
        total += synced["w"]
    np.testing.assert_allclose((total / 50).numpy(), 0.003, rtol=0.02)

    x = torch.from_numpy(seeded(5, (6, 128)))
    g, e, n = {"w": x}, port.init_ef_state({"w": x}), 20
    total = torch.zeros_like(x)
    for _ in range(n):
        synced, e = port.ef_compressed_psum(g, e, groups["pod"], 1)
        total += synced["w"]
    half_quantum = x.abs().amax(-1, keepdim=True) / 127 / 2
    assert bool(((total / n - x).abs() <= half_quantum / n * 1.01).all())


def lm_batch(seed, B, S, vocab):
    tokens = np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -100, np.int32)], axis=1)
    return {"tokens": tokens, "labels": labels}


LR, EPS = 1e-3, 1e-8


def within(err, bound, what):
    excess = float(np.max(err - bound))
    assert excess <= 0, f"{what}: past its bound by {excess:.3e}"


def adam_first_step(g):
    """What Adam's first step moves an entry by, over lr: m̂/(√v̂ + eps) with
    m̂ = g and v̂ = g²."""
    return g / (np.abs(g) + EPS)


@pytest.mark.parametrize("compress", [False, True])
def test_dp_step_matches_reference(groups, compress):
    """One DP step from the reference's init on a one-device mesh against the
    port's in a group of one.

    Tolerances: loss and metrics rel 1e-5, grad_norm rel 1e-4 (the train
    step's); the clipped synced gradients, read from the new first moment
    m = 0.1 g, within 1e-4 of each leaf's largest, and the params by Adam's
    first-step bound, lr |f(g1) - f(g2)| + 1e-6 with f(g) = g / (|g| + eps),
    from each side's own g (chip_smoke.py's card-against-CPU step): f32
    summation order moves a gradient at its noise floor, and Adam's first
    step turns that into up to 2 lr. Compressed, a value on a rounding
    boundary of the quantiser may take the other int8 on each side, so the
    synced gradient and the carry may also differ by one quantum of its row
    (the row's largest synced value / 127)."""
    cfg = jax_get_smoke_config("nbi100m")
    jmodel, jopt = jax_build_model(cfg), jax_make_optimizer("adamw", lr=LR)
    mesh = auto_mesh()
    jstep = jax.jit(jax_make_dp_train_step(jmodel, jopt, mesh, compress=compress))
    with mesh:
        jstate = jax_init_dp_state(jmodel, jopt, jax.random.PRNGKey(0), compress=compress)
    model, opt = build_model(get_smoke_config("nbi100m")), make_optimizer("adamw", lr=LR)
    state = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    b = lm_batch(40, 4, 16, cfg.vocab_size)
    with mesh:
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, b))
    state, m = make_dp_train_step(model, opt, groups, compress=compress)(
        state, {k: torch.from_numpy(v) for k, v in b.items()})
    assert sorted(m) == sorted(jm)
    for k in m:
        assert m[k].item() == pytest.approx(float(jm[k]), rel=1e-4 if k == "grad_norm" else 1e-5, abs=1e-7), k
    assert sorted(state) == sorted(jstate) and int(state["step"]) == 1
    got = dict(tree_leaves(convert.params_to_numpy(state)))
    want = dict(tree_leaves(jax.tree_util.tree_map(np.asarray, jstate)))
    clip = min(1.0, 1.0 / float(jm["grad_norm"]))  # AdamW's clip_norm 1.0
    for path in [p for p in want if p.startswith("['params']")]:
        leaf = path.removeprefix("['params']")
        g1, g2 = got["['opt']['m']" + leaf] / 0.1, want["['opt']['m']" + leaf] / 0.1
        quantum = np.abs(g2).max(-1, keepdims=True) / 127 if compress else 0.0
        within(np.abs(g1 - g2), np.maximum(1e-4 * np.abs(g2).max(), 1.01 * quantum), f"gradient {leaf}")
        within(np.abs(got[path] - want[path]), LR * np.abs(adam_first_step(g1) - adam_first_step(g2)) + 1e-6, path)
        if compress:
            within(np.abs(got["['ef']" + leaf] - want["['ef']" + leaf]), np.maximum(1.01 * quantum / clip, 1e-6),
                   f"carry {leaf}")


def test_exact_dp_step_of_one_rank_is_the_train_step(groups):
    """In a group of one, the exact DP step is make_train_step bit for bit
    (the all-reduce of one rank and the division by 1 change no bit)."""
    model, opt = build_model(get_smoke_config("nbi100m")), make_optimizer("adamw", lr=1e-3)
    a = init_train_state(model, opt, torch.Generator().manual_seed(1), "cpu")
    b = init_dp_state(model, opt, torch.Generator().manual_seed(1), "cpu", compress=False)
    plain, dp = make_train_step(model, opt), make_dp_train_step(model, opt, groups, compress=False)
    for i in range(3):
        batch = {k: torch.from_numpy(v) for k, v in lm_batch(50 + i, 4, 16, 512).items()}
        a, ma = plain(a, batch)
        b, mb = dp(b, batch)
        assert torch.equal(ma["loss"], mb["loss"]) and torch.equal(ma["grad_norm"], mb["grad_norm"])
    for (path, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y), path


def test_the_mean_keeps_a_gradients_layout(groups):
    """A transposed gradient (the tied embedding's) comes back transposed, so
    that the global norm sums it in the plain step's order."""
    from repro_torch.training.dp_step import _mean

    g = torch.randn(5, 3, generator=torch.Generator().manual_seed(0)).t()
    out = _mean(g.clone(), groups["data"], 1)
    assert not g.is_contiguous() and out.stride() == g.stride() and torch.equal(out, g)


def test_ef_carry_survives_a_checkpoint_round_trip(groups, tmp_path):
    model, opt = build_model(get_smoke_config("nbi100m")), make_optimizer("adamw", lr=1e-3)
    state = init_dp_state(model, opt, torch.Generator().manual_seed(2), "cpu", compress=True)
    step = make_dp_train_step(model, opt, groups, compress=True)
    for i in range(2):
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in lm_batch(60 + i, 4, 16, 512).items()})
    assert any(float(t.abs().max()) > 0 for _, t in tree_leaves(state["ef"]))
    manager = CheckpointManager(tmp_path / "ckpt")
    manager.save(2, state, extra={"data_cursor": 2})
    target = init_dp_state(model, opt, torch.Generator().manual_seed(9), "cpu", compress=True)
    restored, extra, at = manager.restore(target)
    assert at == 2 and extra == {"data_cursor": 2}
    assert [p for p, _ in tree_leaves(restored)] == [p for p, _ in tree_leaves(state)]
    for (path, x), (_, y) in zip(tree_leaves(state), tree_leaves(restored)):
        assert x.dtype == y.dtype and torch.equal(x, y), path
