"""The one-device train step's graph (``training/graph.py``'s ``TrainGraph``,
the counterpart of the reference's ``jax.jit`` over its train step with the
state donated) on the CPU, where the same static state, batch and metric
buffers and the same copies run and the step is called eagerly (the capture
itself needs the card: the ``gpu`` test at the end).

Every family's smoke model, under remat ``none`` and ``full`` (and
mistral-large-123b's ``selective`` over its 2 microbatches), takes three
steps through the graph and three of ``make_train_step`` from the same
state: state and metrics equal bit for bit. nbi-100m's smoke model through
the graph is held to the reference's ``jax.value_and_grad(loss_fn)`` and its
optimizer's ``update`` (no rules, ROADMAP H1) at ``test_torch_training.py``'s
tolerances; the launcher, which steps through the graph, to a loop of
``make_train_step`` over the same batches, exactly (its resume through
the graph: ``test_torch_training.py``'s resume test). Remat runs without
saving the generators' states (a capture refuses the CUDA generator's
read): every gradient equals the one computed with them saved, bit for bit.
JAX is imported inside the reference's test, so that the card's machine,
which has no JAX, can run this file's ``gpu`` test (``python -m pytest -m
gpu tests/test_torch_train_graph.py``).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.data import make_train_loader
from repro_torch.kernels import ops
from repro_torch.models import rwkv6, transformer
from repro_torch.models.common import map_defs, tree_leaves
from repro_torch.models.registry import build_model
from repro_torch.optim import cosine_warmup, make_optimizer
from repro_torch.training import TrainGraph, init_train_state, make_train_step
from repro_torch.training.steps import make_grad_fn

# a smoke config of each family: dense GQA, MLA, the visual prefix (8
# patches), MoE, MoE with MLA attention (no config of its own: chip_smoke's
# MLA smoke ranks on deepseek-moe-16b's), Griffin, RWKV-6, Whisper (seeded
# frames)
MOE_MLA = chip_smoke.TRAIN_VARIANTS[chip_smoke.MOE_MLA][2]
FAMILIES = {"dense": ("nbi100m", {}), "mla": ("minicpm3_4b", {}), "prefix": ("llava_next_mistral_7b", {}),
            "moe": ("deepseek_moe_16b", {}), "moe_mla": ("deepseek_moe_16b", MOE_MLA),
            "griffin": ("recurrentgemma_2b", {}), "rwkv6": ("rwkv6_7b", {}), "whisper": ("whisper_small", {})}
# family, remat: each family under none and full, and mistral-large-123b's
# smoke config (2 microbatches) under its full config's selective
CASES = [(f, r) for f in FAMILIES for r in ("none", "full")] + [("selective_microbatched", "selective")]
B, S, STEPS = 2, 16, 3


def config(family: str, remat: str):
    if family == "selective_microbatched":
        return get_smoke_config("mistral_large_123b").replace(remat=remat)
    arch, overrides = FAMILIES[family]
    return get_smoke_config(arch).replace(remat=remat, **overrides)


def make_batch(cfg, seed: int, rows: int = B, seq: int = S, device="cpu") -> dict:
    """Seeded tokens and labels (the last label -100); Whisper's frames and a
    visual prefix's patches (its labels -100 over them) drawn by numpy."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((rows, 1), -100, np.int32)], axis=1)
    batch = {"tokens": tokens, "labels": labels}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((rows, cfg.enc_len, cfg.d_model)).astype(np.float32)
    if cfg.n_patches:
        batch["patches"] = rng.standard_normal((rows, cfg.n_patches, cfg.d_model)).astype(np.float32)
        batch["labels"] = np.concatenate([np.full((rows, cfg.n_patches), -100, np.int32), labels], axis=1)
    dt = getattr(torch, cfg.dtype)
    return {k: torch.from_numpy(v).to(device=device, dtype=dt if v.dtype == np.float32 else torch.int32)
            for k, v in batch.items()}


def live_state(model, optimizer, device="cpu", seed=0) -> dict:
    """A fresh train state whose all-zero leaves (gates, biases, RWKV's
    mixes) are redrawn at 0.3 standard deviations, so that every term is
    live."""
    g = torch.Generator().manual_seed(seed + 7)
    params = map_defs(lambda t: t if bool(t.any()) else (0.3 * torch.randn(t.shape, generator=g)).to(t.dtype),
                      model.init(torch.Generator().manual_seed(seed), "cpu"))
    params = map_defs(lambda t: t.to(device), params)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def clone(tree):
    return map_defs(torch.clone, tree)


def assert_trees_equal(got, want, what=""):
    got, want = dict(tree_leaves(got)), dict(tree_leaves(want))
    assert sorted(got) == sorted(want), what
    for path, w in want.items():
        assert got[path].dtype == w.dtype and torch.equal(got[path], w), f"{what} {path}"


def graph_and_eager(cfg, steps=STEPS):
    """``steps`` steps through a TrainGraph and through ``make_train_step``
    from one state: (graph, its metrics each step, the eager state, the eager
    metrics each step)."""
    model = build_model(cfg)
    optimizer = make_optimizer(cfg.optimizer, lr=cosine_warmup(1e-3, 2, steps))
    state = live_state(model, optimizer)
    step = make_train_step(model, optimizer)
    batches = [make_batch(cfg, 20 + i) for i in range(steps)]
    graph = TrainGraph(step, clone(state))
    got = []
    for b in batches:
        _, metrics = graph(graph.state, graph.feed(b))
        got.append(clone(metrics))  # a step overwrites the static metrics
    want = []
    for b in batches:
        state, metrics = step(state, b)
        want.append(metrics)
    return graph, got, state, want


@pytest.mark.parametrize("family,remat", CASES)
def test_graph_steps_equal_the_eager_steps(family, remat):
    """Three steps through the graph equal three of ``make_train_step`` bit
    for bit, in every state leaf (``step`` included) and every metric, and
    the graph replays nothing on the CPU."""
    graph, got, state, want = graph_and_eager(config(family, remat))
    assert graph.replays == 0 and graph.seconds == {}
    assert int(graph.state["step"]) == STEPS and graph.state["step"].dtype == torch.int32
    assert_trees_equal(graph.state, state, "state")
    for i, (g, w) in enumerate(zip(got, want)):
        assert_trees_equal(g, w, f"metrics of step {i + 1}")


def test_graph_overwrites_its_own_buffers_in_place():
    """A step writes into the adopted state's and the first step's metrics'
    tensors: the objects a caller holds are the ones the next step
    overwrites (hence the docstring's clone)."""
    cfg = config("dense", "none")
    model = build_model(cfg)
    optimizer = make_optimizer("adamw", lr=1e-3)
    state = live_state(model, optimizer)
    graph = TrainGraph(make_train_step(model, optimizer), state)
    storages = {p: t.data_ptr() for p, t in tree_leaves(state)}
    out_state, metrics = graph(graph.state, graph.feed(make_batch(cfg, 1)))
    first = {k: (v, v.clone()) for k, v in metrics.items()}
    batch = graph.batch
    out2, metrics2 = graph(graph.state, graph.feed(make_batch(cfg, 2)))
    assert out_state is state and out2 is state and graph.batch is batch and metrics2 is metrics
    assert {p: t.data_ptr() for p, t in tree_leaves(out2)} == storages
    assert any(not torch.equal(v, old) for v, old in first.values())  # the held metrics changed
    assert int(state["step"]) == 2


def test_feed_refuses_another_batch_layout_and_the_graph_another_state():
    cfg = config("dense", "none")
    model = build_model(cfg)
    optimizer = make_optimizer("adamw", lr=1e-3)
    state = live_state(model, optimizer)
    graph = TrainGraph(make_train_step(model, optimizer), state)
    batch = make_batch(cfg, 3)
    with pytest.raises(ValueError, match="static state and batch"):
        graph(graph.state, batch)  # nothing fed yet
    graph.feed(batch)
    with pytest.raises(ValueError, match="static batch holds"):
        graph.feed(make_batch(cfg, 3, seq=S + 1))
    with pytest.raises(ValueError, match="static batch holds"):
        graph.feed({k: v.long() for k, v in batch.items()})
    with pytest.raises(ValueError, match="keys"):
        graph.feed({"tokens": batch["tokens"]})
    with pytest.raises(ValueError, match="keys"):
        graph.feed({**batch, "frames": torch.zeros(B, 4, cfg.d_model)})
    with pytest.raises(ValueError, match="static state and batch"):
        graph(clone(state), graph.batch)
    with pytest.raises(ValueError, match="static state and batch"):
        graph(graph.state, dict(graph.batch))
    graph(graph.state, graph.batch)  # the refusals changed nothing
    assert int(state["step"]) == 1 and graph.replays == 0


def _preserving(checkpoint):
    def run(*args, **kwargs):
        kwargs["preserve_rng_state"] = True
        return checkpoint(*args, **kwargs)

    return run


@pytest.mark.parametrize("family,remat", [(f, "full") for f in FAMILIES] + [("selective_microbatched", "selective")])
def test_remat_without_the_rng_state_keeps_every_gradient(family, remat, monkeypatch):
    """Remat and the chunked WKV no longer save and restore the generators'
    states (``preserve_rng_state=False``, which a capture needs): no layer
    draws random numbers, so the loss, metrics and every gradient equal the
    ones computed with the states saved, bit for bit."""
    cfg = config(family, remat)
    model = build_model(cfg)
    params = live_state(model, make_optimizer("adamw"))["params"]
    batch = make_batch(cfg, 5)
    grads_fn = make_grad_fn(model)
    loss, metrics, grads = grads_fn(params, batch)
    monkeypatch.setattr(transformer, "checkpoint", _preserving(transformer.checkpoint))
    monkeypatch.setattr(rwkv6, "checkpoint", _preserving(rwkv6.checkpoint))
    loss_saved, metrics_saved, grads_saved = grads_fn(params, batch)
    assert torch.equal(loss, loss_saved)
    assert_trees_equal(metrics, metrics_saved, "metrics")
    assert_trees_equal(grads, grads_saved, "grads")


def test_graph_steps_match_the_reference():
    """Three nbi-100m smoke steps through the graph against the reference's
    train step without a mesh (``jax.value_and_grad(loss_fn)``, f32 grads,
    its AdamW's ``update``): loss rel 1e-5, grad norm rel 1e-4, params atol
    1e-4 (``test_torch_training.py``'s tolerances)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as jax_get_smoke_config
    from repro.models.registry import build_model as jax_build_model
    from repro.optim import make_optimizer as jax_make_optimizer
    from test_torch_training import lm_batch, ref_train_steps, to_numpy

    ref_model = jax_build_model(jax_get_smoke_config("nbi100m"))
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    batches = [lm_batch(30 + i, B=4) for i in range(3)]
    jp, _, jout = ref_train_steps(ref_model, ref_params, jax_make_optimizer("adamw", lr=1e-3), batches)

    model = build_model(get_smoke_config("nbi100m"))
    optimizer = make_optimizer("adamw", lr=1e-3)
    params = convert.params_from_jax(to_numpy(ref_params), device="cpu")
    graph = TrainGraph(make_train_step(model, optimizer),
                       {"params": params, "opt": optimizer.init(params), "step": torch.zeros((), dtype=torch.int32)})
    for b, (jloss, jgnorm) in zip(batches, jout):
        _, metrics = graph(graph.state, graph.feed({k: torch.from_numpy(v) for k, v in b.items()}))
        assert metrics["loss"].item() == pytest.approx(jloss, rel=1e-5)
        assert metrics["grad_norm"].item() == pytest.approx(jgnorm, rel=1e-4)
    assert int(graph.state["step"]) == 3 and graph.replays == 0
    got = dict(tree_leaves(convert.params_to_numpy(graph.state["params"])))
    for path, want in tree_leaves(to_numpy(jp)):
        np.testing.assert_allclose(got[path], want, atol=1e-4, rtol=0, err_msg=path)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

NANO = dict(name="nano", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512)


@pytest.fixture
def nano(monkeypatch):
    """nbi-100m at the nano size of the reference's launcher tests."""
    import repro_torch.configs.nbi100m as mod

    orig = mod.config
    monkeypatch.setattr(mod, "config", lambda: orig().replace(**NANO))
    return orig().replace(**NANO)


def run_train(*argv, **kw):
    from repro_torch.launch.train import build_argparser, train

    return train(build_argparser().parse_args(["--arch", "nbi-100m", "--device", "cpu", *map(str, argv)]), **kw)


def test_launcher_through_the_graph_equals_the_eager_loop(nano, tmp_path):
    """The launcher's losses at every step and its final state (its last
    checkpoint) equal a loop of ``make_train_step`` over the same pipeline's
    batches from the same seeded state, exactly; no replay on the CPU."""
    steps, batch, seq = 12, 4, 32
    result = run_train("--steps", steps, "--global-batch", batch, "--seq", seq, "--warmup", 4, "--log-every", 1,
                       "--ckpt-dir", tmp_path / "run", "--ckpt-every", 100)
    assert result["replays"] == 0 and result["completed_steps"] == steps

    model = build_model(nano)
    optimizer = make_optimizer(nano.optimizer, lr=cosine_warmup(3e-4, 4, steps))
    state = init_train_state(model, optimizer, torch.Generator(device="cpu").manual_seed(0), "cpu")
    step = make_train_step(model, optimizer)
    loader = make_train_loader(model.cfg.vocab_size, batch, seq, seed=0)
    losses = []
    for _ in range(steps):
        state, metrics = step(state, {k: torch.from_numpy(v) for k, v in next(loader).items()})
        losses.append(float(metrics["loss"]))
    loader.close()
    assert [m["loss"] for m in result["metrics"]] == losses
    saved, _, at = CheckpointManager(tmp_path / "run").restore(clone(state))
    assert at == steps
    assert_trees_equal(saved, state, "final state")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def small_config(path: str):
    overrides, (rows, seq) = chip_smoke.TRAIN_SMALL_MODELS[path]
    return get_smoke_config(chip_smoke.train_arch(path)).replace(**overrides), rows, seq


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(chip_smoke.TRAIN_SMALL_MODELS))
def test_graph_replays_equal_eager_steps_on_the_card(path):
    """Each train path's small model (``chip_smoke.TRAIN_SMALL_MODELS``: the
    kernels' head widths) on the card: three steps through the graph (the
    warm-up, then two replays of the captured step) equal three eager steps
    of ``make_train_step`` from a clone of the same state, bit for bit in
    every state leaf and metric, and the graph's launches (counted at each
    replay) equal the eager steps'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, rows, seq = small_config(path)
    model = build_model(cfg)
    optimizer = make_optimizer("adamw", lr=cosine_warmup(1e-3, 2, STEPS))
    state = live_state(model, optimizer, "cuda", seed=3)
    step = make_train_step(model, optimizer)
    batches = [make_batch(cfg, 40 + i, rows, seq, "cuda") for i in range(STEPS)]
    graph = TrainGraph(step, clone(state))
    launches = {}
    for side in ("graph", "eager"):
        before = ops.launch_counts()
        metrics_each = []
        for b in batches:
            if side == "graph":
                _, metrics = graph(graph.state, graph.feed(b))
            else:
                state, metrics = step(state, b)
            metrics_each.append(clone(metrics))
        torch.cuda.synchronize()
        after = ops.launch_counts()
        launches[side] = ({key: after[key] - n for key, n in before.items() if after[key] != n}, metrics_each)
    assert graph.replays == STEPS - 1
    assert launches["graph"][0] == launches["eager"][0] and launches["eager"][0]
    assert_trees_equal(graph.state, state, "state")
    for i, (g, w) in enumerate(zip(launches["graph"][1], launches["eager"][1])):
        assert_trees_equal(g, w, f"metrics of step {i + 1}")
