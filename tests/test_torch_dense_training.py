"""Training of the rest of the dense family in the port against the JAX
package, on the CPU at smoke size: MLA (``minicpm3-4b``) and the visual
prefix (``llava-next-mistral-7b``, seeded patch embeddings before the text,
labels -100 over them), three AdamW steps each under remat ``none`` and
``full``.

Weights come from the reference's own init (its zero-initialised leaves
redrawn, so that every term is live) and cross with
``repro_torch.convert.params_from_jax``. The oracle is
``tests/test_torch_training.py``'s ``ref_train_steps``: the reference's
``value_and_grad`` of its loss and its optimizer's update, no mesh
(ROADMAP hazard H1). The reference's numbers do not depend on remat, so it
runs once an arch.

Tolerances, as the MoE family's three-step check: the loss rel 1e-5, the
unclipped grad norm rel 1e-4, every param atol 1e-4 (a tenth of one lr 1e-3
update: Adam's m/√v̂ amplifies f32 reassociation noise where a gradient is
near 0), plus Adam's first-step allowance of each entry, lr |f(g1) - f(g2)|
with f(g) = g / (|g| + eps), from each side's own first clipped gradient
(``tests/test_torch_dp.py``'s and ``chip_smoke.py``'s bound). Where a first
gradient sits at its f32 noise floor the two sides' first updates may
differ by up to 2 lr: one entry of minicpm3-4b's ``wo`` has a first
gradient of -7.07e-8 in the port and -4.10e-8 in the reference (a leaf
whose largest is 0.19), and its param ends 1.32e-4 apart after three steps,
all of it from the first update (its later gradients there are 2e-3 and
above, where Adam's steps agree).
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_dp import adam_first_step
from test_torch_family_training import liven
from test_torch_training import ref_train_steps, to_numpy

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro.optim import make_optimizer as jax_make_optimizer
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import common
from repro_torch.models.registry import build_model
from repro_torch.optim import make_optimizer
from repro_torch.training import make_train_step

ARCHS = ["minicpm3_4b", "llava_next_mistral_7b"]
B, S, STEPS, LR = 4, 16, 3, 1e-3


def train_batch(cfg, seed):
    """Seeded tokens (B, S), labels the next token (-100 at the end) and, for
    a visual-prefix config, patches (B, n_patches, d_model) with labels -100
    over them, as numpy arrays."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 512, (B, S)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -100, np.int32)], axis=1)
    out = {"tokens": tokens, "labels": labels}
    if cfg.n_patches:
        out["patches"] = rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(np.float32)
        out["labels"] = np.concatenate([np.full((B, cfg.n_patches), -100, np.int32), labels], axis=1)
    return out


@pytest.fixture(scope="module")
def reference():
    """Per arch: (livened numpy params, batches, the reference's params after
    STEPS AdamW steps, its (loss, grad norm) per step, its first clipped
    gradient of each leaf), computed once."""
    done = {}

    def get(arch):
        if arch not in done:
            ref_model = jax_build_model(jax_get_smoke_config(arch))
            np_params = liven(jax.tree_util.tree_map(np.asarray, ref_model.init(jax.random.PRNGKey(0))))
            params = jax.tree_util.tree_map(jax.numpy.asarray, np_params)
            batches = [train_batch(ref_model.cfg, 40 + i) for i in range(STEPS)]
            jp, _, jout = ref_train_steps(ref_model, params, jax_make_optimizer("adamw", lr=LR), batches)
            _, jopt, _ = ref_train_steps(ref_model, params, jax_make_optimizer("adamw", lr=LR), batches[:1])
            first = {path: m / 0.1 for path, m in common.tree_leaves(to_numpy(jopt["m"]))}  # m = 0.1 g
            done[arch] = (np_params, batches, dict(common.tree_leaves(to_numpy(jp))), jout, first)
        return done[arch]

    return get


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_train_steps_match_reference(reference, arch, remat):
    """Three AdamW train steps of the smoke config against the reference's:
    loss, unclipped grad norm and every param; llava's batches carry seeded
    patches (its loss over the text only)."""
    np_params, batches, want, jout, ref_first = reference(arch)
    cfg = get_smoke_config(arch).replace(remat=remat)
    assert bool(cfg.n_patches) == (arch == "llava_next_mistral_7b")
    model = build_model(cfg)
    optimizer = make_optimizer("adamw", lr=LR)
    params = convert.params_from_jax(np_params, device="cpu")
    state = {"params": params, "opt": optimizer.init(params), "step": torch.zeros((), dtype=torch.int32)}
    step = make_train_step(model, optimizer)
    first = None
    for b, (jloss, jgnorm) in zip(batches, jout):
        state, metrics = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert metrics["loss"].item() == pytest.approx(jloss, rel=1e-5)
        assert metrics["grad_norm"].item() == pytest.approx(jgnorm, rel=1e-4)
        if first is None:
            first = {path: m.numpy() / 0.1 for path, m in common.tree_leaves(state["opt"]["m"])}
    assert int(state["step"]) == STEPS
    got = dict(common.tree_leaves(convert.params_to_numpy(state["params"])))
    assert sorted(got) == sorted(want) == sorted(first) == sorted(ref_first)
    for path, w in want.items():
        bound = 1e-4 + LR * np.abs(adam_first_step(first[path]) - adam_first_step(ref_first[path]))
        excess = float((np.abs(got[path] - w) - bound).max())
        assert excess <= 0, f"{path}: past its bound by {excess:.3e}"
