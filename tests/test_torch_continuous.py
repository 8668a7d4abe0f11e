"""The port's ``ContinuousBatchingEngine`` on the CPU, against greedy full
recompute through the JAX package, mirroring the reference's own tests
(``tests/test_serve.py``: exact against full recompute, the occupancy and
step bound, MoE rejected).

The reference's engine builds a mesh and fails under this JAX version
(ROADMAP hazard H1), so the oracle is the reference's ``build_model(cfg)
.prefill_fn`` over the same weights (the reference's init, crossed with
``repro_torch.convert.params_from_jax``): greedy full recompute, one prefill
of the whole sequence per generated token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import ContinuousBatchingEngine

ARCHS = ["codeqwen15_7b", "minicpm3_4b"]


def engine_with_reference_weights(arch, batch, max_seq):
    """(port engine on the CPU carrying the reference's weights, reference
    model, reference params)."""
    ref_model = jax_build_model(jax_get_smoke_config(arch))
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    cb = ContinuousBatchingEngine(get_smoke_config(arch), batch=batch, max_seq=max_seq, device="cpu")
    cb.params = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    return cb, ref_model, ref_params


def requests(seed, lengths, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32) for n in lengths]


def greedy_recompute(prefill, ref_params, req, gen_len):
    """The reference's greedy tokens for ``req``: one prefill of the whole
    sequence per generated token."""
    toks = jnp.asarray(req[None, :])
    want = []
    for _ in range(gen_len):
        logits, _ = prefill(ref_params, {"tokens": toks})
        want.append(int(jnp.argmax(logits[0, -1])))
        toks = jnp.concatenate([toks, jnp.full((1, 1), want[-1], jnp.int32)], axis=1)
    return want


@torch.inference_mode()
def drive_staggered(cb, arrivals, gen_len):
    """Greedy decode through ``cb``'s slots with request i written by
    ``cb._insert`` into slot s of the live cache just before decode step t,
    for each (t, s, prompt) of ``arrivals``, while the other slots keep
    decoding; returns each request's ``gen_len`` tokens."""
    B = cb.batch
    cache = {n: torch.zeros(d.shape, dtype=d.dtype) for n, d in cb.model.cache_defs_fn(B, cb.max_seq).items()}
    tok, pos = np.zeros(B, np.int64), np.zeros(B, np.int64)
    outs, slot_of = [[] for _ in arrivals], {}
    step = 0
    while len(slot_of) < len(arrivals) or any(len(o) < gen_len for o in outs):
        for i, (t, s, prompt) in enumerate(arrivals):
            if t == step:
                assert all(slot_of.get(j) != s or len(outs[j]) == gen_len for j in slot_of), "slot busy"
                tok[s], pos[s] = cb._insert(cache, s, prompt), len(prompt)
                outs[i].append(int(tok[s]))
                slot_of[i] = s
        logits, _ = cb.model.decode_fn(cb.params, cache, torch.as_tensor(tok[:, None]), torch.as_tensor(pos))
        nxt = logits[:, -1].argmax(-1).numpy()
        for i, s in slot_of.items():
            if len(outs[i]) < gen_len:
                outs[i].append(int(nxt[s]))
                tok[s], pos[s] = nxt[s], pos[s] + 1
        step += 1
    return outs


@pytest.mark.parametrize("arch", ARCHS)
def test_exact_vs_full_recompute(arch):
    """Every request's tokens equal greedy full recompute, whatever its slot
    and arrival order (tests/test_serve.py:117, with an MLA model too)."""
    reqs = requests(3, (12, 5, 9, 12, 7))
    cb, ref_model, ref_params = engine_with_reference_weights(arch, batch=2, max_seq=48)
    outs = cb.serve(reqs, gen_len=4)
    prefill = jax.jit(ref_model.prefill_fn)
    for i, req in enumerate(reqs):
        want = greedy_recompute(prefill, ref_params, req, 4)
        assert outs[i].dtype == np.int32 and outs[i].tolist() == want, i
    assert cb.stats["requests"] == len(reqs)


@pytest.mark.parametrize("arch", ARCHS)
def test_insert_next_to_decoding_slots(arch):
    """Inserts into a live cache while another slot is part-way through its
    generation: request a decodes alone in slot 0, b is inserted into slot 1
    (over the rows its idle decode steps wrote) two steps later, and c into
    slot 0 as soon as a is done, while b is still decoding. a's tokens equal
    a run of a alone, and every request's equal greedy full recompute."""
    gen_len = 5
    a, b, c = requests(6, (9, 6, 11))
    cb, ref_model, ref_params = engine_with_reference_weights(arch, batch=2, max_seq=32)
    alone = cb.serve([a], gen_len=gen_len)[0].tolist()
    outs = drive_staggered(cb, [(0, 0, a), (2, 1, b), (gen_len - 1, 0, c)], gen_len)
    assert outs[0] == alone
    prefill = jax.jit(ref_model.prefill_fn)
    for i, req in enumerate((a, b, c)):
        assert outs[i] == greedy_recompute(prefill, ref_params, req, gen_len), i


@pytest.mark.parametrize("arch", ARCHS)
def test_beats_static_batching_steps(arch):
    """Mixed lengths through fixed slots: occupancy above 0.8 and no more
    decode steps than the static bound ceil(R/B)·gen plus 2
    (tests/test_serve.py:143)."""
    reqs = requests(4, (4, 16, 4, 16, 4, 16))
    cb, _, _ = engine_with_reference_weights(arch, batch=3, max_seq=40)
    outs = cb.serve(reqs, gen_len=5)
    assert [len(o) for o in outs] == [5] * len(reqs)
    occupancy = cb.stats["occupancy_sum"] / cb.stats["decode_steps"]
    assert occupancy > 0.8
    assert cb.stats["decode_steps"] <= -(-len(reqs) // 3) * 5 + 2
    # each decode step advances every occupied slot once
    assert cb.stats["slot_tokens"] == pytest.approx(cb.stats["occupancy_sum"] * 3)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "rwkv6-7b", "recurrentgemma-2b"])
def test_non_dense_families_rejected(arch):
    """MoE routing couples rows through capacity, and the recurrent families
    have no vector-pos decode: the engine takes dense families only."""
    with pytest.raises(ValueError, match="dense"):
        ContinuousBatchingEngine(get_smoke_config(arch), batch=2, max_seq=32, device="cpu")


def test_capacity_guard():
    cb = ContinuousBatchingEngine(get_smoke_config("codeqwen15_7b"), batch=2, max_seq=16, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        cb.serve(requests(5, (4, 13)), gen_len=4)
    assert cb.stats["requests"] == 0


@pytest.mark.parametrize("arch, counter", [("codeqwen1.5-7b", "flash_attention_tf32_d128"),
                                           ("minicpm3-4b", "flash_attention_tf32_mla"),
                                           ("nbi-100m", "flash_attention_tf32")])
def test_chip_smoke_counts_continuous_launches(arch, counter):
    """``chip_smoke.py``'s exact counts for continuous batching with f32
    activations at full width and the path's depth (full, or
    ``REDUCED_DEPTH``'s: minicpm3-4b 16 of 62 layers, codeqwen1.5-7b 8 of
    32): each one-row insert's L attentions on the 3xTF32 kernel of the
    arch's heads ((128, 128) for codeqwen1.5-7b: 8 an insert), none on
    another f32 kernel, and a pass's
    norms an insert and a decode step."""
    import sys
    from pathlib import Path

    from repro_torch.configs import get_config

    root = str(Path(__file__).resolve().parent.parent)
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    cfg = chip_smoke.path_config(arch, True).replace(dtype="float32")
    assert cfg.n_layers == chip_smoke.REDUCED_DEPTH.get(arch, get_config(arch).n_layers)
    assert chip_smoke.attention_counter(cfg) == counter
    want = chip_smoke.dense_launches(cfg, prefills=16, decode_steps=64)
    norms = (4 if cfg.attention == "mla" else 2) * cfg.n_layers + 1
    assert want.pop(counter) == 16 * cfg.n_layers and want.pop("rmsnorm") == norms * (16 + 64)
    assert not any(want.values())
