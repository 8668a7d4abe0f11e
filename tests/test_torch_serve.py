"""The port's serving engine on the CPU: greedy tokens against a reference
greedy loop over the JAX package's ``prefill_fn`` / ``decode_fn`` with the same
weights, cache padding, batching, the CPU-only entry-point rules, the
package's import boundary and a CPU rehearsal of ``chip_smoke.py``.

The reference's own ``ServeEngine`` builds a mesh and fails under this JAX
version (ROADMAP hazard H1), so the reference side here is a plain loop over
its model functions, as the reference engine runs them.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.launch.serve import pad_cache_to as jax_pad_cache_to
from repro.models.registry import build_model as jax_build_model
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.launch.serve import ServeEngine, pad_cache_to
from repro_torch.models.registry import build_model

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def engines():
    """Per arch: (port engine on the CPU with the reference's weights,
    reference model, reference params)."""
    built = {}

    def get(arch):
        if arch not in built:
            ref_model = jax_build_model(jax_get_smoke_config(arch))
            ref_params = ref_model.init(jax.random.PRNGKey(0))
            engine = ServeEngine(get_smoke_config(arch), batch=2, max_seq=48, device="cpu")
            engine.params = convert.params_from_jax(
                jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
            built[arch] = (engine, ref_model, ref_params)
        return built[arch]

    return get


def reference_greedy(model, params, prompts, gen_len, max_seq):
    """The reference engine's greedy loop, without its mesh."""
    prefill, decode = jax.jit(model.prefill_fn), jax.jit(model.decode_fn)
    B, P = prompts.shape
    logits, cache = prefill(params, {"tokens": jnp.asarray(prompts)})
    cache = jax_pad_cache_to(cache, model.cache_defs_fn(B, max_seq))
    out = np.zeros((B, gen_len), np.int32)
    tok = jnp.argmax(logits[:, -1], axis=-1)
    for i in range(gen_len):
        out[:, i] = np.asarray(tok)
        logits, cache = decode(params, cache, jnp.asarray(out[:, i : i + 1]), jnp.asarray(P + i, jnp.int32))
        tok = jnp.argmax(logits[:, -1], axis=-1)
    return out


@pytest.mark.parametrize("arch", ["nbi100m", "codeqwen15_7b", "deepseek_moe_16b"])
def test_greedy_tokens_match_reference(arch, engines):
    engine, ref_model, ref_params = engines(arch)
    prompts = np.random.default_rng(0).integers(0, 512, (2, 12)).astype(np.int32)
    got = engine.generate_batch(prompts, gen_len=6)
    want = reference_greedy(ref_model, ref_params, prompts, 6, engine.max_seq)
    np.testing.assert_array_equal(got, want)


def test_greedy_matches_full_recompute(engines):
    """Engine generation equals naive full-recompute greedy decoding."""
    engine = engines("codeqwen15_7b")[0]
    prompts = np.random.default_rng(1).integers(0, 512, (2, 10)).astype(np.int32)
    out = engine.generate_batch(prompts, gen_len=5)
    toks = torch.from_numpy(prompts).long()
    for i in range(5):
        logits, _ = engine.model.prefill_fn(engine.params, {"tokens": toks})
        nxt = logits[:, -1].argmax(-1)
        np.testing.assert_array_equal(out[:, i], nxt.numpy())
        toks = torch.cat([toks, nxt[:, None]], dim=1)


def test_pad_cache_to_pads_seq_axis_and_rejects_oversize():
    model = build_model(get_smoke_config("codeqwen1.5-7b"))
    small = {k: torch.ones(d.shape) for k, d in model.cache_defs_fn(1, 8).items()}
    target = model.cache_defs_fn(1, 32)
    padded = pad_cache_to(small, target)
    for name, leaf in padded.items():
        assert leaf.shape == target[name].shape and leaf.dtype == target[name].dtype
        assert torch.equal(leaf[..., :8, :], small[name])
        assert not leaf[..., 8:, :].any()
    big = {k: torch.ones(d.shape) for k, d in model.cache_defs_fn(1, 64).items()}
    with pytest.raises(ValueError, match="exceeds"):
        pad_cache_to(big, target)


def test_batch_independence_and_request_order(engines):
    """A row's output never depends on its batch-mates, and serve_requests
    returns responses in input order."""
    engine = engines("codeqwen15_7b")[0]
    rng = np.random.default_rng(2)
    a, b1, b2 = (rng.integers(0, 512, (12,)).astype(np.int32) for _ in range(3))
    out1 = engine.generate_batch(np.stack([a, b1]), gen_len=5)
    out2 = engine.generate_batch(np.stack([a, b2]), gen_len=5)
    np.testing.assert_array_equal(out1[0], out2[0])
    reqs = [rng.integers(0, 512, size=n).astype(np.int32) for n in (5, 9, 5, 13, 9)]
    outs = engine.serve_requests(reqs, gen_len=4)
    assert len(outs) == 5 and all(o.shape == (4,) for o in outs)
    for i in (1, 3):
        np.testing.assert_array_equal(engine.serve_requests([reqs[i]], gen_len=4)[0], outs[i])


def test_temperature_sampling_follows_its_generator(engines):
    engine = engines("nbi100m")[0]
    prompts = np.ones((2, 8), np.int32)
    draws = [engine.generate_batch(prompts, gen_len=6, temperature=1.0,
                                   generator=torch.Generator().manual_seed(s)) for s in (7, 7, 8)]
    np.testing.assert_array_equal(draws[0], draws[1])
    assert not np.array_equal(draws[0], draws[2])
    assert draws[0].min() >= 0 and draws[0].max() < engine.model.cfg.vocab_size


def test_engine_guards_batch_and_capacity(engines):
    engine = engines("nbi100m")[0]
    with pytest.raises(ValueError, match="capacity"):
        engine.generate_batch(np.ones((2, 47), np.int32), gen_len=5)
    with pytest.raises(ValueError, match="batch"):
        engine.generate_batch(np.ones((3, 4), np.int32), gen_len=2)


def test_entry_points_without_device_raise_on_cpu_host(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(get_smoke_config("nbi-100m"), batch=1, max_seq=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "nbi-100m", "--smoke"])
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_serve_main_on_cpu(capsys):
    assert serve.main(["--arch", "nbi-100m", "--smoke", "--device", "cpu", "--requests", "3",
                       "--batch", "2", "--gen-len", "3"]) == 0
    assert "tok/s" in capsys.readouterr().out.splitlines()[-1]


def test_chip_smoke_rehearses_on_cpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--rehearse-cpu"],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == '{"ok": true, "rehearsal": "cpu"}'
    assert lines[-2].startswith('{"kernels": [')


def test_port_imports_no_jax_and_nothing_of_repro():
    code = (
        "import sys, repro_torch.launch.serve, repro_torch.convert, repro_torch.kernels._build; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stdout + out.stderr
    for path in [*(ROOT / "src" / "repro_torch").rglob("*.py"), ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), f"{path}: {line}"
