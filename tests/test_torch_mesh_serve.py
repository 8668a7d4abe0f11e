"""Serving on a device mesh (``ServeEngine(mesh=)``,
``ContinuousBatchingEngine(mesh=)``, the split-KV route of
``attention_single_shot``) and the recurrences' local-shard routes
(``ops.lru_scan``, ``ops.wkv6``) against the meshless engines and plain ops,
in gloo process groups of four CPU ranks.

Each mesh runs once, in four processes (``tests/test_torch_mesh_train.py``'s
``run_processes``): for every config named below the mesh engine and a
meshless engine holding the same weights (the mesh engine's, gathered)
generate from the same prompts, and every step's logits are recorded; rank 0
writes both to a file, which the tests read. Meshes: (1, 4) (the cache's
``kv_seq`` over four ranks: split-KV decode), (2, 2) and (4, 1) (the batch
over four ranks). The configs: nbi-100m, mistral-large-123b (4 query heads
over 2 KV heads), deepseek-moe-16b (prompts of 32 tokens: each rank's rows
form whole routing groups of 32 on every mesh; the decode step's group is
the whole batch, gathered), rwkv6-7b and recurrentgemma-2b (a ring of 8
slots, which the prompts of 32 tokens fill and the decode steps wrap),
minicpm3-4b (MLA: the latent cache over ``kv_seq``), llava-next-mistral-7b
(its text: the engine feeds no patches) and whisper-small (zero frames, as
the engine feeds them; the cross cache over ``heads``), at smoke size in
f32. llava's visual prefix (seeded patches, then text) goes through
``make_prefill_step`` and ``make_serve_step`` on every mesh. Continuous
batching for nbi-100m runs on (1, 4) and (2, 2), and for minicpm3-4b on
(1, 4), with prompts of mixed lengths, so that the slots' positions fall in
different ranks' slices of the sequence. The (1, 4) and (2, 2) runs also hold
the split-KV route, MLA's split absorbed decode, Whisper's MLP (its output
bias added once) and the recurrences' routes against the plain functions,
and the (2, 2) run holds the mesh prefill and first decode step of
nbi-100m, minicpm3-4b and whisper-small on the reference's weights
(``convert.params_from_jax``) against the reference's ``prefill_fn`` /
``decode_fn`` called without rules (ROADMAP H1: its meshes fail under this
JAX version).

Tolerances: greedy tokens equal; logits within attention's f32 tolerance,
atol 2e-5 / rtol 1e-4 (the mesh sums in other orders: over shards, then
across ranks); the split-KV route in bf16 within one unit of bf16's last
place (atol 1e-3 / rtol 2**-7); ``lru_scan`` within K3's 1e-5, ``wkv6``
within K4's atol 5e-4 / rtol 1e-3, outputs and gradients; the reference
within ``tests/test_torch_model.py``'s port-against-reference atol 1e-4 /
rtol 1e-4.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_mesh_train import GLOO_TIMEOUT_S, free_port, run_processes

ARCHS = ["nbi-100m", "mistral-large-123b", "deepseek-moe-16b", "rwkv6-7b", "recurrentgemma-2b", "minicpm3-4b",
         "llava-next-mistral-7b", "whisper-small"]
MESHES = {"1x4": [1, 4], "2x2": [2, 2], "4x1": [4, 1]}
BATCH, PROMPT, GEN, MAX_SEQ = 4, 32, 6, 40
CONTINUOUS = {"arch": "nbi-100m", "slots": 4, "max_seq": 48, "lengths": [5, 9, 14, 20, 27, 33, 11], "gen": 6}
CONTINUOUS_MLA = {**CONTINUOUS, "arch": "minicpm3-4b"}
# llava's visual prefix through the prefill and serve steps: its 8 patches and
# 26 text tokens, then GEN tokens, fill MAX_SEQ
PREFIX = {"arch": "llava-next-mistral-7b", "text": MAX_SEQ - 8 - GEN}
ATTN_TOL = {"float32": dict(atol=2e-5, rtol=1e-4), "bfloat16": dict(atol=1e-3, rtol=2**-7)}
LRU_TOL = dict(atol=1e-5, rtol=1e-5)
WKV_TOL = dict(atol=5e-4, rtol=1e-3)
REF_TOL = dict(atol=1e-4, rtol=1e-4)
SPLIT_CASES = ["first_shard", "last_shard", "masked_shards", "window", "logit_cap"]
MLA_SPLIT_CASES = ["first_shard", "last_shard", "masked_shards", "per_row"]
REF_ARCH = "nbi-100m"
REF_FAMILIES = ["minicpm3-4b", "whisper-small"]

WORKER = r'''
import datetime, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch.serve import ContinuousBatchingEngine, ServeEngine, pad_cache_to
from repro_torch.models.common import attention_single_shot
from repro_torch.parallel.sharding import distribute, distribute_tree, full_tree, placements_for, resolve_tree
from repro_torch.training import make_prefill_step, make_serve_step

job = json.loads(sys.argv[1])
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{job['port']}", rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=job["gloo_timeout"]))
mesh = init_device_mesh("cpu", tuple(job["shape"]), mesh_dim_names=("data", "model"))
data, model = job["shape"]
whole = lambda t: t.full_tensor() if ops.is_dtensor(t) else t  # noqa: E731
result = {}


def recorded(engine):
    """Every step's whole logits, recorded around the engine's prefill and decode."""
    seen = []
    for name in ("_prefill", "_decode"):
        fn = getattr(engine, name)

        def run(*args, _fn=fn):
            logits, cache = _fn(*args)
            seen.append(whole(logits).clone())
            return logits, cache

        setattr(engine, name, run)
    return seen


rng = np.random.default_rng(0)
for arch in job["archs"]:
    cfg = get_smoke_config(arch)
    engine = ServeEngine(cfg, batch=job["batch"], max_seq=job["max_seq"], mesh=mesh, device="cpu")
    prompts = rng.integers(0, cfg.vocab_size, size=(job["batch"], job["prompt"])).astype(np.int32)
    got = recorded(engine)
    result[arch] = {"rules": engine.rules, "tokens": engine.generate_batch(prompts, job["gen"]), "logits": got}
    weights = full_tree(engine.params)
    if rank == 0:  # the meshless engine, on the same weights
        plain = ServeEngine(cfg, batch=job["batch"], max_seq=job["max_seq"], device="cpu")
        plain.params = weights
        want = recorded(plain)
        result[arch].update(plain_tokens=plain.generate_batch(prompts, job["gen"]), plain_logits=want)

for key, c in job["continuous"].items():
    cfg = get_smoke_config(c["arch"])
    engine = ContinuousBatchingEngine(cfg, batch=c["slots"], max_seq=c["max_seq"], mesh=mesh, device="cpu")
    requests = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in c["lengths"]]
    got = recorded(engine)
    result[key] = {"rules": engine.rules, "tokens": engine.serve(requests, c["gen"]), "logits": got}
    weights = full_tree(engine.params)
    if rank == 0:
        plain = ContinuousBatchingEngine(cfg, batch=c["slots"], max_seq=c["max_seq"], device="cpu")
        plain.params = weights
        want = recorded(plain)
        result[key].update(plain_tokens=plain.serve(requests, c["gen"]), plain_logits=want)

if job["prefix"]:
    # the visual prefix on the mesh: seeded patches and text through the
    # prefill step, then greedy serve steps, against the plain functions
    from repro_torch.models.registry import build_model
    from repro_torch.parallel.sharding import serve_rules
    from repro_torch.training import init_sharded_params

    cfg = get_smoke_config(job["prefix"]["arch"])
    lm = build_model(cfg)
    B, S = job["batch"], job["prefix"]["text"]
    rules = serve_rules(lm, mesh, B, job["max_seq"])
    params = init_sharded_params(lm, 0, mesh, resolve_tree(mesh, lm.param_logical(), rules), "cpu")
    g = torch.Generator().manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g),
             "patches": torch.randn((B, cfg.n_patches, cfg.d_model), generator=g)}
    cache_pl = resolve_tree(mesh, lm.cache_logical_fn(), rules)
    steps = {"mesh": (make_prefill_step(lm, rules, mesh), make_serve_step(lm, rules, mesh)),
             "plain": (lm.prefill_fn, lm.decode_fn)}
    runs = {}
    for which, (prefill, decode) in steps.items():
        on = which == "mesh"
        p = params if on else full_tree(params)
        feed = distribute_tree(batch, mesh, resolve_tree(mesh, lm.prefill_input_logical(), rules)) if on else batch
        with torch.no_grad():
            logits, cache = prefill(p, feed)
            cache = pad_cache_to(cache, lm.cache_defs_fn(B, job["max_seq"]), cache_pl if on else None)
            seen, toks = [whole(logits)], []
            for i in range(job["gen"]):
                tok = seen[-1][:, -1].argmax(-1)[:, None]
                toks.append(tok)
                if on:
                    tok = distribute(tok, mesh, placements_for(("batch", None), rules, mesh))
                logits, cache = decode(p, cache, tok, cfg.n_patches + S + i)
                seen.append(whole(logits))
        runs[which] = {"logits": seen, "tokens": torch.cat(toks, 1)}
    result["prefix"] = {"rules": rules, "mesh": runs["mesh"], "plain": runs["plain"]}

if job["routes"]:
    # the split-KV route: K and V over their rows (data) and keys (model)
    B, Hq, Hkv, S, d = 4, 4, 2, 32, 16
    kv_pl = (Shard(0) if data > 1 else Replicate(), Shard(2) if model > 1 else Replicate())
    q_pl = (kv_pl[0], Shard(1) if model > 1 else Replicate())  # the heads as the projections leave them
    keys = torch.arange(S)
    cases = {"first_shard": (torch.tensor([3, 2, 1, 0]), 0, 0.0), "last_shard": (torch.tensor([S - 2] * B), 0, 0.0),
             "masked_shards": (torch.tensor([5, 12, 3, 20]), 0, 0.0), "window": (torch.tensor([29, 27, 30, 31]), 6, 0.0),
             "logit_cap": (torch.tensor([20, 9, 31, 16]), 0, 5.0)}
    split = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator().manual_seed(3)
        q, k, v = (torch.randn(shape, generator=g).mul(3).to(dtype) for shape in
                   ((B, Hq, 1, d), (B, Hkv, S, d), (B, Hkv, S, d)))
        for name, (pos, window, cap) in cases.items():
            mask = keys[None, :] <= pos[:, None]
            if window:
                mask &= keys[None, :] > pos[:, None] - window
            mask = mask[:, None, None, None, :]
            with torch.no_grad():
                out = attention_single_shot(distribute(q, mesh, q_pl), distribute(k, mesh, kv_pl),
                                            distribute(v, mesh, kv_pl), mask=mask, logit_cap=cap)
            split[f"{str(dtype)[6:]}-{name}"] = (out.full_tensor(), attention_single_shot(q, k, v, mask=mask,
                                                                                          logit_cap=cap))
    result["split"] = split

    # MLA's absorbed decode: the latent cache over its rows (data) and keys
    # (model), the queries over heads (model)
    from repro_torch.models.transformer import absorbed_attention

    B, H, r, rope = 4, 4, 16, 8
    cache_pl = (Shard(0) if data > 1 else Replicate(), Shard(1) if model > 1 else Replicate())
    heads_pl = (cache_pl[0], Shard(1) if model > 1 else Replicate())
    mla_cases = {"first_shard": torch.tensor(3), "last_shard": torch.tensor(S - 2),
                 "masked_shards": torch.tensor(13), "per_row": torch.tensor([5, 12, 3, 20])}
    mla = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator().manual_seed(4)
        q_abs, q_rope, ckv, krope = (torch.randn(shape, generator=g).mul(2).to(dtype) for shape in
                                     ((B, H, 1, r), (B, H, 1, rope), (B, S, r), (B, S, rope)))
        for name, pos in mla_cases.items():
            mask = (keys[None, :] <= pos.expand(B)[:, None])[:, None, None, :]
            with torch.no_grad():
                out = absorbed_attention(distribute(q_abs, mesh, heads_pl), distribute(q_rope, mesh, heads_pl),
                                         distribute(ckv, mesh, cache_pl), distribute(krope, mesh, cache_pl), mask,
                                         (r + rope) ** -0.5)
            mla[f"{str(dtype)[6:]}-{name}"] = (out.full_tensor(),
                                               absorbed_attention(q_abs, q_rope, ckv, krope, mask, (r + rope) ** -0.5))
    result["mla_split"] = mla

    # Whisper's MLP: ff over model, the output bias (non-zero) added once
    from repro_torch.models import whisper
    from repro_torch.parallel.sharding import use_rules

    cfg = get_smoke_config("whisper-small")
    g = torch.Generator().manual_seed(8)
    D, F_ = cfg.d_model, cfg.d_ff
    mlp = {"wi": torch.randn((D, F_), generator=g) / D ** 0.5, "bi": torch.randn((F_,), generator=g),
           "wo": torch.randn((F_, D), generator=g) / F_ ** 0.5, "bo": torch.randn((D,), generator=g)}
    mlp_pl = {"wi": (Replicate(), Shard(1) if model > 1 else Replicate()),
              "bi": (Replicate(), Shard(0) if model > 1 else Replicate()),
              "wo": (Replicate(), Shard(0) if model > 1 else Replicate()), "bo": (Replicate(), Replicate())}
    x = torch.randn((4, 6, D), generator=g)
    x_pl = (Shard(0) if data > 1 else Replicate(), Replicate())
    mlp_rules = {"batch": "data" if data > 1 else None, "ff": "model" if model > 1 else None, "seq": None}
    with use_rules(mlp_rules, mesh):
        y = whisper._mlp(distribute_tree(mlp, mesh, mlp_pl), distribute(x, mesh, x_pl))
    result["whisper_mlp"] = (whole(y), whisper._mlp(mlp, x), mlp["bo"])

    # the recurrences: batch over data, channels (lru) or heads (wkv6) over model
    rows, chan = (Shard(0) if data > 1 else Replicate()), (lambda dim: Shard(dim) if model > 1 else Replicate())
    g = torch.Generator().manual_seed(5)
    a = torch.rand((4, 16, 8), generator=g) * 0.9 + 0.05
    b, h0 = torch.randn((4, 16, 8), generator=g), torch.randn((4, 8), generator=g)
    ga, gb = torch.randn((4, 16, 8), generator=g), torch.randn((4, 8), generator=g)
    pl = {"a": (rows, chan(2)), "b": (rows, chan(2)), "h0": (rows, chan(1))}
    ins = {"a": a, "b": b, "h0": h0}
    leaves = {n: distribute(t, mesh, pl[n]).detach().requires_grad_() for n, t in ins.items()}
    outs = ops.lru_scan(*leaves.values())
    grads = torch.autograd.grad(outs, list(leaves.values()),
                                (distribute(ga, mesh, pl["a"]), distribute(gb, mesh, pl["h0"])))
    plain_leaves = {n: t.clone().requires_grad_() for n, t in ins.items()}
    plain_outs = ops.lru_scan(*plain_leaves.values())
    result["lru_scan"] = {"got": [whole(o) for o in outs] + [whole(x) for x in grads],
                          "want": list(plain_outs) + list(torch.autograd.grad(plain_outs, list(plain_leaves.values()),
                                                                              (ga, gb)))}
    shapes = {"r": (4, 4, 16, 8), "k": (4, 4, 16, 8), "v": (4, 4, 16, 8), "w": (4, 4, 16, 8), "u": (4, 8),
              "s0": (4, 4, 8, 8)}
    ins = {n: torch.randn(s, generator=g) * 0.5 for n, s in shapes.items()}
    ins["w"] = torch.rand(shapes["w"], generator=g) * 0.5 + 0.45
    pl = {n: (rows, chan(1)) for n in shapes}
    pl["u"] = (Replicate(), chan(0))  # the bonus is split with its heads, replicated over the rows
    gy, gs = torch.randn((4, 4, 16, 8), generator=g), torch.randn((4, 4, 8, 8), generator=g)
    leaves = {n: distribute(t, mesh, pl[n]).detach().requires_grad_() for n, t in ins.items()}
    outs = ops.wkv6(*leaves.values())
    grads = torch.autograd.grad(outs, list(leaves.values()),
                                (distribute(gy, mesh, pl["r"]), distribute(gs, mesh, pl["s0"])))
    plain_leaves = {n: t.clone().requires_grad_() for n, t in ins.items()}
    plain_outs = ops.wkv6(*plain_leaves.values())
    result["wkv6"] = {"got": [whole(o) for o in outs] + [whole(x) for x in grads],
                      "want": list(plain_outs) + list(torch.autograd.grad(plain_outs, list(plain_leaves.values()),
                                                                          (gy, gs)))}

for arch, path in (job["ref_weights"] or {}).items():
    ref = torch.load(path)
    cfg = get_smoke_config(arch)
    B, P = ref["batch"]["tokens"].shape
    engine = ServeEngine(cfg, batch=B, max_seq=job["max_seq"], mesh=mesh, device="cpu")
    model, rules = engine.model, engine.rules
    params = distribute_tree(ref["params"], mesh, resolve_tree(mesh, model.param_logical(), rules))
    batch = distribute_tree(ref["batch"], mesh, resolve_tree(mesh, model.prefill_input_logical(), rules))
    with torch.no_grad():
        logits, cache = make_prefill_step(model, rules, mesh)(params, batch)
        cache = pad_cache_to(cache, model.cache_defs_fn(B, job["max_seq"]),
                             resolve_tree(mesh, model.cache_logical_fn(), rules))
        step = distribute(ref["next"], mesh, placements_for(("batch", None), rules, mesh))
        logits2, _ = make_serve_step(model, rules, mesh)(params, cache, step, P)
    result["ref_case" if arch == job["ref_arch"] else f"ref_case {arch}"] = {"prefill": whole(logits),
                                                                             "decode": whole(logits2)}

if rank == 0:
    torch.save(result, os.path.join(job["out"], "result.pt"))
dist.destroy_process_group()
'''


def run_mesh(out: Path, shape, **job) -> dict:
    arg = json.dumps({"shape": shape, "out": str(out), "port": free_port(), "gloo_timeout": GLOO_TIMEOUT_S,
                      "archs": ARCHS, "batch": BATCH, "prompt": PROMPT, "gen": GEN, "max_seq": MAX_SEQ,
                      "ref_arch": REF_ARCH, **job})
    run_processes([[sys.executable, "-c", WORKER, arg]] * 4,
                  [{"WORLD_SIZE": "4", "RANK": str(r)} for r in range(4)], out)
    return torch.load(out / "result.pt", weights_only=False)


def reference_run(tmp_path_factory, arch: str) -> tuple:
    """The reference's smoke weights of ``arch`` (converted), prompts (and
    seeded audio frames for Whisper), and the reference's prefill logits and
    first decode step's logits without rules."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as jax_get_smoke_config
    from repro.launch.serve import pad_cache_to as jax_pad_cache_to
    from repro.models.registry import build_model as jax_build_model
    from repro_torch import convert

    jnp = jax.numpy
    cfg = jax_get_smoke_config(arch)
    jmodel = jax_build_model(cfg)
    np_params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(2)))
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    rng = np.random.default_rng(12)
    batch = {"tokens": rng.integers(0, 512, (BATCH, PROMPT)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((BATCH, cfg.enc_len, cfg.d_model)).astype(np.float32)
    logits, cache = jmodel.prefill_fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    cache = jax_pad_cache_to(cache, jmodel.cache_defs_fn(BATCH, MAX_SEQ))
    nxt = np.asarray(jnp.argmax(logits[:, -1], axis=-1))[:, None].astype(np.int32)
    logits2, _ = jmodel.decode_fn(params, cache, jnp.asarray(nxt), jnp.asarray(PROMPT, jnp.int32))
    path = tmp_path_factory.mktemp("ref") / f"{arch}.pt"
    batch = {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v) for k, v in batch.items()}
    torch.save({"params": convert.params_from_jax(np_params, device="cpu"), "batch": batch,
                "next": torch.from_numpy(nxt).long()}, path)
    return path, {"prefill": np.asarray(logits), "decode": np.asarray(logits2)}


@pytest.fixture(scope="module")
def reference_case(tmp_path_factory):
    """nbi-100m's :func:`reference_run`."""
    return reference_run(tmp_path_factory, REF_ARCH)


@pytest.fixture(scope="module")
def reference_families(tmp_path_factory):
    """MLA's and Whisper's :func:`reference_run`."""
    return {arch: reference_run(tmp_path_factory, arch) for arch in REF_FAMILIES}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, reference_case, reference_families):
    """Each mesh's run, made on first use."""
    made = {}
    refs = {REF_ARCH: str(reference_case[0]), **{a: str(r[0]) for a, r in reference_families.items()}}

    def get(mesh: str) -> dict:
        if mesh not in made:
            out = tmp_path_factory.mktemp(f"serve_{mesh}")
            continuous = {"continuous": CONTINUOUS} if mesh in ("1x4", "2x2") else {}
            if mesh == "1x4":
                continuous["continuous_mla"] = CONTINUOUS_MLA
            made[mesh] = run_mesh(out, MESHES[mesh], continuous=continuous, prefix=PREFIX,
                                  routes=mesh in ("1x4", "2x2"), ref_weights=refs if mesh == "2x2" else None)
        return made[mesh]

    return get


def close(got, want, what, atol, rtol):
    got, want = (np.asarray(t.detach().double()) if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)
                 for t in (got, want))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want) - (atol + rtol * np.abs(want))
    assert err.max(initial=-1) <= 0, f"{what}: past atol {atol} / rtol {rtol} by {err.max()}"


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_engine_matches_the_plain_engine(runs, mesh, arch):
    r = runs(mesh)[arch]
    rules = r["rules"]
    assert rules["batch"] == "data" or MESHES[mesh][0] == 1
    if mesh == "1x4":
        assert rules["kv_seq"] == "model"  # split-KV decode over four ranks
    np.testing.assert_array_equal(r["tokens"], r["plain_tokens"])
    assert len(r["logits"]) == len(r["plain_logits"]) == GEN + 1  # the prefill and GEN decode steps
    for i, (got, want) in enumerate(zip(r["logits"], r["plain_logits"])):
        close(got, want, f"{arch} step {i} logits", **ATTN_TOL["float32"])


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_continuous_engine_on_a_mesh(runs, mesh):
    """Per-row positions over a sequence split four (1 x 4) or two (2 x 2)
    ways: the slots' writes and keys land on different ranks."""
    r = runs(mesh)["continuous"]
    assert r["rules"]["kv_seq"] == "model"
    for got, want in zip(r["tokens"], r["plain_tokens"]):
        np.testing.assert_array_equal(got, want)
    assert len(r["logits"]) == len(r["plain_logits"])
    for i, (got, want) in enumerate(zip(r["logits"], r["plain_logits"])):
        close(got, want, f"continuous step {i} logits", **ATTN_TOL["float32"])


@pytest.mark.parametrize("case", SPLIT_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_split_kv_attention_matches_the_plain_function(runs, mesh, dtype, case):
    """Positions in the first slice of the keys and in the last, slices whose
    keys are all masked (they add exactly 0), a window, a logit cap."""
    got, want = runs(mesh)["split"][f"{dtype}-{case}"]
    assert got.dtype == want.dtype == getattr(torch, dtype)
    close(got, want, f"split-KV {dtype} {case}", **ATTN_TOL[dtype])


@pytest.mark.parametrize("op", ["lru_scan", "wkv6"])
@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_recurrence_routes_match_the_plain_ops(runs, mesh, op):
    """Outputs and the gradients of every input (``u``'s partial over the
    rows summed across ranks)."""
    r = runs(mesh)[op]
    assert len(r["got"]) == len(r["want"])
    for i, (got, want) in enumerate(zip(r["got"], r["want"])):
        close(got, want, f"{op} output/gradient {i}", **(LRU_TOL if op == "lru_scan" else WKV_TOL))


def test_mesh_prefill_and_decode_match_the_reference(runs, reference_case):
    """nbi-100m's prefill and first decode step on the reference's weights on
    (2, 2) (vocab, heads, ff and kv_seq over model, the batch over data),
    against the reference's functions without rules."""
    got = runs("2x2")["ref_case"]
    _, want = reference_case
    for name in ("prefill", "decode"):
        close(got[name], want[name], name, **REF_TOL)


@pytest.mark.parametrize("arch", REF_FAMILIES)
def test_mla_and_whisper_on_a_mesh_match_the_reference(runs, reference_families, arch):
    """MLA's (minicpm3-4b: the split absorbed decode over the ``kv_seq``-split
    latent cache) and Whisper's (seeded frames; the cross cache over heads)
    prefill and first decode step on the reference's weights on (2, 2),
    against the reference's functions without rules."""
    got = runs("2x2")[f"ref_case {arch}"]
    _, want = reference_families[arch]
    for name in ("prefill", "decode"):
        close(got[name], want[name], f"{arch} {name}", **REF_TOL)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_visual_prefix_on_a_mesh(runs, mesh):
    """llava's patches and text through ``make_prefill_step`` and greedy
    ``make_serve_step`` steps on the mesh, against the plain functions on
    the same weights: tokens equal, logits within attention's f32
    tolerance."""
    r = runs(mesh)["prefix"]
    assert r["rules"]["batch"] == "data" or MESHES[mesh][0] == 1
    assert torch.equal(r["mesh"]["tokens"], r["plain"]["tokens"])
    assert len(r["mesh"]["logits"]) == GEN + 1
    for i, (got, want) in enumerate(zip(r["mesh"]["logits"], r["plain"]["logits"])):
        close(got, want, f"prefix step {i} logits", **ATTN_TOL["float32"])


def test_continuous_mla_engine_on_a_mesh(runs):
    """minicpm3-4b's slots on (1, 4): one-row inserts through MLA's prefill on
    each rank's heads, per-row positions over a latent cache split four
    ways (the slots' writes and keys on different ranks)."""
    r = runs("1x4")["continuous_mla"]
    assert r["rules"]["kv_seq"] == "model" and r["rules"]["heads"] == "model"
    for got, want in zip(r["tokens"], r["plain_tokens"]):
        np.testing.assert_array_equal(got, want)
    assert len(r["logits"]) == len(r["plain_logits"])
    for i, (got, want) in enumerate(zip(r["logits"], r["plain_logits"])):
        close(got, want, f"continuous MLA step {i} logits", **ATTN_TOL["float32"])


@pytest.mark.parametrize("case", MLA_SPLIT_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_split_absorbed_decode_matches_the_plain_function(runs, mesh, dtype, case):
    """MLA's absorbed decode over a latent cache split over its keys: a
    position in the first slice and in the last, slices whose keys are all
    masked (they add exactly 0), per-row positions."""
    got, want = runs(mesh)["mla_split"][f"{dtype}-{case}"]
    assert got.dtype == want.dtype == getattr(torch, dtype)
    close(got, want, f"split absorbed {dtype} {case}", **ATTN_TOL[dtype])


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_whisper_mlp_adds_its_output_bias_once(runs, mesh):
    """Whisper's MLP with ``ff`` over model and a non-zero output bias: added
    to each rank's partial sum it would be off by (M - 1)·bo (M the model
    axis' size); added once after the all-reduce it is the plain MLP."""
    got, want, bo = runs(mesh)["whisper_mlp"]
    assert float(bo.abs().min()) > ATTN_TOL["float32"]["atol"] * 10
    close(got, want, "whisper _mlp", **ATTN_TOL["float32"])
