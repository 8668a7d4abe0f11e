"""The mesh engines' decode graph (``launch/serve.py``'s ``_DecodeGraph`` with
an ``_OnMesh``: the counterpart of the reference's ``jax.jit`` over its
sharded decode step) on the CPU, where the same static DTensor cache, token
and position buffers and the same copy-in run and the step under the rules
is called eagerly (the capture itself needs the card: the ``gpu`` test at
the end).

One spawn of four gloo ranks builds the (2, 2) and the (1, 4) mesh from one
process group (``tests/test_torch_mesh_train.py``'s ``run_processes``) and,
on each mesh, for every family the engines serve (nbi-100m, MLA, the visual
prefix's text, MoE, Griffin, RWKV-6 and Whisper fed zero frames, at smoke
size in f32, on the reference's weights carried over with
``convert.params_from_jax``):

- two batches of different prompt lengths, the longer first, through one
  mesh engine's static cache, against the meshless engine on the same
  weights and the reference's jitted greedy loop over its ``prefill_fn`` /
  ``decode_fn`` without rules (ROADMAP H1: its meshes fail under this JAX
  version); Griffin's second prompts (5 tokens) leave 3 of its 8 ring slots
  empty, deepseek-moe-16b's prompts (32 and 16 tokens) give each data shard
  whole routing groups;
- :func:`fill_cache` over a static DTensor cache holding garbage (NaN, or 99
  in integer leaves) on every local element, against :func:`pad_cache_to`'s
  fresh cache in the same placements;
- a decode step at a 0-dim position tensor (what the graph feeds) against the
  step at the Python int, bit for bit;

and two continuous serves (nbi-100m on (2, 2), minicpm3-4b on (1, 4), the
second serve with the requests in reverse order) through one mesh engine,
against each other and greedy full recompute through the plain prefill on
the same weights (the port's, held to the reference's in
``tests/test_torch_decode_graph.py``). The rank's graph
refuses buffers other than its own, its static buffers are laid out on the
mesh (the tokens' rows over ``data``, the cache's ``kv_seq`` over ``model``)
and keep their addresses, and on the CPU no step replays. The parent runs
the reference and the meshless engine while the ranks run.

Tolerances (``tests/test_torch_mesh_serve.py``'s): greedy tokens equal;
logits against the meshless engine within attention's f32 atol 2e-5 / rtol
1e-4 (the mesh sums in other orders), against the reference within atol
1e-4 / rtol 1e-4; the static cache and the tensor position bit for bit.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import ContinuousBatchingEngine, ServeEngine
from repro_torch.models.registry import build_model

ARCHS = ["nbi-100m", "minicpm3-4b", "llava-next-mistral-7b", "deepseek-moe-16b", "recurrentgemma-2b", "rwkv6-7b",
         "whisper-small"]
MESHES = {"2x2": [2, 2], "1x4": [1, 4]}
B, GEN, MAX_SEQ = 4, 3, 40
LENGTHS = {arch: (12, 5) for arch in ARCHS}
LENGTHS["deepseek-moe-16b"] = (32, 16)  # 2 rows a data shard: whole groups of 32 tokens
# continuous batching: GQA on (2, 2), MLA on (1, 4)
CONTINUOUS = {"archs": {"2x2": "nbi-100m", "1x4": "minicpm3-4b"}, "slots": 4, "max_seq": 32,
              "lengths": [11, 4, 8, 12, 6], "gen": 4}
ATTN_TOL = dict(atol=2e-5, rtol=1e-4)
REF_TOL = dict(atol=1e-4, rtol=1e-4)
RUN_TIMEOUT = 240
GLOO_TIMEOUT_S = 120

WORKER = r'''
import datetime, json, os, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch.serve import ContinuousBatchingEngine, ServeEngine, fill_cache, pad_cache_to
from repro_torch.models.common import map_defs, tree_leaves
from repro_torch.parallel.sharding import distribute, distribute_tree, full_tree

job = json.loads(sys.argv[1])
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{job['port']}", rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=job["gloo_timeout"]))
ref = torch.load(job["inputs"])
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


def addresses(graph):
    """The addresses of this rank's shards of the static buffers."""
    return ([leaf.to_local().data_ptr() for _, leaf in tree_leaves(graph.cache)]
            + [graph.tokens.to_local().data_ptr(), graph.pos.data_ptr()])


def prefill_inputs(cfg, on, prompts):
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.long)}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((prompts.shape[0], cfg.enc_len, cfg.d_model))
    return on.place(batch, on.inputs)


def layout(tree):
    return {path: (str(tuple(leaf.placements)), tuple(leaf.to_local().shape)) for path, leaf in tree_leaves(tree)}


for name, shape in job["meshes"].items():
    mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=("data", "model"))
    out = result[name] = {}
    for arch in job["archs"]:
        cfg = get_smoke_config(arch)
        engine = ServeEngine(cfg, batch=job["batch"], max_seq=job["max_seq"], mesh=mesh, device="cpu")
        on, graph = engine._on, engine._graph
        engine.params = distribute_tree(ref[arch]["params"], mesh, on.weights)
        before = addresses(graph)
        seen = recorded(engine)
        tokens = [engine.generate_batch(p.numpy(), job["gen"]) for p in ref[arch]["prompts"]]
        r = out[arch] = {"rules": engine.rules, "tokens": tokens, "logits": seen, "stats": dict(engine.stats),
                         "kept": addresses(graph) == before, "tokens_layout": str(tuple(graph.tokens.placements)),
                         "cache_layout": layout(graph.cache)}

        # fill_cache over garbage on every local element of a static cache
        short = ref[arch]["prompts"][-1].numpy()
        defs = engine.model.cache_defs_fn(job["batch"], job["max_seq"])
        static = on.empty_cache(defs)
        for _, leaf in tree_leaves(static):
            leaf.to_local().fill_(float("nan") if leaf.dtype.is_floating_point else 99)
        with torch.no_grad():
            _, cache = on.prefill(engine.params, prefill_inputs(cfg, on, short))
            fill_cache(static, cache)
            fresh = pad_cache_to(cache, defs, on.cache)
        r["fill"] = {"got": full_tree(static), "want": full_tree(fresh), "got_layout": layout(static),
                     "want_layout": layout(fresh)}

        # a step at a 0-dim position tensor against the step at the int
        P = short.shape[1]
        with torch.no_grad():
            caches = [map_defs(torch.clone, graph.cache) for _ in range(2)]
            tok = distribute(torch.arange(3, 3 + job["batch"])[:, None], mesh, on.tokens)
            at_int, _ = on.step(engine.params, caches[0], tok, P)
            at_tensor, _ = on.step(engine.params, caches[1], tok, torch.tensor(P))
        r["pos"] = {"int": (at_int, full_tree(caches[0])), "tensor": (at_tensor, full_tree(caches[1]))}

        if arch == job["archs"][0]:  # the graph steps only its own buffers
            refused = []
            with torch.no_grad():
                for args in ((map_defs(torch.clone, graph.cache), graph.tokens, graph.pos),
                             (graph.cache, torch.clone(graph.tokens), graph.pos), (graph.cache, graph.tokens, 3)):
                    try:
                        graph(engine.params, *args)
                        refused.append(None)
                    except ValueError as e:
                        refused.append(str(e))
            out["refused"] = refused

    c = job["continuous"]
    arch = c["archs"][name]
    cb = ContinuousBatchingEngine(get_smoke_config(arch), batch=c["slots"], max_seq=c["max_seq"], mesh=mesh,
                                  device="cpu")
    cb.params = distribute_tree(ref[arch]["params"], mesh, cb._on.weights)
    reqs = [t.numpy() for t in ref["requests"]]
    before = addresses(cb._graph)
    first = cb.serve(reqs, c["gen"])
    second = cb.serve(reqs[::-1], c["gen"])[::-1]
    out[f"continuous {arch}"] = {"first": first, "second": second, "stats": dict(cb.stats),
                                 "kept": addresses(cb._graph) == before}

if rank == 0:
    torch.save(result, os.path.join(job["out"], "result.pt"))
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_get_smoke_config
    from repro.launch.serve import pad_cache_to as jax_pad_cache_to
    from repro.models.registry import build_model as jax_build_model

    return types.SimpleNamespace(jax=jax, jnp=jnp, get_smoke_config=jax_get_smoke_config, build_model=jax_build_model,
                                 pad_cache_to=jax_pad_cache_to)


def reference_greedy(jx, model, params, prompts, gen_len: int) -> tuple:
    """The reference engine's greedy loop, jitted, without its mesh (an
    encoder-decoder fed zero frames, as the reference's engine feeds them):
    (tokens, the prefill's and every decode step's logits)."""
    prefill, decode = jx.jax.jit(model.prefill_fn), jx.jax.jit(model.decode_fn)
    Bn, P = prompts.shape
    batch = {"tokens": jx.jnp.asarray(prompts)}
    if model.cfg.family == "encdec":
        batch["frames"] = jx.jnp.zeros((Bn, model.cfg.enc_len, model.cfg.d_model), jx.jnp.float32)
    logits, cache = prefill(params, batch)
    cache = jx.pad_cache_to(cache, model.cache_defs_fn(Bn, MAX_SEQ))
    out, seen = np.zeros((Bn, gen_len), np.int32), [np.asarray(logits)]
    for i in range(gen_len):
        out[:, i] = np.asarray(jx.jnp.argmax(logits[:, -1], axis=-1))
        logits, cache = decode(params, cache, jx.jnp.asarray(out[:, i : i + 1]), jx.jnp.asarray(P + i, jx.jnp.int32))
        seen.append(np.asarray(logits))
    return out, seen


@torch.inference_mode()
def full_recompute(model, params, request, gen_len: int) -> list:
    """Greedy full recompute of one request through the port's plain prefill
    (no mesh, no cache carried between tokens)."""
    toks, want = torch.as_tensor(request[None], dtype=torch.long), []
    for _ in range(gen_len):
        want.append(int(model.prefill_fn(params, {"tokens": toks})[0][0, -1].argmax()))
        toks = torch.cat([toks, torch.tensor([[want[-1]]])], dim=1)
    return want


def recorded(engine) -> list:
    """Every step's logits, recorded around the meshless engine's prefill and decode."""
    seen = []
    for name in ("_prefill", "_decode"):
        fn = getattr(engine, name)

        def run(*args, _fn=fn):
            logits, cache = _fn(*args)
            seen.append(logits.clone())
            return logits, cache

        setattr(engine, name, run)
    return seen


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jx):
    """The ranks' results (per mesh), and on the same weights and prompts the
    reference's greedy loops, the meshless engine's, and the continuous
    requests' full recompute, made while the ranks run."""
    from test_torch_mesh_train import run_processes

    out = tmp_path_factory.mktemp("mesh_decode_graph")
    rng = np.random.default_rng(11)
    inputs, refs = {}, {}
    for arch in ARCHS:
        params = build_model(get_smoke_config(arch)).init(torch.Generator().manual_seed(0), "cpu")
        refs[arch] = (jx.build_model(jx.get_smoke_config(arch)),
                      jx.jax.tree_util.tree_map(jx.jnp.asarray, convert.params_to_numpy(params)))
        inputs[arch] = {"params": params, "prompts": [torch.from_numpy(rng.integers(0, 512, (B, n)).astype(np.int32))
                                                      for n in LENGTHS[arch]]}
    inputs["requests"] = [torch.from_numpy(rng.integers(0, 512, n).astype(np.int32)) for n in CONTINUOUS["lengths"]]
    torch.save(inputs, out / "inputs.pt")
    job = {"meshes": MESHES, "archs": ARCHS, "batch": B, "gen": GEN, "max_seq": MAX_SEQ, "continuous": CONTINUOUS,
           "inputs": str(out / "inputs.pt"), "out": str(out), "port": free_port(), "gloo_timeout": GLOO_TIMEOUT_S}
    failed = []

    def ranks():
        try:
            run_processes([[sys.executable, "-c", WORKER, json.dumps(job)]] * 4,
                          [{"WORLD_SIZE": "4", "RANK": str(r)} for r in range(4)], out, RUN_TIMEOUT)
        except BaseException as e:  # noqa: BLE001 - raised again in the test's thread
            failed.append(e)

    thread = threading.Thread(target=ranks)
    thread.start()
    want = {}
    try:
        for arch in ARCHS:
            model, params = refs[arch]
            plain = ServeEngine(get_smoke_config(arch), batch=B, max_seq=MAX_SEQ, device="cpu")
            plain.params = inputs[arch]["params"]
            seen = recorded(plain)
            want[arch] = {"reference": [reference_greedy(jx, model, params, p.numpy(), GEN)
                                        for p in inputs[arch]["prompts"]],
                          "plain_tokens": [plain.generate_batch(p.numpy(), GEN) for p in inputs[arch]["prompts"]],
                          "plain_logits": seen}
        for arch in set(CONTINUOUS["archs"].values()):
            model = build_model(get_smoke_config(arch))
            want[f"continuous {arch}"] = [full_recompute(model, inputs[arch]["params"], r.numpy(), CONTINUOUS["gen"])
                                          for r in inputs["requests"]]
    finally:
        thread.join()
    if failed:
        raise failed[0]
    return torch.load(out / "result.pt", weights_only=False), want


def close(got, want, what, atol, rtol):
    got, want = (np.asarray(t.detach().double()) if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)
                 for t in (got, want))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want) - (atol + rtol * np.abs(want))
    assert err.max(initial=-1) <= 0, f"{what}: past atol {atol} / rtol {rtol} by {err.max()}"


def same_tree(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    for name in got:
        if isinstance(got[name], dict):
            same_tree(got[name], want[name], f"{what}/{name}")
        else:
            assert got[name].dtype == want[name].dtype and torch.equal(got[name], want[name]), f"{what}/{name}"


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_two_batches_through_the_static_cache_match_the_plain_engine_and_the_reference(runs, mesh, arch):
    """Each batch's greedy tokens equal the meshless engine's and the
    reference's, the second (shorter) batch after the first has filled the
    static cache; every step's logits within tolerance of both; the static
    buffers keep their addresses; on the CPU no step replays."""
    got, want = runs[0][mesh][arch], runs[1][arch]
    assert got["rules"]["batch"] == "data" or MESHES[mesh][0] == 1
    if mesh == "1x4":
        assert got["rules"]["kv_seq"] == "model"  # split-KV decode over four ranks
    assert got["kept"] and got["stats"]["decode_replays"] == 0 and got["stats"]["decode_steps"] == 2 * GEN
    ref_logits = []
    for i, (tokens, (ref_tokens, ref_seen)) in enumerate(zip(got["tokens"], want["reference"])):
        np.testing.assert_array_equal(tokens, want["plain_tokens"][i])
        np.testing.assert_array_equal(tokens, ref_tokens)
        ref_logits += ref_seen
    assert len(got["logits"]) == len(want["plain_logits"]) == len(ref_logits) == 2 * (GEN + 1)
    for i, (logits, plain, ref) in enumerate(zip(got["logits"], want["plain_logits"], ref_logits)):
        close(logits, plain, f"{arch} step {i} logits against the meshless engine", **ATTN_TOL)
        close(logits, ref, f"{arch} step {i} logits against the reference", **REF_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_fill_cache_rewrites_every_local_element(runs, mesh, arch):
    """A static DTensor cache holding garbage on every rank's shard takes a
    mesh prefill's cache to exactly :func:`pad_cache_to`'s fresh cache in the
    same placements and local shapes: zeros past the prompt, Griffin's ring
    positions -1 in its empty slots."""
    fill = runs[0][mesh][arch]["fill"]
    assert fill["got_layout"] == fill["want_layout"]
    same_tree(fill["got"], fill["want"], arch)
    if arch == "recurrentgemma-2b":
        pos = fill["got"]["attn"]["pos"]
        assert (pos == -1).sum() == pos.shape[0] * (get_smoke_config(arch).window - LENGTHS[arch][1])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_decode_at_a_tensor_position_on_a_mesh_equals_the_int(runs, mesh, arch):
    """The mesh step under the rules at a 0-dim long ``pos`` tensor (what the
    graph feeds; every rank holds it alike) equals the step at the Python
    int, bit for bit: the whole logits and every cache leaf."""
    pos = runs[0][mesh][arch]["pos"]
    assert torch.equal(pos["int"][0], pos["tensor"][0])
    same_tree(pos["int"][1], pos["tensor"][1], arch)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_two_continuous_serves_on_a_mesh_equal_each_other_and_full_recompute(runs, mesh):
    """Two ``serve()`` calls through one mesh engine's static cache, the
    second with the requests in reverse order (other slots, on other data
    shards): each request's tokens equal across the calls and equal greedy
    full recompute through the plain prefill on the same weights."""
    arch = CONTINUOUS["archs"][mesh]
    got, want = runs[0][mesh][f"continuous {arch}"], runs[1][f"continuous {arch}"]
    assert got["kept"] and got["stats"]["decode_replays"] == 0 and got["stats"]["decode_steps"] > 0
    for i, w in enumerate(want):
        assert got["first"][i].tolist() == w and got["second"][i].tolist() == w, i


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_the_mesh_graph_lays_out_and_steps_only_its_own_buffers(runs, mesh):
    """The static tokens' rows are split over ``data`` and the cache's
    ``kv_seq`` dim over ``model`` (no rank holds the whole cache); the
    graph refuses another cache, other tokens and an int position."""
    got = runs[0][mesh]
    assert got["refused"] == ["a decode graph steps its own static cache, tokens and position"] * 3
    data, model = MESHES[mesh]
    k = got["nbi-100m"]["cache_layout"]["['k']"]
    assert got["nbi-100m"]["tokens_layout"] == "(Shard(dim=0), Replicate())"  # the rows over data
    assert k[1][3] == MAX_SEQ // model and (model == 1 or "Shard(dim=3)" in k[0])


GPU_WORKER = r'''
import faulthandler, gc, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch.serve import ServeEngine, pad_cache_to
from repro_torch.parallel.sharding import distribute

job = json.loads(sys.argv[1])
faulthandler.dump_traceback_later(job["hang_s"], exit=True)  # a rank that hangs shows where, and fails
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dev = torch.device(job["device"], rank if job["device"] == "cuda" else None)
if dev.type == "cuda":
    torch.cuda.set_device(dev)
torch.backends.cuda.matmul.allow_tf32 = False
dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=f"tcp://localhost:{job['port']}",
                        rank=rank, world_size=world)
mesh = init_device_mesh(dev.type, tuple(job["shape"]), mesh_dim_names=("data", "model"))
whole = lambda t: t.full_tensor() if ops.is_dtensor(t) else t  # noqa: E731
cfg = get_smoke_config(job["arch"]).replace(**job["widths"])
B, P, gen, max_seq = job["batch"], job["prompt"], job["gen"], job["max_seq"]
engine = ServeEngine(cfg, batch=B, max_seq=max_seq, mesh=mesh, device=dev)
prompts = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
engine.generate_batch(prompts, gen_len=2)  # the warm-up step and the capture
seen, decode = [], engine._decode


def record(*args):
    logits, cache = decode(*args)
    seen.append(logits.clone())
    return logits, cache


engine._decode = record
engine.stats.update(decode_steps=0, decode_replays=0)
got = engine.generate_batch(prompts, gen_len=gen)
on = engine._on
with torch.no_grad():  # the eager mesh step on a fresh cache
    batch = on.place({"tokens": torch.as_tensor(prompts, dtype=torch.long, device=dev)}, on.inputs)
    logits, cache = on.prefill(engine.params, batch)
    cache = pad_cache_to(cache, engine.model.cache_defs_fn(B, max_seq), on.cache)
    want, eager = np.zeros((B, gen), np.int32), []
    for i in range(gen):
        tok = whole(logits)[:, -1].argmax(-1)
        want[:, i] = tok.cpu().numpy()
        logits, cache = on.decode(engine.params, cache, distribute(tok[:, None], mesh, on.tokens), P + i)
        eager.append(whole(logits))
result = {"steps": engine.stats["decode_steps"], "replays": engine.stats["decode_replays"],
          "tokens_equal": bool(np.array_equal(got, want)),
          "logits_equal": [bool(torch.equal(a, b)) for a, b in zip(seen, eager)]}
if rank == 0:
    with open(job["out"], "w") as f:
        json.dump(result, f)
# the graph goes before the group: it holds the NCCL calls it captured
del engine, decode, record
gc.collect()
dist.destroy_process_group()
'''

# smoke configs at the kernels' head widths (the card's wrappers refuse the
# smoke configs' 16-wide heads): K1 f32 (64, 64), K2, and K5 at E 64
CARD_WIDTHS = {
    "nbi100m": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=64, d_ff=256),
    "deepseek_moe_16b": dict(d_model=128, n_heads=4, n_kv_heads=4, head_dim=64, d_ff=256, moe_d_ff=64,
                             n_experts=64, top_k=6, moe_group_tokens=32),
}
# one NCCL rank on one card (chip_smoke.py's mesh leg), or four ranks over
# the kv_seq of the cache (split-KV: the all-reduces under the capture) on
# four cards
CARD_MESHES = {"1x1": [1, 1], "1x4": [1, 4]}
GPU_TIMEOUT_S = 300


@pytest.mark.gpu
@pytest.mark.parametrize("mesh", sorted(CARD_MESHES))
@pytest.mark.parametrize("arch", sorted(CARD_WIDTHS))
def test_mesh_replay_equals_the_eager_mesh_step_on_the_card(tmp_path, arch, mesh):
    """On the card a warmed mesh engine decodes by replay only, and its greedy
    tokens and every step's whole logits equal an eager loop over the mesh
    engine's own prefill and decode steps with the same weights, bit for
    bit, on every rank of an NCCL group (one process a card)."""
    shape = CARD_MESHES[mesh]
    world = shape[0] * shape[1]
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA device(s)")
    job = {"arch": arch, "widths": CARD_WIDTHS[arch], "shape": shape, "device": "cuda", "batch": 4, "prompt": 16,
           "gen": GEN, "max_seq": 32, "port": free_port(), "out": str(tmp_path / "result.json"),
           "hang_s": GPU_TIMEOUT_S - 30}
    env = {"PYTHONPATH": str(Path(__file__).resolve().parent.parent / "src"), "WORLD_SIZE": str(world)}
    procs = [subprocess.Popen([sys.executable, "-c", GPU_WORKER, json.dumps(job)],
                              env={**os.environ, **env, "RANK": str(r)}) for r in range(world)]
    deadline = time.monotonic() + GPU_TIMEOUT_S
    try:
        codes = [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0] * world
    result = json.loads(Path(job["out"]).read_text())
    assert result["steps"] == result["replays"] == GEN
    assert result["tokens_equal"] and result["logits_equal"] == [True] * GEN
