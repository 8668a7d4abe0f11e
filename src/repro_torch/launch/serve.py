"""serve — batched generation on one card or on a device mesh of GPUs.

    python -m repro_torch.launch.serve --arch nbi-100m [--smoke] [--device cpu]
    python -m repro_torch.launch.serve --arch recurrentgemma-2b
    python -m repro_torch.launch.serve --arch rwkv6-7b
    python -m repro_torch.launch.serve --arch whisper-small
    srun python -m repro_torch.launch.serve --arch mistral-large-123b --mesh data=1,model=4

The port of ``repro.launch.serve``'s :class:`ServeEngine`, for every family
(dense with GQA and MLA, MoE with GQA, Griffin, RWKV-6, and Whisper's
encoder-decoder, fed zero audio frames as the reference's engine feeds them;
an MoE model with MLA trains but is refused here, as the reference's prefill
fails on it): prefill a batch
of prompts (on the card every prefill attention through the flash-attention
kernel, every RMSNorm through the RMSNorm kernel, every RG-LRU scan and WKV-6
recurrence through theirs),
pad the prompt-sized cache into the fixed-capacity decode cache, then decode
one token at a time at a scalar position (greedy or temperature sampling). A
small batcher groups queued requests into engine-sized batches of one exact
prompt length, so no row ever sees padding and a request's output does not
depend on its batch-mates.

:class:`ContinuousBatchingEngine` is the port of the reference's slot-based
engine for the dense families: a fixed pool of decode slots advances every
step at per-slot positions (the vector-``pos`` path of
:func:`repro_torch.models.transformer.dense_decode_step`), and a finished
request's slot is refilled by a single-row, exact-length prefill.

Both engines run on ``cuda`` unless the caller passes ``device="cpu"``.

Both engines decode through a CUDA graph, with and without a mesh, the
counterpart of the reference's ``jax.jit`` over its decode step
(:class:`_DecodeGraph`): the engine owns a static cache, allocated once, and
static token, position and logit buffers. Each batch's (or each insert's)
prefill is written into the static cache, every element of every leaf
(:func:`fill_cache`); each step copies its tokens and positions in on the
device and replays the graph. The first step runs eagerly and the graph is
captured after it; on the card every later step replays it, with no switch
and no fallback (a failed capture raises). On the CPU the same buffers are
stepped eagerly. ``stats["decode_replays"]`` counts the replays. Prefill
stays eager (its length varies per bucket; the reference retraces per
length). Sampling stays outside the graph; the host reads each step's
token, as the reference's engine does.

On a device mesh (``mesh=``, the reference's signature; ``--mesh
data=D,model=M`` over a job's D·M tasks, as ``launch/train.py`` takes it) the
rules are the reference's engines' (``sharding.serve_rules``): the weights
are DTensors drawn straight into their placements
(``init_sharded_params``: no rank holds the whole model, and they differ
from the one-device engine's for one seed), the prompts are split over the
data axes, and prefill and decode run under the rules
(``make_prefill_step`` / ``make_serve_step``). The static cache is made of
DTensors in local shapes, its ``kv_seq`` dim split over ``model``
(flash-decoding's split-KV:
:func:`repro_torch.models.common.attention_single_shot`), so no rank ever
holds the whole cache; the static tokens are a DTensor split over the data
axes, of which each rank writes its own rows. The graph records the step
under the rules, its collectives and the gather of the whole last logits
included, so a replay runs none of DTensor's host dispatch; every rank
samples from the whole logits, so every rank feeds the same token. Every
family runs on a mesh: MLA's latent cache is split over ``kv_seq`` like a
K/V cache (its absorbed decode split-KV,
:func:`repro_torch.models.transformer.absorbed_attention`), and Whisper's
cross cache over ``heads``. The engines feed no patches, as the
reference's: a visual-prefix model's text is served here, its prefix
through ``make_prefill_step`` with ``batch["patches"]`` and then
``make_serve_step``, which steps eagerly (no engine, no graph).
``mesh=None`` is the one-device engine.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.ops import is_dtensor
from repro_torch.models.common import map_defs, resolve_device, torch_dtype, tree_leaves
from repro_torch.models.registry import build_model
from repro_torch.training import init_sharded_params, make_prefill_step, make_serve_step
from repro_torch.training.graph import Captured, warm_up


def pad_cache_to(cache, cache_defs, placements=None):
    """Zero-pad a prompt-sized prefill cache into the fixed decode layout.

    Maps over nested dicts, as the reference's ``tree_map``. Leaves match
    rank; any axis where the prefill extent is smaller (the kv-seq axis) is
    right-padded. Leaves whose shape already matches (recurrent states, ring
    buffers) are only cast to the layout's dtype. Zero padding is safe:
    decode masks by position. A DTensor leaf is laid out by ``placements``
    (a tree of them; the leaf's own where not given) in local shapes
    (:func:`_pad_shards`).
    """
    if isinstance(cache, dict):
        if set(cache) != set(cache_defs):
            raise ValueError(f"cache keys {sorted(cache)} differ from the layout's {sorted(cache_defs)}")
        return {name: pad_cache_to(leaf, cache_defs[name], None if placements is None else placements[name])
                for name, leaf in cache.items()}
    if is_dtensor(cache):
        return _pad_shards(cache, cache_defs, tuple(placements or cache.placements))
    target = tuple(cache_defs.shape)
    if tuple(cache.shape) == target:
        return cache.to(cache_defs.dtype)
    if cache.dim() != len(target) or any(h > n for h, n in zip(cache.shape, target)):
        raise ValueError(f"cache leaf {tuple(cache.shape)} exceeds {target}")
    out = torch.zeros(target, dtype=cache_defs.dtype, device=cache.device)
    out[tuple(slice(0, h) for h in cache.shape)] = cache
    return out


def fill_cache(static, cache) -> None:
    """Write a prompt-sized prefill cache into ``static``, a cache in the
    fixed decode layout (:func:`pad_cache_to`'s), in place. Every element of
    every leaf is rewritten: a leaf that grows is zeroed past the prompt, and
    a leaf already of the layout's shape (recurrent states, Griffin's ring
    buffers with the -1 positions of their empty slots, Whisper's cross K/V)
    is copied whole, so that no batch sees the state of the batch before. A
    DTensor leaf is rewritten on each rank's local shard: the prefill's leaf
    laid out as ``static`` (:func:`_pad_shards`), then copied in."""
    if isinstance(static, dict):
        if set(cache) != set(static):
            raise ValueError(f"cache keys {sorted(cache)} differ from the layout's {sorted(static)}")
        for name, leaf in static.items():
            fill_cache(leaf, cache[name])
        return
    if cache.dim() != static.dim() or any(h > n for h, n in zip(cache.shape, static.shape)):
        raise ValueError(f"cache leaf {tuple(cache.shape)} exceeds {tuple(static.shape)}")
    if is_dtensor(static):
        static.to_local().copy_(_pad_shards(cache, static, tuple(static.placements)).to_local())
        return
    if cache.shape != static.shape:
        static.zero_()
        static = static[tuple(slice(0, h) for h in cache.shape)]
    static.copy_(cache)


def _local(t):
    """This rank's shard of a DTensor (the same storage), else ``t``."""
    return t.to_local() if is_dtensor(t) else t


class _DecodeGraph:
    """The decode step over static buffers, the counterpart of the
    reference's ``jax.jit`` over its decode step: the cache of ``batch`` rows
    and ``max_seq`` positions (allocated once), the tokens (B, 1), the
    position (0-dim, or (B,) with ``per_row_pos``) and, on the card, the
    logits. Without a mesh the step is ``model.decode_fn``; on a mesh (``on``,
    an :class:`_OnMesh`) it is ``make_serve_step`` under the rules followed
    by the gather of the whole logits (:meth:`_OnMesh.step`), the cache is
    made of DTensors in local shapes and the tokens are a DTensor split over
    the data axes; the position is a plain tensor, which every rank holds
    alike.

    On ``cuda`` the first step runs eagerly on a side stream (the warm-up;
    its logits are that step's: on a mesh it also makes the communicators
    and fills DTensor's sharding caches on every rank), then the step over
    the static buffers is captured with ``torch.cuda.graph`` in a memory pool
    of its own, and every later step replays it: on a mesh the replay runs
    none of DTensor's dispatch and enters no rules. A failed capture raises;
    new weights (another ``params`` object) are captured anew. On the CPU
    every step runs eagerly over the same buffers. No ``torch.compile``: the
    captured kernels are the eager step's, so a replay gives the eager
    step's bits.

    The kernel wrappers' launch counts count what runs on the device: the
    warm-up's launches, nothing at the capture, and at each replay the
    launches the capture recorded (:class:`repro_torch.training.graph.
    Captured`, which the train step's graph shares). A replay overwrites
    the static logits: a caller that keeps a step's logits past the next
    step clones them."""

    def __init__(self, model, batch: int, max_seq: int, device, per_row_pos: bool = False, on=None):
        from repro_torch.parallel.sharding import local_slices

        self.model, self.device = model, device
        defs = model.cache_defs_fn(batch, max_seq)
        if on is None:
            self.cache = map_defs(lambda d: torch.zeros(d.shape, dtype=d.dtype, device=device), defs)
            self.tokens = torch.zeros((batch, 1), dtype=torch.long, device=device)
            self._step = model.decode_fn
        else:
            self.cache = on.empty_cache(defs)
            self.tokens = on.zeros((batch, 1), torch.long, on.tokens)
            self._step = on.step
        self.pos = torch.zeros((batch,) if per_row_pos else (), dtype=torch.long, device=device)
        # where :meth:`feed` writes the tokens: this rank's rows of the static tokens
        self._rows = None if on is None else local_slices(self.tokens.shape, self.tokens.placements, on.mesh)[0]
        self._tokens_here = _local(self.tokens)
        self.replays = 0
        self._graph = self._params = None

    def zero(self) -> dict:
        """The static cache, zeroed in place."""
        for _, leaf in tree_leaves(self.cache):
            _local(leaf).zero_()
        return self.cache

    def feed(self, tokens, pos) -> None:
        """Write a step's whole tokens (B, 1) (a tensor on the host or the
        device) and its position (an int, or B of them) into the static
        buffers: on a mesh this rank's rows of the tokens only."""
        self._tokens_here.copy_(tokens if self._rows is None else tokens[self._rows])
        if self.pos.dim():
            self.pos.copy_(torch.as_tensor(pos))
        else:
            self.pos.fill_(pos)

    def __call__(self, params, cache, tokens, pos):
        """``model.decode_fn``'s call, over the static buffers only: the
        caller writes the step's tokens and positions in (:meth:`feed`) and
        passes ``self.cache``, ``self.tokens`` and ``self.pos``. Returns
        (logits, cache), the logits whole on every rank of a mesh."""
        if cache is not self.cache or tokens is not self.tokens or pos is not self.pos:
            raise ValueError("a decode graph steps its own static cache, tokens and position")
        if self.device.type != "cuda":
            return self._step(params, self.cache, self.tokens, self.pos)
        if self._graph is None or params is not self._params:
            return self._capture(params), self.cache
        self._graph.replay()
        self.replays += 1
        return self._graph.out, self.cache

    def _capture(self, params):
        """The warm-up step, then the capture; returns the warm-up's logits."""
        self._graph = self._params = None  # the old graph's pool goes first
        logits, _ = warm_up(lambda: self._step(params, self.cache, self.tokens, self.pos), self.device)
        logits.record_stream(torch.cuda.current_stream(self.device))
        self._graph = Captured(lambda: self._step(params, self.cache, self.tokens, self.pos)[0])
        self._params = params
        return logits


def _pad_shards(leaf, want, placements: tuple):
    """A DTensor cache leaf padded to ``want``'s shape and dtype, laid out by
    ``placements``. A dim that grows is first gathered over the mesh dims
    that will split it (the prompt's positions of this rank's rows), then
    each rank copies its own slice into a zeroed buffer of its local shape."""
    from torch.distributed.tensor import Replicate

    from repro_torch.parallel.sharding import from_local, local_shape, local_slices, redistribute

    mesh, target = leaf.device_mesh, tuple(want.shape)
    if leaf.dim() != len(target) or any(h > n for h, n in zip(leaf.shape, target)):
        raise ValueError(f"cache leaf {tuple(leaf.shape)} exceeds {target}")
    grown = {d for d, (h, n) in enumerate(zip(leaf.shape, target)) if h < n}
    if not grown:
        return redistribute(leaf, mesh, placements).to(want.dtype)
    src = redistribute(leaf, mesh, tuple(Replicate() if p.is_shard() and p.dim in grown else p
                                         for p in placements)).to_local()
    out = torch.zeros(local_shape(target, placements, mesh), dtype=want.dtype, device=src.device)
    into, take = [], []
    for d, part in enumerate(local_slices(target, placements, mesh)):
        if d in grown:
            n = max(0, min(part.stop, leaf.shape[d]) - part.start)
            into.append(slice(0, n))
            take.append(slice(part.start, part.start + n))
        else:
            into.append(slice(None))
            take.append(slice(None))
    out[tuple(into)] = src[tuple(take)]
    return from_local(out, mesh, placements, target)


def _without_grad(method):
    """Run an engine's method under ``torch.inference_mode`` on one device,
    and under ``torch.no_grad`` on a mesh (DTensor's views cannot be made of
    tensors from outside inference mode inside it)."""
    import functools

    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with torch.inference_mode() if self.mesh is None else torch.no_grad():
            return method(self, *args, **kwargs)

    return run


def _whole(t):
    """A DTensor gathered whole onto every rank (the sampled logits), else ``t``."""
    return t.full_tensor() if is_dtensor(t) else t


class _OnMesh:
    """An engine's layout on its mesh for ``batch`` rows: the rules
    (``sharding.serve_rules``), the prefill and decode steps under them, and
    the placements of the weights, the prompts, the decode tokens and the
    cache."""

    def __init__(self, model, mesh, batch: int, max_seq: int, device):
        from repro_torch.parallel.sharding import placements_for, resolve_tree, serve_rules

        self.mesh, self.device = mesh, device
        self.rules = serve_rules(model, mesh, batch, max_seq)
        self.prefill = make_prefill_step(model, self.rules, mesh)
        self.decode = make_serve_step(model, self.rules, mesh)
        self.weights = resolve_tree(mesh, model.param_logical(), self.rules)
        self.inputs = resolve_tree(mesh, model.prefill_input_logical(), self.rules)
        self.tokens = placements_for(("batch", None), self.rules, mesh)
        self.cache = resolve_tree(mesh, model.cache_logical_fn(), self.rules)

    def place(self, tree: dict, placements) -> dict:
        """Tensors every rank holds alike, as DTensors of ``placements``."""
        from repro_torch.parallel.sharding import distribute_tree

        return distribute_tree(tree, self.mesh, placements)

    def zeros(self, shape, dtype, placements):
        """A zeroed DTensor of global ``shape``, made in its local shape."""
        from repro_torch.parallel.sharding import from_local, local_shape

        return from_local(torch.zeros(local_shape(shape, placements, self.mesh), dtype=dtype, device=self.device),
                          self.mesh, placements, shape)

    def empty_cache(self, cache_defs) -> dict:
        """A zeroed cache in local shapes."""
        return map_defs(lambda d, pl: self.zeros(d.shape, d.dtype, pl), cache_defs, self.cache)

    def step(self, params, cache, tokens, pos):
        """The decode step under the rules, its last logits gathered whole
        onto every rank: (logits, cache)."""
        logits, cache = self.decode(params, cache, tokens, pos)
        return _whole(logits), cache


class ServeEngine:
    """Fixed-shape batched generation over one model, on one device or on a
    device mesh (``mesh``: a ``DeviceMesh`` with ``data`` and ``model`` axes;
    module docstring). Either way each batch is prefilled into one static
    cache and decoded by replaying a CUDA graph on the card
    (:class:`_DecodeGraph`)."""

    def __init__(self, cfg, *, batch: int, max_seq: int, mesh=None, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch = batch
        self.max_seq = max_seq
        self.mesh = mesh
        self.model = build_model(cfg)
        self.model.cache_defs_fn(batch, max_seq)  # refuses a model the port trains but does not serve
        if mesh is None:
            # Seeded weights are drawn on the engine's device: one seed gives one
            # model per device type (the card's generator differs from the CPU's).
            self.params = self.model.init(torch.Generator(device=self.device).manual_seed(seed), self.device)
            self._on = None
            self._prefill = self.model.prefill_fn
        else:
            self._on = _OnMesh(self.model, mesh, batch, max_seq, self.device)
            self.params = init_sharded_params(self.model, seed, mesh, self._on.weights, self.device)
            self._prefill = self._on.prefill
        self._graph = self._decode = _DecodeGraph(self.model, batch, max_seq, self.device, on=self._on)
        self.rules = None if mesh is None else self._on.rules
        self.stats = {"requests": 0, "prefill_tokens": 0, "decode_tokens": 0, "decode_steps": 0,
                      "decode_replays": 0, "prefill_s": 0.0, "decode_s": 0.0}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- one fixed-shape batch ------------------------------------------------

    @_without_grad
    def generate_batch(
        self, prompts: np.ndarray, gen_len: int, *,
        temperature: float = 0.0, eos_id: int | None = None,
        generator: torch.Generator | None = None,
    ) -> np.ndarray:
        """prompts: (batch, prompt_len) int → (batch, gen_len) int32.

        Temperature sampling draws from ``generator`` (on the engine's
        device; a fresh one seeded 0 when not given)."""
        B, P = prompts.shape
        if B != self.batch:
            raise ValueError(f"batch of {B} prompts, engine batch is {self.batch}")
        if P + gen_len > self.max_seq:
            raise ValueError(f"prompt {P} + gen {gen_len} exceeds engine capacity {self.max_seq}")
        t0 = time.perf_counter()
        logits, cache = self._prefill_batch(prompts)
        graph = self._graph
        self._sync()
        t1 = time.perf_counter()

        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        out = np.zeros((B, gen_len), np.int32)
        finished = np.zeros((B,), bool)
        steps, replays = 0, graph.replays
        tok = self._sample(_whole(logits)[:, -1], temperature, generator)
        for i in range(gen_len):
            rewrite = finished.any()  # rows finished at an earlier step feed eos_id
            out[:, i] = np.where(finished, eos_id or 0, tok.cpu().numpy())
            if eos_id is not None:
                finished |= out[:, i] == eos_id
                if finished.all():
                    out = out[:, : i + 1]
                    break
            # the step's inputs into the static buffers, on the device
            graph.feed(torch.as_tensor(out[:, i : i + 1]) if rewrite else tok[:, None], P + i)
            logits, cache = self._decode(self.params, cache, graph.tokens, graph.pos)
            tok = self._sample(logits[:, -1], temperature, generator)
            steps += 1
        self._sync()
        t2 = time.perf_counter()
        self.stats["requests"] += B
        self.stats["prefill_tokens"] += B * P
        self.stats["decode_tokens"] += B * out.shape[1]
        self.stats["decode_steps"] += steps
        self.stats["decode_replays"] += graph.replays - replays
        self.stats["prefill_s"] += t1 - t0
        self.stats["decode_s"] += t2 - t1
        return out

    def _prefill_batch(self, prompts: np.ndarray):
        """Prefill a batch of prompts (B, P) into the static decode cache
        (:func:`fill_cache`). Returns (the prefill's logits, the cache)."""
        B = prompts.shape[0]
        batch_in = {"tokens": torch.as_tensor(np.asarray(prompts), dtype=torch.long, device=self.device)}
        if self.cfg.family == "encdec":  # the stub audio front end: zero frames, as the reference's engine
            batch_in["frames"] = torch.zeros((B, self.cfg.enc_len, self.cfg.d_model),
                                             dtype=torch_dtype(self.cfg.dtype), device=self.device)
        on = self._on
        if on is not None:
            batch_in = on.place(batch_in, on.inputs)
        logits, cache = self._prefill(self.params, batch_in)
        fill_cache(self._graph.cache, cache)
        return logits, self._graph.cache

    @staticmethod
    def _sample(logits, temperature: float, generator: torch.Generator):
        if temperature <= 0:
            return logits.argmax(dim=-1)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    # -- dynamic batcher ----------------------------------------------------------

    def serve_requests(
        self, requests: list[np.ndarray], gen_len: int, *, temperature: float = 0.0,
    ) -> list[np.ndarray]:
        """Group variable-length requests into fixed engine batches.

        Requests are bucketed by *exact prompt length* (rows in one batch
        never see padding tokens, so a request's output is independent of
        its batch-mates). Short buckets are filled up to the engine batch by
        repeating the first row; filler rows are discarded. Responses return
        in input order.
        """
        results: list = [None] * len(requests)
        buckets: dict[int, list[int]] = {}
        for i, r in enumerate(requests):
            buckets.setdefault(len(r), []).append(i)
        for length, idxs in sorted(buckets.items()):
            for g in range(0, len(idxs), self.batch):
                group = idxs[g : g + self.batch]
                block = np.empty((self.batch, length), np.int32)
                for row in range(self.batch):
                    src = group[row] if row < len(group) else group[0]  # filler
                    block[row] = requests[src]
                out = self.generate_batch(block, gen_len, temperature=temperature)
                for row, i in enumerate(group):
                    results[i] = out[row]
        return results


class ContinuousBatchingEngine:
    """Slot-based continuous batching (the vLLM idiom, shapes held fixed).

    A fixed pool of ``batch`` decode slots advances every step with per-slot
    positions; when a request finishes, the next queued request is prefilled
    (one row, exact length) and written into the free slot's cache rows while
    the other slots keep decoding, so no generation waits on its batch-mates.

    Dense families only (GQA and MLA), as in the reference: their decode is
    row-independent, while MoE routing couples rows through capacity. On a
    mesh (GQA and MLA; module docstring) the slots are split over the data
    axes and each insert's one-row prefill runs under rules of a batch of
    one (its row whole on every rank); the rank that holds the slot copies
    the row's slice of the sequence into its cache. With or without a mesh
    the slots live in one static cache, and every decode step after the
    first replays a CUDA graph on the card (:class:`_DecodeGraph`).
    """

    def __init__(self, cfg, *, batch: int, max_seq: int, mesh=None, seed: int = 0, device="cuda"):
        if cfg.family != "dense":
            raise ValueError(f"continuous batching takes the dense families, not {cfg.family!r} "
                             "(its decode rows must be independent)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch = batch
        self.max_seq = max_seq
        self.mesh = mesh
        self.model = build_model(cfg)
        if mesh is None:
            self.params = self.model.init(torch.Generator(device=self.device).manual_seed(seed), self.device)
            self._on = self._row = None
            self._prefill = self.model.prefill_fn
        else:
            self._on = _OnMesh(self.model, mesh, batch, max_seq, self.device)
            # the insert's prefill: a batch of one, its row whole on every rank
            self._row = _OnMesh(self.model, mesh, 1, max_seq, self.device)
            self.params = init_sharded_params(self.model, seed, mesh, self._on.weights, self.device)
            self._prefill = self._row.prefill
        self._graph = self._decode = _DecodeGraph(self.model, batch, max_seq, self.device, per_row_pos=True,
                                                  on=self._on)
        self.rules = None if mesh is None else self._on.rules
        self.stats = {"requests": 0, "decode_steps": 0, "decode_replays": 0, "slot_tokens": 0,
                      "occupancy_sum": 0.0}

    def _insert(self, cache: dict, slot: int, prompt: np.ndarray) -> int:
        """Prefill one request and write its rows into ``slot`` of ``cache``
        (the static cache, in place; on a mesh into the local shard of the
        rank that holds the slot); returns its first generated token."""
        from repro_torch.parallel.sharding import local_slices

        row = self._row
        toks = {"tokens": torch.as_tensor(np.asarray(prompt)[None, :], dtype=torch.long, device=self.device)}
        if row is not None:
            toks = row.place(toks, row.inputs)
        logits, row_cache = self._prefill(self.params, toks)
        row_cache = pad_cache_to(row_cache, self.model.cache_defs_fn(1, self.max_seq), None if row is None else row.cache)
        for name, full in cache.items():
            if row is None:
                full[:, slot] = row_cache[name][:, 0]
                continue
            rows = local_slices(full.shape, full.placements, self.mesh)[1]
            if rows.start <= slot < rows.stop:  # this rank holds the slot
                full.to_local()[:, slot - rows.start] = row_cache[name].to_local()[:, 0]
        return int(_whole(logits)[0, -1].argmax())

    def _empty_cache(self) -> dict:
        """A zeroed cache for the slots: the decode graph's static cache,
        zeroed in place."""
        return self._graph.zero()

    def _step(self, cache: dict, cur_tok: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """One decode step of every slot at its token and position (host
        arrays of B), writing into ``cache`` in place; returns each slot's
        greedy next token."""
        graph = self._graph
        replays = graph.replays
        graph.feed(torch.from_numpy(cur_tok[:, None]), pos)  # the slots' tokens and positions
        logits, _ = self._decode(self.params, cache, graph.tokens, graph.pos)
        self.stats["decode_steps"] += 1
        self.stats["decode_replays"] += graph.replays - replays
        return logits[:, -1].argmax(-1).cpu().numpy()

    @_without_grad
    def serve(self, requests: list, gen_len: int) -> list:
        """Greedy-decode every request; returns (gen_len,) int32 outputs in input order."""
        B = self.batch
        for r in requests:
            if len(r) + gen_len > self.max_seq:
                raise ValueError(f"prompt {len(r)} + gen {gen_len} exceeds engine capacity {self.max_seq}")
        cache = self._empty_cache()
        queue = list(range(len(requests)))
        outputs: list = [[] for _ in requests]
        slot_req = [-1] * B  # which request occupies each slot
        pos = np.zeros(B, np.int64)  # next write position per slot
        cur_tok = np.zeros(B, np.int64)

        def fill_free_slots():
            for b in range(B):
                if slot_req[b] == -1 and queue:
                    i = queue.pop(0)
                    tok = self._insert(cache, b, requests[i])
                    slot_req[b] = i
                    pos[b] = len(requests[i])
                    cur_tok[b] = tok
                    outputs[i].append(tok)
                    self.stats["requests"] += 1

        fill_free_slots()
        while any(s != -1 for s in slot_req):
            self.stats["occupancy_sum"] += float(np.mean([s != -1 for s in slot_req]))
            nxt = self._step(cache, cur_tok, pos)
            for b in range(B):
                if slot_req[b] == -1:
                    continue
                i = slot_req[b]
                self.stats["slot_tokens"] += 1
                if len(outputs[i]) < gen_len:
                    outputs[i].append(int(nxt[b]))
                    cur_tok[b] = nxt[b]
                    pos[b] += 1
                if len(outputs[i]) >= gen_len:
                    slot_req[b] = -1  # request done: the slot is free
                    pos[b] = 0
                    cur_tok[b] = 0
            fill_free_slots()
        return [np.asarray(o, np.int32) for o in outputs]


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default="", help="data=D,model=M[,pod=P]: serve on a device mesh of the job's tasks")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh = None
    if args.mesh:  # every task of the job joins the group and serves the same requests
        from .distributed import maybe_initialize
        from .mesh import make_job_mesh

        maybe_initialize(resolve_device(args.device))
        mesh = make_job_mesh(args.mesh, args.device)
    engine = ServeEngine(
        cfg, batch=args.batch, max_seq=args.prompt_len + args.gen_len,
        mesh=mesh, seed=args.seed, device=args.device,
    )
    rng = np.random.default_rng(args.seed)
    requests = [
        rng.integers(0, cfg.vocab_size, size=rng.integers(4, args.prompt_len + 1)).astype(np.int32)
        for _ in range(args.requests)
    ]
    t0 = time.perf_counter()
    outs = engine.serve_requests(requests, args.gen_len, temperature=args.temperature)
    dt = time.perf_counter() - t0
    for i, o in enumerate(outs[:4]):
        print(f"[serve] req{i}: prompt_len={len(requests[i])} -> {o[:8].tolist()}...")
    s = engine.stats
    where = device_name(engine.device) + (f" over mesh {args.mesh}" if mesh is not None else "")
    print(
        f"[serve] {len(requests)} requests in {dt:.2f}s on {where} | "
        f"prefill {s['prefill_tokens'] / max(s['prefill_s'], 1e-9):.0f} tok/s | "
        f"decode {s['decode_tokens'] / max(s['decode_s'], 1e-9):.0f} tok/s"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
