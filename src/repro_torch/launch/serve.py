"""serve — batched generation on one card.

    python -m repro_torch.launch.serve --arch nbi-100m [--smoke] [--device cpu]
    python -m repro_torch.launch.serve --arch recurrentgemma-2b
    python -m repro_torch.launch.serve --arch rwkv6-7b
    python -m repro_torch.launch.serve --arch whisper-small

The port of ``repro.launch.serve``'s :class:`ServeEngine`, for every family
(dense with GQA and MLA, MoE, Griffin, RWKV-6, and Whisper's encoder-decoder,
fed zero audio frames as the reference's engine feeds them): prefill a batch
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
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.common import resolve_device, torch_dtype
from repro_torch.models.registry import build_model


def pad_cache_to(cache, cache_defs):
    """Zero-pad a prompt-sized prefill cache into the fixed decode layout.

    Maps over nested dicts, as the reference's ``tree_map``. Leaves match
    rank; any axis where the prefill extent is smaller (the kv-seq axis) is
    right-padded. Leaves whose shape already matches (recurrent states, ring
    buffers) are only cast to the layout's dtype. Zero padding is safe:
    decode masks by position.
    """
    if isinstance(cache, dict):
        if set(cache) != set(cache_defs):
            raise ValueError(f"cache keys {sorted(cache)} differ from the layout's {sorted(cache_defs)}")
        return {name: pad_cache_to(leaf, cache_defs[name]) for name, leaf in cache.items()}
    target = tuple(cache_defs.shape)
    if tuple(cache.shape) == target:
        return cache.to(cache_defs.dtype)
    if cache.dim() != len(target) or any(h > n for h, n in zip(cache.shape, target)):
        raise ValueError(f"cache leaf {tuple(cache.shape)} exceeds {target}")
    out = torch.zeros(target, dtype=cache_defs.dtype, device=cache.device)
    out[tuple(slice(0, h) for h in cache.shape)] = cache
    return out


class ServeEngine:
    """Fixed-shape batched generation over one model, on one device."""

    def __init__(self, cfg, *, batch: int, max_seq: int, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch = batch
        self.max_seq = max_seq
        self.model = build_model(cfg)
        # Seeded weights are drawn on the engine's device: one seed gives one
        # model per device type (the card's generator differs from the CPU's).
        self.params = self.model.init(torch.Generator(device=self.device).manual_seed(seed), self.device)
        self.stats = {"requests": 0, "prefill_tokens": 0, "decode_tokens": 0,
                      "prefill_s": 0.0, "decode_s": 0.0}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- one fixed-shape batch ------------------------------------------------

    @torch.inference_mode()
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
        batch_in = {"tokens": torch.as_tensor(np.asarray(prompts), dtype=torch.long, device=self.device)}
        if self.cfg.family == "encdec":  # the stub audio front end: zero frames, as the reference's engine
            batch_in["frames"] = torch.zeros((B, self.cfg.enc_len, self.cfg.d_model),
                                             dtype=torch_dtype(self.cfg.dtype), device=self.device)
        logits, cache = self.model.prefill_fn(self.params, batch_in)
        cache = pad_cache_to(cache, self.model.cache_defs_fn(B, self.max_seq))
        self._sync()
        t1 = time.perf_counter()

        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        out = np.zeros((B, gen_len), np.int32)
        finished = np.zeros((B,), bool)
        tok = self._sample(logits[:, -1], temperature, generator)
        for i in range(gen_len):
            out[:, i] = np.where(finished, eos_id or 0, tok.cpu().numpy())
            if eos_id is not None:
                finished |= out[:, i] == eos_id
                if finished.all():
                    out = out[:, : i + 1]
                    break
            step = torch.as_tensor(out[:, i : i + 1], dtype=torch.long, device=self.device)
            logits, cache = self.model.decode_fn(self.params, cache, step, P + i)
            tok = self._sample(logits[:, -1], temperature, generator)
        self._sync()
        t2 = time.perf_counter()
        self.stats["requests"] += B
        self.stats["prefill_tokens"] += B * P
        self.stats["decode_tokens"] += B * out.shape[1]
        self.stats["prefill_s"] += t1 - t0
        self.stats["decode_s"] += t2 - t1
        return out

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
    row-independent, while MoE routing couples rows through capacity.
    """

    def __init__(self, cfg, *, batch: int, max_seq: int, seed: int = 0, device="cuda"):
        if cfg.family != "dense":
            raise ValueError(f"continuous batching takes the dense families, not {cfg.family!r} "
                             "(its decode rows must be independent)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch = batch
        self.max_seq = max_seq
        self.model = build_model(cfg)
        self.params = self.model.init(torch.Generator(device=self.device).manual_seed(seed), self.device)
        self.stats = {"requests": 0, "decode_steps": 0, "slot_tokens": 0, "occupancy_sum": 0.0}

    def _insert(self, cache: dict, slot: int, prompt: np.ndarray) -> int:
        """Prefill one request and write its rows into ``slot`` of ``cache``
        (in place); returns its first generated token."""
        toks = torch.as_tensor(np.asarray(prompt)[None, :], dtype=torch.long, device=self.device)
        logits, row_cache = self.model.prefill_fn(self.params, {"tokens": toks})
        row_cache = pad_cache_to(row_cache, self.model.cache_defs_fn(1, self.max_seq))
        for name, full in cache.items():
            full[:, slot] = row_cache[name][:, 0]
        return int(logits[0, -1].argmax())

    @torch.inference_mode()
    def serve(self, requests: list, gen_len: int) -> list:
        """Greedy-decode every request; returns (gen_len,) int32 outputs in input order."""
        B = self.batch
        for r in requests:
            if len(r) + gen_len > self.max_seq:
                raise ValueError(f"prompt {len(r)} + gen {gen_len} exceeds engine capacity {self.max_seq}")
        cache = {name: torch.zeros(d.shape, dtype=d.dtype, device=self.device)
                 for name, d in self.model.cache_defs_fn(B, self.max_seq).items()}
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
            self.stats["decode_steps"] += 1
            logits, _ = self.model.decode_fn(
                self.params, cache, torch.as_tensor(cur_tok[:, None], device=self.device),
                torch.as_tensor(pos, device=self.device))
            nxt = logits[:, -1].argmax(-1).cpu().numpy()
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
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    engine = ServeEngine(
        cfg, batch=args.batch, max_seq=args.prompt_len + args.gen_len,
        seed=args.seed, device=args.device,
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
    print(
        f"[serve] {len(requests)} requests in {dt:.2f}s on {device_name(engine.device)} | "
        f"prefill {s['prefill_tokens'] / max(s['prefill_s'], 1e-9):.0f} tok/s | "
        f"decode {s['decode_tokens'] / max(s['decode_s'], 1e-9):.0f} tok/s"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
