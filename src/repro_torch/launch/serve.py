"""serve — batched generation on one card.

    python -m repro_torch.launch.serve --arch nbi-100m [--smoke] [--device cpu]
    python -m repro_torch.launch.serve --arch recurrentgemma-2b
    python -m repro_torch.launch.serve --arch rwkv6-7b

The port of ``repro.launch.serve``'s :class:`ServeEngine`, for the dense,
Griffin and RWKV-6 families: prefill a batch of prompts (on the card every
prefill attention through the flash-attention kernel, every RMSNorm through
the RMSNorm kernel, every RG-LRU scan and WKV-6 recurrence through theirs),
pad the prompt-sized cache into the fixed-capacity decode cache, then decode
one token at a time at a scalar position (greedy or temperature sampling). A
small batcher groups queued requests into engine-sized batches of one exact
prompt length, so no row ever sees padding and a request's output does not
depend on its batch-mates.

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``.
``ContinuousBatchingEngine`` comes in a later slice; the vector-``pos`` decode
it needs is in :func:`repro_torch.models.transformer.dense_decode_step`.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.common import resolve_device
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
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.long, device=self.device)
        logits, cache = self.model.prefill_fn(self.params, {"tokens": tokens})
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
