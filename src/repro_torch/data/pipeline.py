"""Deterministic synthetic data pipeline with straggler mitigation: the
port's own copy of ``repro.data.pipeline`` (numpy and threads only; the port
imports nothing of ``repro``). The same seed, index, rows and sequence give
the reference's batches to the bit, so the two packages train on one stream.

Layers (bottom-up):

* :class:`SyntheticLMDataset` — a *stateless, indexable* token source:
  ``batch(index, size, seq)`` is a pure function of ``(seed, index)``
  (Zipf-1.2 marginal, a Markov "phrase" structure, per-index generators), so
  resume-from-checkpoint is "set the cursor".
* :func:`host_shard_for` — per-host batch sharding: host ``h`` of ``H`` owns
  rows ``[h·B/H, (h+1)·B/H)`` of every global batch (``row_offset``).
* :class:`DataLoader` — background prefetch threads with backup fetch of a
  late batch; batches come out in index order. Its whole iteration state is
  one integer (``cursor``, in ``state_dict()``), saved in checkpoints.

Batches are numpy arrays; the train loop moves them to its device.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np


# ---------------------------------------------------------------------------
# Stateless synthetic dataset
# ---------------------------------------------------------------------------


class SyntheticLMDataset:
    """Deterministic LM token stream: ``batch(i)`` is pure in ``(seed, i)``.

    Tokens follow a Zipf-like marginal over the vocabulary with a short
    Markov "phrase" structure, so losses fall smoothly during the e2e
    example run instead of flat-lining at ``log(V)`` (uniform tokens are
    unlearnable). Labels are next-token shifted with the final position
    masked (-100).
    """

    def __init__(self, vocab_size: int, *, seed: int = 0, zipf_a: float = 1.2):
        if vocab_size < 4:
            raise ValueError("vocab too small")
        self.vocab_size = int(vocab_size)
        self.seed = int(seed)
        # Zipf-ish unnormalised weights over the vocab (deterministic).
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        w = 1.0 / ranks**zipf_a
        self._cdf = np.cumsum(w / w.sum())

    def _rng(self, index: int, stream: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence(
                entropy=self.seed, spawn_key=(int(index), int(stream))
            )
        )

    def tokens(self, index: int, rows: int, seq: int) -> np.ndarray:
        """(rows, seq+1) int32 tokens for global batch ``index``.

        Each random field draws from its own child stream, so generating
        the first ``rows`` rows yields a prefix of any larger request —
        the property host sharding relies on (a shard is a row-slice of
        the global batch, bit-identical across host counts).
        """
        u = self._rng(index, 0).random((rows, seq + 1))
        toks = np.searchsorted(self._cdf, u).astype(np.int32)
        # Markov phrase structure: with p=0.5 a token repeats its
        # predecessor + 1 (mod V) — a learnable local pattern.
        rep = self._rng(index, 1).random((rows, seq + 1)) < 0.5
        for t in range(1, seq + 1):
            prev = toks[:, t - 1]
            toks[:, t] = np.where(rep[:, t], (prev + 1) % self.vocab_size, toks[:, t])
        return toks

    def batch(self, index: int, rows: int, seq: int, row_offset: int = 0) -> dict:
        """One (shard of a) global batch: {"tokens","labels"} both (rows, seq).

        ``row_offset`` selects a host's slice *of the same global batch*:
        the full (global_rows, seq+1) block is generated and sliced, so the
        union over hosts is identical to the single-host stream.
        """
        full = self.tokens(index, rows + row_offset, seq)[row_offset:]
        tokens = full[:, :-1]
        labels = full[:, 1:].copy()
        return {"tokens": tokens, "labels": labels}


# ---------------------------------------------------------------------------
# Per-host sharding
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HostShard:
    """This host's slice of every global batch."""

    host_index: int
    host_count: int
    global_batch: int

    @property
    def rows(self) -> int:
        return self.global_batch // self.host_count

    @property
    def row_offset(self) -> int:
        return self.host_index * self.rows


def host_shard_for(global_batch: int, host_index: int, host_count: int) -> HostShard:
    if global_batch % host_count:
        raise ValueError(
            f"global_batch {global_batch} not divisible by host_count {host_count}"
        )
    if not 0 <= host_index < host_count:
        raise ValueError(f"host_index {host_index} out of range 0..{host_count - 1}")
    return HostShard(host_index, host_count, global_batch)


# ---------------------------------------------------------------------------
# Prefetching loader with backup-fetch straggler mitigation
# ---------------------------------------------------------------------------


class DataLoader:
    """Background-prefetching loader over an indexable ``fetch(i)->batch``.

    * ``prefetch`` batches are produced ahead of the consumer by ``workers``
      threads (the host is busy stepping; input production overlaps).
    * If the *due* batch is not ready ``straggler_ms`` after being awaited,
      a backup fetch of the same index is dispatched to a free worker; the
      first result wins, the loser is discarded (idempotent fetches).
    * Deterministic order: batches are always yielded in index order
      regardless of completion order.

    ``fetch_hook(index, attempt)`` is a test/diagnostics injection point
    called inside the worker before fetching (used to simulate stragglers).
    """

    def __init__(
        self,
        fetch,
        *,
        start: int = 0,
        prefetch: int = 4,
        workers: int = 2,
        straggler_ms: float = 1000.0,
        fetch_hook=None,
    ):
        self._fetch = fetch
        self._cursor = int(start)  # next index to hand to the consumer
        self._next_to_submit = int(start)
        self._prefetch = max(1, int(prefetch))
        self._straggler_ms = float(straggler_ms)
        self._fetch_hook = fetch_hook
        self._results: dict[int, object] = {}
        self._inflight: dict[int, float] = {}  # index → first-submit time
        self._backup_issued: set[int] = set()
        self._lock = threading.Lock()
        self._ready = threading.Condition(self._lock)
        self._tasks: queue.Queue = queue.Queue()
        self._stop = False
        self.stats = {"fetched": 0, "backups": 0, "backup_wins": 0}
        self._threads = [
            threading.Thread(target=self._worker, daemon=True, name=f"loader-{i}")
            for i in range(max(1, int(workers)))
        ]
        for t in self._threads:
            t.start()
        self._pump()

    # -- state (checkpointable) ---------------------------------------------

    def state_dict(self) -> dict:
        with self._lock:
            return {"cursor": self._cursor}

    def load_state_dict(self, state: dict) -> None:
        with self._lock:
            self._cursor = int(state["cursor"])
            self._next_to_submit = self._cursor
            self._results.clear()
            self._inflight.clear()
            self._backup_issued.clear()
        self._pump()

    # -- iteration -------------------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self):
        idx = self._cursor
        deadline = time.monotonic() + self._straggler_ms / 1e3
        with self._ready:
            while idx not in self._results:
                remaining = deadline - time.monotonic()
                if remaining <= 0 and idx not in self._backup_issued:
                    # the due batch is late → backup fetch (straggler path)
                    self._backup_issued.add(idx)
                    self.stats["backups"] += 1
                    self._tasks.put((idx, 1))
                    deadline = float("inf")
                self._ready.wait(timeout=max(0.01, min(remaining, 0.1)) if remaining > 0 else 0.05)
            batch = self._results.pop(idx)
            self._cursor = idx + 1
        self._pump()
        return batch

    def close(self) -> None:
        self._stop = True
        for _ in self._threads:
            self._tasks.put(None)
        for t in self._threads:
            t.join(timeout=2)

    # -- internals ----------------------------------------------------------------

    def _pump(self) -> None:
        """Keep ``prefetch`` indices in flight."""
        with self._lock:
            while self._next_to_submit < self._cursor + self._prefetch:
                idx = self._next_to_submit
                self._next_to_submit += 1
                if idx in self._results or idx in self._inflight:
                    continue
                self._inflight[idx] = time.monotonic()
                self._tasks.put((idx, 0))

    def _worker(self) -> None:
        while not self._stop:
            task = self._tasks.get()
            if task is None:
                return
            idx, attempt = task
            with self._lock:
                if idx in self._results or idx < self._cursor:
                    continue  # already produced / consumed (losing backup)
            if self._fetch_hook is not None:
                self._fetch_hook(idx, attempt)
            try:
                batch = self._fetch(idx)
            except Exception as e:  # surface in the consumer thread
                batch = _FetchError(e)
            with self._ready:
                if idx not in self._results and idx >= self._cursor:
                    self._results[idx] = batch
                    self.stats["fetched"] += 1
                    if attempt == 1:
                        self.stats["backup_wins"] += 1
                self._inflight.pop(idx, None)
                self._ready.notify_all()


class _FetchError:
    def __init__(self, err):
        self.err = err


def make_train_loader(
    vocab_size: int,
    global_batch: int,
    seq: int,
    *,
    seed: int = 0,
    host_index: int = 0,
    host_count: int = 1,
    start: int = 0,
    prefetch: int = 4,
    workers: int = 2,
    straggler_ms: float = 1000.0,
    fetch_hook=None,
) -> DataLoader:
    """The standard training input pipeline for one host."""
    ds = SyntheticLMDataset(vocab_size, seed=seed)
    shard = host_shard_for(global_batch, host_index, host_count)

    def fetch(i: int) -> dict:
        return ds.batch(i, shard.rows, seq, row_offset=shard.row_offset)

    return DataLoader(
        fetch,
        start=start,
        prefetch=prefetch,
        workers=workers,
        straggler_ms=straggler_ms,
        fetch_hook=fetch_hook,
    )
