"""CUDA graphs of the steps: the one-device train step over static buffers
(:class:`TrainGraph`, the counterpart of the reference's ``jax.jit`` over its
train step with the state donated) and the capture and warm-up that it and
the serve engines' decode graph share (:class:`Captured`, :func:`warm_up`).

A capture runs no kernel, so the kernel wrappers' launch counts would count
the captured launches once and the replays never: :class:`Captured` takes
back what the capture added and adds it again at each replay, so the counts
say what ran on the device.
"""

from __future__ import annotations

import functools
import time

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import map_defs, tree_leaves


class Captured:
    """``fn()`` captured into a CUDA graph (``torch.cuda.graph``, in a
    memory pool of its own). ``out`` is what the captured call returned: its
    tensors are the graph's, overwritten at each replay. The wrappers'
    launch counts are left as they were before the capture;
    ``launches`` (keyed as :func:`ops.launch_counts` keys them) is what each
    :meth:`replay` adds to them. A failed capture raises."""

    def __init__(self, fn):
        before = ops.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn()
        after = ops.launch_counts()
        self.launches = {key: after[key] - n for key, n in before.items() if after[key] != n}
        ops.add_launch_counts(self.launches, -1)  # the capture launched nothing

    def replay(self) -> None:
        self.graph.replay()
        ops.add_launch_counts(self.launches)


def warm_up(fn, device):
    """``fn()`` on the device's warm-up stream, after the current stream's
    work and before its later work: a graph's first step, so that the
    libraries' first calls happen outside the capture. Every graph on a
    device warms up on one stream: cuBLAS keeps a workspace for each stream
    it ran on, and a stream of each graph's own would hold one per graph.
    The caller calls ``record_stream`` on the current stream for each
    tensor of the result that it keeps."""
    stream = torch.cuda.current_stream(device)
    side = _warm_up_stream(stream.device_index)
    side.wait_stream(stream)
    with torch.cuda.stream(side):
        out = fn()
    stream.wait_stream(side)
    return out


@functools.cache
def _warm_up_stream(index: int) -> torch.cuda.Stream:
    return torch.cuda.Stream(index)


def _copy_into(static, new) -> None:
    """Overwrite each leaf of ``static`` with the leaf of ``new`` at its path."""
    for (path, s), (_, t) in zip(tree_leaves(static), tree_leaves(new), strict=True):
        if s.shape != t.shape or s.dtype != t.dtype:
            raise ValueError(f"{path}: the step returned {tuple(t.shape)} {t.dtype} for a static "
                             f"{tuple(s.shape)} {s.dtype}")
        s.copy_(t)


class TrainGraph:
    """The one-device train step over static buffers, the counterpart of the
    reference's ``jax.jit(train_step, donate_argnums=(0,))``.

    ``TrainGraph(step, state)`` wraps ``step``, the function
    :func:`repro_torch.training.make_train_step` returns for one device, and
    adopts ``state`` (``params``, ``opt``, ``step``) as its static state: its
    tensors are overwritten in place at every step, so the caller gives up
    the state, as the reference donates it. :meth:`feed` copies a batch into
    the static batch (allocated at the first feed; a batch of another shape,
    dtype or set of keys raises). A call has the step's contract, ``(state,
    batch) → (state, metrics)``, over the static buffers only:
    ``graph(graph.state, graph.batch)`` returns ``graph.state`` and
    ``graph.metrics``, updated in place; any other state or batch raises.
    Within a step the step function runs on the static state and then each
    leaf it returns, ``step`` included, is copied into its static leaf; the
    optimizer stays functional, so the bits are the eager step's.

    On ``cuda`` the first call is the warm-up: the step runs eagerly on a
    side stream and its result is copied into the static state (its launches
    count). The allocator's cache is then emptied (the warm-up's cached
    blocks and the graph's pool together would not fit the widest paths)
    and the step is captured with ``torch.cuda.graph`` in a memory pool of
    its own (:class:`Captured`: the capture counts no launch). Every later
    call replays the graph, which runs no Python wrapper and none of
    autograd's host work, and adds to the launch counts what the capture
    recorded; ``replays`` counts them. There is no fallback: a failed
    capture raises. On the CPU every call runs the step eagerly over the
    same static buffers and ``replays`` stays 0.

    A replay overwrites the static metrics and state: a caller that keeps a
    step's metrics or state past the next step clones them (a checkpoint's
    save copies the state to the host before it returns). ``step`` is the
    wrapped eager function; ``seconds`` holds the warm-up's and the
    capture's wall seconds once they ran."""

    def __init__(self, step, state: dict):
        self.step, self.state = step, state
        self.device = tree_leaves(state)[0][1].device
        self.batch = self.metrics = None
        self.replays = 0
        self.seconds = {}
        self._captured = None

    def feed(self, batch: dict) -> dict:
        """Copy ``batch`` (tensors on the host or the device) into the static
        batch and return it."""
        if self.batch is None:
            self.batch = {k: torch.empty(v.shape, dtype=v.dtype, device=self.device) for k, v in batch.items()}
        elif set(batch) != set(self.batch):
            raise ValueError(f"batch keys {sorted(batch)} differ from the static batch's {sorted(self.batch)}")
        for k, v in batch.items():
            s = self.batch[k]
            if v.shape != s.shape or v.dtype != s.dtype:
                raise ValueError(f"batch[{k!r}] is {tuple(v.shape)} {v.dtype}; the static batch holds "
                                 f"{tuple(s.shape)} {s.dtype}")
            s.copy_(v)
        return self.batch

    def __call__(self, state: dict, batch: dict):
        if state is not self.state or batch is None or batch is not self.batch:
            raise ValueError("a train graph steps its own static state and batch: call graph(graph.state, "
                             "graph.feed(batch))")
        if self._captured is not None:
            self._captured.replay()
            self.replays += 1
        elif self.device.type != "cuda":
            self._keep(*self.step(self.state, self.batch))
        else:
            self._warm_up_and_capture()
        return self.state, self.metrics

    def _keep(self, new_state: dict, metrics: dict) -> None:
        """Copy a step's result into the static state and metrics (allocated
        from the first step's metrics)."""
        _copy_into(self.state, new_state)
        if self.metrics is None:
            self.metrics = map_defs(torch.clone, metrics)
        else:
            _copy_into(self.metrics, metrics)

    def _warm_up_and_capture(self) -> None:
        t0 = time.perf_counter()

        def first():
            new_state, metrics = self.step(self.state, self.batch)
            _copy_into(self.state, new_state)
            return metrics

        metrics = warm_up(first, self.device)
        stream = torch.cuda.current_stream(self.device)
        for t in metrics.values():
            t.record_stream(stream)
        self.metrics = map_defs(torch.clone, metrics)
        del metrics
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()

        def step():
            new_state, metrics = self.step(self.state, self.batch)
            _copy_into(self.state, new_state)
            _copy_into(self.metrics, metrics)

        self._captured = Captured(step)
        torch.cuda.synchronize(self.device)
        self.seconds = {"warm_up": t1 - t0, "capture": time.perf_counter() - t1}
