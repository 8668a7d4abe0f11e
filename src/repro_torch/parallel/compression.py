"""Error-feedback int8 gradient compression for the inter-node all-reduce (the
port of ``repro.parallel.compression``).

A data-parallel gradient all-reduce crosses two fabrics: NVLink between the
GPUs of a node (fast) and the network between nodes (scarce). The standard
trick (1-bit Adam / EF-SGD lineage) compresses only the slow leg:

    g_node  = mean(g_local, "data")              # f32, within the node
    q, s    = quant_int8(g_node + e)             # e = error feedback carry
    g_sync  = mean(dequant(q, s), "pod")         # across nodes
    e'      = (g_node + e) - dequant(q, s)       # what compression dropped

The carry makes the scheme unbiased over time: what the quantiser drops this
step is re-injected the next (Karimireddy et al., 2019). It is an f32 tree the
size of the gradients, kept in the train state and checkpointed beside the
optimizer's moments.

The arithmetic is the reference's: each participant contributes its
dequantised tensor and the all-reduce sums them in f32, as the reference's
``psum`` does, so only the per-node quantisation loses precision, and error
feedback recycles that loss. :func:`wire_bytes_per_param` is the reference's
accounting of what an int8 wire would carry (the payload and one f32 scale a
row); the collective here carries the f32 sum.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.common import map_defs


def true_div(t: torch.Tensor, n) -> torch.Tensor:
    """``t / n`` rounded once, on every device, as the reference divides:
    PyTorch's CUDA kernel turns a division by a host number into a product
    with its reciprocal, which may differ in the last bit."""
    return t / torch.tensor(float(n), dtype=t.dtype, device=t.device)


def quant_int8(x: torch.Tensor):
    """Per-row absmax int8. x: f32 (..., N) → (int8, f32 scales (...,)):
    round half to even, clipped to ±127."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = true_div(absmax.clamp_min(1e-12), 127)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def dequant_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


def init_ef_state(grads) -> dict:
    """Zero error-feedback carry, mirroring the gradient tree in f32."""
    return map_defs(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def ef_compressed_psum(grads, ef_state, group, n_participants: int):
    """Mean of ``grads`` over the process group ``group`` (``n_participants``
    ranks) through int8 quantisation with error feedback. Every rank of the
    group calls it together, leaf by leaf in the tree's order. Returns
    ``(synced_grads_mean, new_ef_state)``; scalars are not compressed."""

    def sync_leaf(g, e):
        target = g.float() + e  # re-inject what was dropped last step
        if target.dim() == 0:  # scalars: not worth compressing
            dist.all_reduce(target, group=group)
            return true_div(target, n_participants), torch.zeros_like(target)
        q, scale = quant_int8(target)
        sent = dequant_int8(q, scale)
        total = sent.clone(memory_format=torch.contiguous_format)  # a collective's buffer
        dist.all_reduce(total, group=group)
        return true_div(total, n_participants), target - sent  # the local quantisation residual

    out = map_defs(sync_leaf, grads, ef_state)
    return map_defs(lambda o: o[0], out), map_defs(lambda o: o[1], out)


def wire_bytes_per_param(compressed: bool) -> float:
    """Roofline accounting: bytes a parameter each node puts on the
    inter-node network per step."""
    if compressed:
        return 1.0 + 4.0 / 128.0  # int8 + amortised per-row f32 scale
    return 4.0  # f32
