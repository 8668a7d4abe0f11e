"""Weights and train states across the package boundary: a nested dict of
arrays from the JAX package (as numpy, or anything ``numpy.asarray`` takes)
to a nested dict of torch tensors, one to one, and back.

Keys, nesting, shapes and dtypes are kept, including the stacked leading
``layers`` axis of the per-layer weights, so the port runs the reference's
exact weights (the two packages draw different numbers from one seed). A
whole train state crosses the same way: ``{"params", "opt", "step"}`` with
AdamW's f32 ``m`` / ``v`` and int32 ``count``, 8-bit AdamW's int8 ``q`` and
f32 ``scale``, Lion's ``m``, and the int32 ``step``, so both packages can
start from one state. This module imports no JAX: the caller hands over
numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import map_defs, resolve_device


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: reinterpret the 16 bits
        return torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)  # a copy: JAX's buffers are read-only


def params_from_jax(tree, device="cuda") -> dict:
    """Nested dict of arrays (params or a train state) → nested dict of
    tensors on ``device``, dtypes kept (bf16 too)."""
    dev = resolve_device(device)
    return map_defs(lambda x: _to_tensor(x, dev), tree)


def params_to_numpy(params) -> dict:
    """Nested dict of tensors (params or a train state) → nested dict of
    numpy arrays on the host, dtypes kept except bf16, which comes back as
    float32 (exact widening): numpy has no bf16 type of its own.
    """

    def conv(t: torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return map_defs(conv, params)
