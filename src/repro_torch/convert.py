"""Weights across the package boundary: a tree of arrays from the JAX
package (as numpy, or anything ``numpy.asarray`` takes) to a dict of torch
tensors, one to one, and back.

Keys, nesting and shapes are kept, including the stacked leading ``layers``
axis of the per-layer weights, so the port runs the reference's exact weights
(the two packages draw different numbers from one seed). This module imports
no JAX: the caller hands over numpy arrays.
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
    """Nested dict of arrays → nested dict of tensors on ``device``."""
    dev = resolve_device(device)
    return map_defs(lambda x: _to_tensor(x, dev), tree)


def params_to_numpy(params) -> dict:
    """Nested dict of tensors → nested dict of numpy arrays on the host.

    bf16 comes back as float32 (exact widening): numpy has no bf16 type of
    its own.
    """

    def conv(t: torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return map_defs(conv, params)
