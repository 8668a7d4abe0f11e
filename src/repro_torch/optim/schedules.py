"""Learning-rate schedules: callables step → lr, the port of
``repro.optim.schedules``.

A schedule takes the optimizer's 1-based ``count`` (an int32 tensor, or a
number) and returns a 0-dim f32 tensor on the step's device, computed in f32
with the reference's operations in its order. The one exception is the
cosine: neither XLA's f32 ``cos`` nor torch's is correctly rounded, and they
differ from each other, so the port takes the correctly rounded one (in f64,
rounded to f32), which equals XLA's at all but a few steps of a run and is
then one unit in the last place away.
"""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full_like(_f32(step), lr)


def cosine_warmup(peak: float, warmup_steps: int, total_steps: int, floor: float = 0.0):
    def schedule(step):
        step = _f32(step)
        warm = peak * torch.clamp(step / max(1, warmup_steps), max=1.0)
        frac = torch.clamp((step - warmup_steps) / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1 + torch.cos((math.pi * frac).double()).float())
        return torch.where(step < warmup_steps, warm, cos)

    return schedule
