"""Functional optimizers and learning-rate schedules of the port (the port of
:mod:`repro.optim`)."""

from .optimizers import Optimizer, adamw, adamw8bit, lion, make_optimizer
from .schedules import constant, cosine_warmup

__all__ = [
    "Optimizer", "adamw", "adamw8bit", "lion", "make_optimizer",
    "constant", "cosine_warmup",
]
