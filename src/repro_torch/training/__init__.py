"""Train state and train step of the port (the port of :mod:`repro.training`)."""

from .steps import init_train_state, make_train_step

__all__ = ["init_train_state", "make_train_step"]
