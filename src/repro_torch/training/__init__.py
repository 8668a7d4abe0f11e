"""Train state and train steps of the port (the port of :mod:`repro.training`):
the single-device step and the data-parallel step."""

from .dp_step import init_dp_state, make_dp_train_step
from .steps import init_train_state, make_train_step

__all__ = ["init_dp_state", "init_train_state", "make_dp_train_step", "make_train_step"]
