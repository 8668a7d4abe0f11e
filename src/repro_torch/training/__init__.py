"""Train state and steps of the port (the port of :mod:`repro.training`): the
single-device step, the data-parallel step and the step on a device mesh, and
the prefill and decode steps; the one-device step's CUDA graph
(:class:`TrainGraph`)."""

from .dp_step import init_dp_state, make_dp_train_step
from .graph import TrainGraph
from .steps import (
    abstract_train_state,
    init_sharded_params,
    init_sharded_train_state,
    init_train_state,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    train_state_logical,
)

__all__ = ["TrainGraph", "abstract_train_state", "init_dp_state", "init_sharded_params", "init_sharded_train_state",
           "init_train_state", "make_dp_train_step", "make_prefill_step", "make_serve_step", "make_train_step",
           "train_state_logical"]
