"""Checkpoints of the port in the reference's format (save/restore, async,
integrity-checked; the port of :mod:`repro.checkpoint`)."""

from .manager import CheckpointManager, restore_tree, save_tree

__all__ = ["CheckpointManager", "restore_tree", "save_tree"]
