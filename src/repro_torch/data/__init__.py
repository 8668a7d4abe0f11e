"""Data pipeline of the port: deterministic synthetic LM streams, per-host
sharding, background prefetch with backup fetch (a copy of :mod:`repro.data`)."""

from .pipeline import (
    DataLoader,
    HostShard,
    SyntheticLMDataset,
    host_shard_for,
    make_train_loader,
)

__all__ = [
    "DataLoader",
    "HostShard",
    "SyntheticLMDataset",
    "host_shard_for",
    "make_train_loader",
]
