"""Checkpoint store and async checkpointer of the port (npz shards, JSON
manifest, atomic commit, neighbour replicas)."""
from repro_torch.ckpt.async_ckpt import AsyncCheckpointer
from repro_torch.ckpt.store import (
    is_committed,
    latest_checkpoint,
    list_checkpoints,
    load_pytree,
    save_pytree,
)

__all__ = [
    "AsyncCheckpointer", "is_committed", "latest_checkpoint",
    "list_checkpoints", "load_pytree", "save_pytree",
]
