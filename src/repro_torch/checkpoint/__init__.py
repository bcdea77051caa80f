"""Checkpoint store in the JAX package's on-disk layout."""
from repro_torch.checkpoint.store import CheckpointStore

__all__ = ["CheckpointStore"]
