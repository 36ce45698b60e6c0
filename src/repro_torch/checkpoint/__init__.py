"""Checkpoints of the port, in the JAX package's on-disk format."""

from repro_torch.checkpoint.store import CheckpointStore

__all__ = ["CheckpointStore"]
