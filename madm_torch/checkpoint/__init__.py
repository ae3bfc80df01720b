"""Checkpoints: save/resume of the train state (``checkpointer``) and weight
conversion from the JAX package's tree (``from_jax``)."""

from .checkpointer import BestCheckpointer, Checkpointer, PeriodicCheckpointer, load_checkpoint

__all__ = ["BestCheckpointer", "Checkpointer", "PeriodicCheckpointer", "load_checkpoint"]
