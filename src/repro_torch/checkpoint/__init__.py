"""Checkpoint/resume of simulation state (counterpart of
``repro.checkpoint``): :class:`Checkpointer` saves any tree of tensors;
:class:`SimCheckpointer` saves the engine state at window boundaries. The
on-disk layout is the reference's, so either package resumes the other's
checkpoints."""
from repro_torch.checkpoint.checkpointer import (Checkpointer, SimCheckpoint,
                                                 SimCheckpointer, tree_keys)

__all__ = ["Checkpointer", "SimCheckpoint", "SimCheckpointer", "tree_keys"]
