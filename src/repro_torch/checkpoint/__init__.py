"""Parameter-tree checkpoints and crash-safe serving snapshots
(counterpart of ``repro.checkpoint``)."""

from repro_torch.checkpoint.checkpointer import (load_checkpoint,
                                                 load_snapshot, restore_tree,
                                                 save_checkpoint,
                                                 save_snapshot)

__all__ = ["save_checkpoint", "load_checkpoint", "save_snapshot",
           "load_snapshot", "restore_tree"]
