from repro_torch.checkpoint.ckpt import (
    CheckpointManager, restore_tree, save_tree,
)

__all__ = ["CheckpointManager", "restore_tree", "save_tree"]
