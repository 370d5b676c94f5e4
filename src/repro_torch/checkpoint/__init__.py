from repro_torch.checkpoint.ckpt import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    tree_leaves,
)

__all__ = ["AsyncCheckpointer", "latest_step", "restore_checkpoint",
           "save_checkpoint", "tree_leaves"]
