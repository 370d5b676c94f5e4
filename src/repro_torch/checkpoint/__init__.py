from repro_torch.checkpoint.ckpt import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    tree_leaves,
)
from repro_torch.checkpoint.reference import (
    restore_reference_checkpoint,
    save_reference_checkpoint,
)

__all__ = ["AsyncCheckpointer", "latest_step", "restore_checkpoint",
           "restore_reference_checkpoint", "save_checkpoint",
           "save_reference_checkpoint", "tree_leaves"]
