"""npz checkpoints with async save, as in `repro.ckpt`."""

from .checkpoint import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]
