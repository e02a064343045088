"""The training loop, as in `repro.train`."""

from .loop import TrainConfig, make_train_step, train

__all__ = ["TrainConfig", "make_train_step", "train"]
