"""Training of the port: the train step and the training loop."""
from .train_step import TrainConfig, make_train_step, summarize_mor_stats
from .trainer import Trainer, TrainerConfig

__all__ = ["TrainConfig", "make_train_step", "summarize_mor_stats",
           "Trainer", "TrainerConfig"]
