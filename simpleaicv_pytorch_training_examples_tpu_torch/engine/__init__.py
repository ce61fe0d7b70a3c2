from .engine import (apply_pretrained, init_model,
                     make_classification_eval_step, make_train_step)
from .runner import run_training

__all__ = ["apply_pretrained", "init_model", "make_classification_eval_step",
           "make_train_step", "run_training"]
