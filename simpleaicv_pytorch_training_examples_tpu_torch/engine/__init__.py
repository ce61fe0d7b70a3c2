from .engine import (apply_pretrained, init_model,
                     make_classification_eval_step, make_train_step)
from .evaluators import classification_evaluator
from .runner import RunContext, run_test, run_training

__all__ = ["RunContext", "apply_pretrained", "classification_evaluator",
           "init_model", "make_classification_eval_step", "make_train_step",
           "run_test", "run_training"]
