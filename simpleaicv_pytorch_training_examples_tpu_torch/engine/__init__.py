from .engine import apply_pretrained, init_model, make_classification_eval_step

__all__ = ["apply_pretrained", "init_model", "make_classification_eval_step"]
