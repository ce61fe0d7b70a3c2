"""Model set-up and the classification eval step.

Counterpart of the JAX package's ``engine/engine.py`` (``init_model``,
``apply_pretrained``, ``make_classification_eval_step``). The train step
comes with the training slice.
"""

import torch

from ..device import resolve_device
from ..models.common import init_parameters_
from ..utils.checkpoint import load_state_dict_filtered, load_torch_state_dict


def init_model(model, seed: int, device=None):
    """Initialise ``model``'s parameters from a generator seeded with
    ``seed``, move it to ``device`` (CUDA unless the caller asks for the
    CPU) and put it in eval mode. Returns the model."""
    device = resolve_device(device)
    init_parameters_(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def apply_pretrained(model, logger=None):
    """Load the torch checkpoint recorded on the model by the config's
    ``load_state_dict`` (name- and shape-filtered, pos-embed resized).
    Returns the model."""
    path = getattr(model, "pretrained_path", "")
    saved = load_torch_state_dict(path)
    if saved is None:
        return model
    excluded = getattr(model, "pretrained_excluded", ())
    saved = {k: v for k, v in saved.items()
             if not any(e in k for e in excluded)}
    loaded, total = load_state_dict_filtered(model, saved, logger)
    if logger:
        logger.info(f"pretrained load: {loaded}/{total} tensors from {path}")
    return model


def make_classification_eval_step(model, topk: int = 5,
                                  compute_dtype=torch.bfloat16):
    """Eval step: batch {'image': NCHW, 'label': [B]} -> (top-1 bools [B],
    top-k bools [B], fp32 logits [B, classes]), on the model's device."""
    device = next(model.parameters()).device
    model.eval()

    @torch.inference_mode()
    def eval_step(batch):
        images = batch["image"].to(device, non_blocking=True).to(compute_dtype)
        labels = batch["label"].to(device, non_blocking=True)
        logits = model(images).float()
        top1 = logits.argmax(dim=-1) == labels
        topk_idx = logits.topk(topk, dim=-1).indices
        topk_hit = (topk_idx == labels[:, None]).any(dim=-1)
        return top1, topk_hit, logits

    return eval_step
