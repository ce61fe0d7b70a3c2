"""ImageNet-21K semantic-softmax classification training entry point.

``python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.train_imagenet21k_classification_model --work-dir D``
trains ``D/train_config.py`` through ``engine.run_training``, as the
classification tool does, with the loss taken over the semantic tree: the
logits of each level (``outputs[:, classes]``) and each sample's label at
that level from the train dataset's tables
(``ImageNet21KSemanticTreeLabelDataset``) go to ``config.train_criterion``
(``SemanticSoftmaxLoss``). Evaluates flat top-1 / top-5 each epoch where
the config has a test dataset. Runs on CUDA unless ``--device cpu`` (or
``device="cpu"``) asks for the CPU.
"""

import torch

from ..engine import classification_evaluator, run_training
from ..utils import load_config_from_work_dir
from .train_classification_model import epoch_summaries, parse_args


def build_loss_fn(model, config):
    """``loss_fn(model, batch, generator) -> (loss, {})`` of the semantic
    softmax over the train dataset's tree."""
    criterion = config.train_criterion
    dataset = config.train_dataset
    compute_dtype = torch.bfloat16 if getattr(config, "use_amp", True) \
        else torch.float32
    device = next(model.parameters()).device
    level_classes = [torch.as_tensor(c, device=device)
                     for c in dataset.hierarchy_class_lists]
    label_table = torch.as_tensor(dataset.semantic_label_table,
                                  device=device)

    def loss_fn(model, batch, generator):
        out = model(batch["image"].to(compute_dtype))
        semantic_outputs = [out[:, c] for c in level_classes]
        return criterion(semantic_outputs, label_table[batch["label"]]), {}

    return loss_fn


def main(argv=None, device=None):
    """Train the work dir's model; returns the classification tool's
    summary (without a test dataset, no 'top1' / 'top5' and 'best_top1' the
    lowest mean train loss)."""
    args = parse_args(argv, "train imagenet21k classification model")
    config = load_config_from_work_dir(args.work_dir, "train_config")
    evaluates = getattr(config, "test_dataset", None) is not None
    run = run_training(config, args.work_dir, build_loss_fn=build_loss_fn,
                       build_eval=classification_evaluator if evaluates
                       else None,
                       device=device if device is not None else args.device)
    return {"best_top1": run["best_metric"],
            "resumed_from": run["resumed_from"],
            "epochs": epoch_summaries(run) if evaluates else run["epochs"]}


if __name__ == "__main__":
    main()
