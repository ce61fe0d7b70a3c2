"""SAM encoder distillation training entry point (13.0).

``python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.train_interactive_segmentation_distill_encoder_model --work-dir D``
loads ``D/train_config.py`` (a distill model from
``interactive_segmentation/distill_model.py``, ``train_criterion`` the
``MSELoss``, the SAM dataset and collater) and trains through
``engine.run_training``: each step's loss is the MSE of the teacher's and
the student's embeddings of the batch's images (in bf16 with ``use_amp``,
the model then computing in its own dtype), its metric
``distill_mse_loss``. With ``freeze_teacher`` (the default) the teacher's
lr is 0 through ``sub_layer_lr`` (the JAX tool's rule). No evaluator: the
best epoch is the one of the lowest mean train loss. Log in
``D/log/train.log``, checkpoints in ``D/checkpoints/``, resume from
``latest.pth``. Runs on CUDA unless ``--device cpu`` (or ``device="cpu"``)
asks for the CPU; under ``torchrun`` one process a GPU.

Port of the JAX package's ``tools/train_interactive_segmentation_distill_
encoder_model.py``.
"""

import argparse

import torch

from ..engine import run_training
from ..utils import load_config_from_work_dir
from .train_distill_classification_model import freeze_teacher_lr


def parse_args(argv=None, description="train SAM encoder distill model"):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--work-dir", type=str, required=True,
                        help="path to experiment dir with train_config.py")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; CUDA when not given")
    return parser.parse_args(argv)


def build_loss_fn(model, config):
    """``loss_fn(model, batch, generator)``: the criterion's losses summed,
    each also a metric."""
    criterion = config.train_criterion
    compute_dtype = torch.bfloat16 if getattr(config, "use_amp", True) \
        else torch.float32

    def loss_fn(model, batch, generator):
        tea, stu = model(batch["image"].to(compute_dtype))
        loss_dict = criterion(tea, stu)
        return sum(loss_dict.values()), loss_dict

    return loss_fn


def main(argv=None, device=None, description=None):
    """Train the work dir's distill model; returns {'best_loss',
    'resumed_from' (epoch or None), 'model', 'epochs': the runner's epoch
    records}."""
    args = parse_args(argv, description or "train SAM encoder distill model")
    config = freeze_teacher_lr(load_config_from_work_dir(args.work_dir,
                                                         "train_config"))
    run = run_training(config, args.work_dir, build_loss_fn=build_loss_fn,
                       higher_is_better=False,
                       device=device if device is not None else args.device)
    return {"best_loss": run["best_metric"],
            "resumed_from": run["resumed_from"], "model": run["model"],
            "epochs": run["epochs"]}


if __name__ == "__main__":
    main()
