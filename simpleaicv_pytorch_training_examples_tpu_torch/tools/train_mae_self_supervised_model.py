"""MAE self-supervised pretraining entry point.

``python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.train_mae_self_supervised_model --work-dir D``
loads ``D/train_config.py`` (an MAE model, the collater's patchified labels,
a masked-patch reconstruction loss as ``train_criterion``) and trains
through ``engine.run_training``: the model returns (predicted patches,
mask), the loss compares them with the labels on the masked patches, and
the best epoch is the one of the lowest mean train loss (``best.pth``);
``latest.pth`` resumes a run. The masking noise draws from the step's
generator, seeded per micro-batch from the config seed and the global
iteration, so a resumed epoch masks what an uninterrupted one would. Logs
to ``D/log/train.log``. One process, one GPU; runs on CUDA unless
``--device cpu`` (or ``device="cpu"``) asks for the CPU.
"""

import argparse

import torch

from ..engine import run_training
from ..utils import load_config_from_work_dir


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="train MAE model")
    parser.add_argument("--work-dir", type=str, required=True,
                        help="path to experiment dir with train_config.py")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; CUDA when not given")
    return parser.parse_args(argv)


def build_loss_fn(model, config):
    """``loss_fn(model, batch, generator)`` of one micro-batch: the images
    in the compute dtype through the model, the criterion on (pred, label,
    mask)."""
    criterion = config.train_criterion
    compute_dtype = torch.bfloat16 if getattr(config, "use_amp", True) \
        else torch.float32

    def loss_fn(model, batch, generator):
        pred, mask = model(batch["image"].to(compute_dtype))
        return criterion(pred, batch["label"], mask), {}

    return loss_fn


def main(argv=None, device=None):
    """Pretrain the work dir's model; returns {'best_loss', 'resumed_from'
    (epoch or None), 'model', 'epochs': the runner's epoch records}."""
    args = parse_args(argv)
    config = load_config_from_work_dir(args.work_dir, "train_config")
    run = run_training(config, args.work_dir, build_loss_fn=build_loss_fn,
                       higher_is_better=False,
                       device=device if device is not None else args.device)
    return {"best_loss": run["best_metric"],
            "resumed_from": run["resumed_from"], "model": run["model"],
            "epochs": run["epochs"]}


if __name__ == "__main__":
    main()
