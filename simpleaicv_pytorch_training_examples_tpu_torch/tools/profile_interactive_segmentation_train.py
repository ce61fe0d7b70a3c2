"""Where the device time of one SAM train step goes.

    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.profile_interactive_segmentation_train \
        [--network sam_b]

The train tool's step (``train_interactive_segmentation_model.build_loss_fn``
through ``engine.make_train_step``: the encoder, 1 + ``decoder_iters``
prompt-decoder passes with error clicks, SAMLoss, AdamW) with the settings of
the port's SAM-B train config (``experiments/interactive_segmentation/
sam_b_training/train_config.py``: gradient checkpointing, the rel-pos
attention kernels, ``decoder_iters = 4``, bf16 autocast), the network at
full width and depth on seeded random weights, on one batch of
``BATCH_SIZE`` seeded synthetic images (768 x 1024, collated to 1024^2 with
the config's prompts). Prints the device time by kernel category with the
categories of ``profile_classification_eval``. Needs a CUDA device.
"""

import argparse
from pathlib import Path

import numpy as np
import torch

from ..engine import init_model, make_train_step
from ..interactive_segmentation import models as sam_models
from ..interactive_segmentation.datasets.syntheticdataset import (
    SyntheticSAMDataset)
from ..utils import build_optimizer, load_config_from_work_dir
from .profile_classification_eval import profile_steps
from .train_interactive_segmentation_model import build_loss_fn

CONFIG_DIR = (Path(__file__).resolve().parents[1] / "experiments"
              / "interactive_segmentation" / "sam_b_training")
BATCH_SIZE = 8
SCHEDULE_STEPS = 100
SYNTHETIC_SIZE = (768, 1024)


def synthetic_batch(config, batch_size=BATCH_SIZE, seed=0):
    """One batch of the seeded synthetic dataset through the config's
    collater, its prompt draws seeded with ``seed``; CPU tensors."""
    dataset = SyntheticSAMDataset(batch_size, SYNTHETIC_SIZE, seed=seed)
    np.random.seed(seed)
    return config.train_collater([dataset[i] for i in range(batch_size)])


def build_train_step(network="sam_b", device="cuda",
                     use_gradient_checkpoint=True):
    """(model, train_step, config): ``network`` at full width and depth on
    the SAM-B train config's seeded init, optimizer (its schedule over
    ``SCHEDULE_STEPS`` steps), loss and checkpointing, or without
    checkpointing."""
    config = load_config_from_work_dir(str(CONFIG_DIR), "train_config")
    model = sam_models.__dict__[network](
        image_size=config.input_image_size,
        use_gradient_checkpoint=use_gradient_checkpoint,
        use_flash_attention=True)
    model = init_model(model, config.seed, device)
    optimizer, _ = build_optimizer(config, model, SCHEDULE_STEPS)
    train_step = make_train_step(model, None, optimizer, seed=config.seed,
                                 loss_fn=build_loss_fn(model, config))
    return model, train_step, config


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--network", default="sam_b",
                        choices=("sam_b", "sam_l", "sam_h"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_interactive_segmentation_train needs a "
                         "CUDA device")
    _, train_step, config = build_train_step(args.network)
    batch = {k: v.cuda() for k, v in synthetic_batch(config).items()}
    iteration = iter(range(10 ** 6))
    return profile_steps(
        lambda: train_step(batch, next(iteration)),
        f"{args.network} train step", {
            "network": args.network, "decoder_iters": config.decoder_iters,
            "gradient_checkpoint": True}, BATCH_SIZE)


if __name__ == "__main__":
    main()
