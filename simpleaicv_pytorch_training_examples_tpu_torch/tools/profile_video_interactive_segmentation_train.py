"""Where the device time of one SAM2 video train step goes.

    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.profile_video_interactive_segmentation_train \
        [--plain-attention] [--frames 4]

The train tool's step (``train_video_interactive_segmentation_model.
build_loss_fn`` through ``engine.make_train_step``: one Hiera call on the
B x T frames, frame 0 prompted, the other frames tracked from the memory,
the point-iteration frames refined by 2 more decoder passes each, SAM2Loss,
AdamW) with the settings of the port's SAM2-B+ stage-2 config
(``experiments/video_interactive_segmentation/hiera_b_plus_stage2/
train_config.py``: gradient checkpointing, the high-res skips, Hiera heads
padded to 64, two condition slots, the attention kernels K1 and K6 unless
``--plain-attention``, bf16 autocast), at full width and depth on seeded
random weights, on the train recipe of the JAX package's
``bench_sam2_train.py``: batch 1, T = 4 frames of seeded noise at 1024^2,
a point prompt at the centre of frame 0 (the only condition frame),
frames 1 and 2 flagged for refinement (the configs' 2 point-iteration
frames), the centre square of side 400/1024 as the target on every frame
(``recipe_batch``). Prints the device time by kernel category with the
categories of ``profile_classification_eval``. Needs a CUDA device.
"""

import argparse
from pathlib import Path

import numpy as np
import torch

from ..engine import init_model, make_train_step
from ..utils import build_optimizer, load_config_from_work_dir
from .profile_classification_eval import profile_steps
from .train_video_interactive_segmentation_model import (HOST_KEYS,
                                                         build_loss_fn)

CONFIG_DIR = (Path(__file__).resolve().parents[1] / "experiments"
              / "video_interactive_segmentation" / "hiera_b_plus_stage2")
BATCH_SIZE, FRAMES, IMAGE_SIZE = 1, 4, 1024
ITER_FRAMES = (1, 2)
SCHEDULE_STEPS = 100


def recipe_batch(batch_size=BATCH_SIZE, frames=FRAMES, size=IMAGE_SIZE,
                 seed=0):
    """The benchmark recipe's batch (see the module docstring), CPU
    tensors in the layout of ``SAM2VideoBatchCollater``."""
    rs = np.random.RandomState(seed)
    b, t, rq = batch_size, frames, size // 4
    lo, hi = 300 * size // 1024, 700 * size // 1024
    mask = torch.zeros(b, t, size, size)
    mask[:, :, lo:hi, lo:hi] = 1.0
    points = torch.full((b, t, 2, 3), -1.0)
    points[:, 0, 0] = torch.tensor([size / 2, size / 2, 1.0])
    cond, refine = torch.zeros(b, t), torch.zeros(b, t)
    cond[:, 0] = 1.0
    refine[:, [f for f in ITER_FRAMES if f < t]] = 1.0
    return {
        "image": torch.from_numpy(rs.rand(b, t, 3, size, size).astype(
            np.float32)),
        "mask": mask, "prompt_point": points,
        "prompt_box": torch.zeros(b, t, 4),
        "prompt_box_valid": torch.zeros(b, t),
        "prompt_mask": torch.zeros(b, t, 1, rq, rq),
        "prompt_mask_valid": torch.zeros(b, t),
        "is_cond_frame": cond, "is_iter_frame": refine}


def to_device(batch, device="cuda"):
    """The batch on ``device``, the frame roles left on the host."""
    return {k: v if k in HOST_KEYS else v.to(device)
            for k, v in batch.items()}


def build_train_step(device="cuda", use_gradient_checkpoint=True):
    """(model, train_step, config): SAM2-B+ at the stage-2 config's
    settings on its seeded init, its optimizer (schedule over
    ``SCHEDULE_STEPS`` steps) and loss; without checkpointing on request."""
    config = load_config_from_work_dir(str(CONFIG_DIR), "train_config")
    model = config.model
    model.image_encoder.trunk.use_gradient_checkpoint = \
        use_gradient_checkpoint
    model = init_model(model, config.seed, device)
    optimizer, _ = build_optimizer(config, model, SCHEDULE_STEPS)
    train_step = make_train_step(model, None, optimizer, seed=config.seed,
                                 loss_fn=build_loss_fn(model, config),
                                 host_keys=HOST_KEYS)
    return model, train_step, config


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--plain-attention", action="store_true")
    parser.add_argument("--frames", type=int, default=FRAMES)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_video_interactive_segmentation_train needs "
                         "a CUDA device")
    model, train_step, config = build_train_step()
    model.set_flash_attention(not args.plain_attention)
    batch = to_device(recipe_batch(frames=args.frames))
    iteration = iter(range(10 ** 6))
    return profile_steps(
        lambda: train_step(batch, next(iteration)),
        "sam2_hiera_base_plus_video train step", {
            "frames": args.frames, "kernels": not args.plain_attention,
            "point_iter_frames": list(ITER_FRAMES),
            "decoder_point_iters": config.decoder_point_iters,
            "gradient_checkpoint": True}, BATCH_SIZE)


if __name__ == "__main__":
    main()
