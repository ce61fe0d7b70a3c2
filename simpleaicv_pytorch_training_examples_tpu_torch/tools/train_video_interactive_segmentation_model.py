"""SAM2 video interactive segmentation training entry point.

``python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.train_video_interactive_segmentation_model --work-dir D``
loads ``D/train_config.py`` and trains through ``engine.run_training``
(log in ``D/log/train.log``, ``D/checkpoints/{latest,best}.pth``, resume
from ``latest.pth``; the best epoch is the one of the lowest train loss).
One process, one GPU; runs on CUDA unless ``--device cpu`` (or
``device="cpu"``) asks for the CPU.

Port of the JAX package's ``tools/train_video_interactive_segmentation_model.py``
(its ``build_loss_fn``; the three-program split of the step, which only
saves XLA compile time, is not ported). Each step runs ``SAM2Video``'s
forward on the clips: one encoder call on the B x T frames, frame 0
prompted, the other frames tracked from the memory, and ``SAM2Loss`` (or
``SAM2MultiLevelLoss``) over the frames in fp32. The recipe follows the
batch: frame-0 prompts (``prompt_point`` [B, P, 3], ``SAM2VideoCollater``)
track from frame 0 alone; per-frame prompts (``prompt_point`` [B, T, P, 3],
``SAM2VideoBatchCollater``) add the condition frames and, with the config's
``decoder_point_iters``, the point-iteration frames refined by error
clicks, whose Gumbel noise the step's generator draws on the device (seeded
from (seed + 7, global iteration, micro-batch), so a resumed run draws what
an uninterrupted one would). The frame roles stay on the host. With
``use_amp`` the model computes under bf16 autocast; without it, in fp32.
"""

import argparse

import torch

from ..engine import run_training
from ..interactive_segmentation.error_click import gumbel_noise
from ..utils import load_config_from_work_dir

PROMPT_KEYS = ("prompt_point", "prompt_box", "prompt_box_valid",
               "prompt_mask", "prompt_mask_valid")
# the frame roles of the condition-frame recipe: read on the host
HOST_KEYS = ("is_cond_frame", "is_iter_frame")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="train video interactive segmentation (SAM2) model")
    parser.add_argument("--work-dir", type=str, required=True,
                        help="path to experiment dir with train_config.py")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; CUDA when not given")
    return parser.parse_args(argv)


def build_loss_fn(model, config, click_noise=gumbel_noise):
    """``loss_fn(model, batch, generator) -> (loss, {focal_loss, dice_loss,
    iou_predict_loss, object_score_loss})`` for ``engine.make_train_step``.
    ``click_noise(shape, generator, device)`` gives the Gumbel noise of each
    refinement click (a test feeds the JAX package's draws through it)."""
    criterion = config.train_criterion
    point_iters = getattr(config, "decoder_point_iters", 0)
    use_amp = getattr(config, "use_amp", True)

    def loss_fn(model, batch, generator):
        images = batch["image"]
        if batch["prompt_point"].dim() == 4:        # [B, T, P, 3]
            prompts = {k: batch[k].float() for k in PROMPT_KEYS}
            kwargs = dict(gt_masks=batch["mask"].float(),
                          is_cond_frame=batch["is_cond_frame"].amax(dim=0),
                          is_iter_frame=batch["is_iter_frame"].amax(dim=0),
                          generator=generator, point_iters=point_iters,
                          click_noise=click_noise)
        else:
            prompts = {"prompt_point": batch["prompt_point"].float(),
                       "prompt_box": None, "prompt_mask": None}
            kwargs = {}
        with torch.autocast(images.device.type, dtype=torch.bfloat16,
                            enabled=use_amp):
            preds = model(images, prompts, **kwargs)
        loss_dict = criterion(preds, batch["mask"])
        return sum(loss_dict.values()), loss_dict

    return loss_fn


def main(argv=None, device=None):
    """Train the work dir's SAM2; returns ``run_training``'s summary."""
    args = parse_args(argv)
    config = load_config_from_work_dir(args.work_dir, "train_config")
    return run_training(config, args.work_dir, build_loss_fn=build_loss_fn,
                        device=device if device is not None else args.device,
                        host_keys=HOST_KEYS)


if __name__ == "__main__":
    main()
