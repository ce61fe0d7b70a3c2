"""SAM interactive segmentation training entry point.

``python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.train_interactive_segmentation_model --work-dir D``
loads ``D/train_config.py`` and trains through ``engine.run_training``
(log in ``D/log/train.log``, ``D/checkpoints/{latest,best}.pth``, resume
from ``latest.pth``; the best epoch is the one of the lowest train loss).
One process, one GPU; runs on CUDA unless ``--device cpu`` (or
``device="cpu"``) asks for the CPU.

Port of the JAX package's ``tools/train_interactive_segmentation_model.py``.
Each step encodes the images once and runs the prompt decoder 1 +
``decoder_iters`` times: after each pass the best mask by predicted IoU
gives a new click, drawn uniformly from its error region against the target
(a Gumbel-max, ``interactive_segmentation/error_click.py``), appended to the
points, and its logits, downsampled 4x (bilinear with antialiasing, as
``jax.image.resize``), become the next mask prompt. That prompt keeps its
gradient, so each pass's loss reaches back into the passes before it.
``SAMLoss`` runs over all passes in fp32. With ``use_amp`` the model
computes under bf16 autocast; without it, in fp32. The click noise is drawn
on the device from the step's generator, which the train step seeds from
(seed + 7, global iteration, micro-batch), so a resumed run draws what an
uninterrupted one would.
"""

import argparse

import torch
import torch.nn.functional as F

from ..engine import run_training
from ..interactive_segmentation.error_click import (gumbel_noise,
                                                    sample_error_points_batch)
from ..utils import load_config_from_work_dir

PROMPT_KEYS = ("prompt_point", "prompt_box", "prompt_box_valid",
               "prompt_mask", "prompt_mask_valid")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="train interactive segmentation (SAM) model")
    parser.add_argument("--work-dir", type=str, required=True,
                        help="path to experiment dir with train_config.py")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; CUDA when not given")
    return parser.parse_args(argv)


def build_loss_fn(model, config, click_noise=gumbel_noise):
    """``loss_fn(model, batch, generator) -> (loss, {focal_loss, dice_loss,
    iou_predict_loss})`` for ``engine.make_train_step``. ``click_noise(shape,
    generator, device)`` gives the Gumbel noise of each pass's clicks (a
    test feeds the JAX package's draws through it)."""
    criterion = config.train_criterion
    decoder_iters = getattr(config, "decoder_iters", 4)
    use_amp = getattr(config, "use_amp", True)
    quarter = model.image_size // 4

    def loss_fn(model, batch, generator):
        images = batch["image"]
        gt = batch["mask"].float()
        b = images.shape[0]
        rows = torch.arange(b, device=images.device)
        prompts = {k: batch[k].float() for k in PROMPT_KEYS}
        with torch.autocast(images.device.type, dtype=torch.bfloat16,
                            enabled=use_amp):
            embeddings = model.forward_image_encoder(images)
            masks, ious = model.forward_prompt_encoder_mask_decoder(
                embeddings, prompts)
            all_masks, all_ious = [masks], [ious]
            points = prompts["prompt_point"]
            for _ in range(decoder_iters):
                best_logits = all_masks[-1][rows, all_ious[-1].argmax(dim=-1)]
                h, w = best_logits.shape[-2:]
                noise = click_noise((b, h * w), generator, images.device)
                clicks = sample_error_points_batch(
                    noise, (best_logits > 0).float(), gt[:, 0])
                points = torch.cat([points, clicks[:, None]], dim=1)
                prompt_mask = F.interpolate(
                    best_logits[:, None].float(), (quarter, quarter),
                    mode="bilinear", align_corners=False, antialias=True)
                masks, ious = model.forward_prompt_encoder_mask_decoder(
                    embeddings, dict(
                        prompts, prompt_point=points, prompt_mask=prompt_mask,
                        prompt_mask_valid=torch.ones_like(
                            prompts["prompt_mask_valid"])))
                all_masks.append(masks)
                all_ious.append(ious)
        loss_dict = criterion((all_masks, all_ious), gt)
        return sum(loss_dict.values()), loss_dict

    return loss_fn


def main(argv=None, device=None):
    """Train the work dir's SAM; returns ``run_training``'s summary."""
    args = parse_args(argv)
    config = load_config_from_work_dir(args.work_dir, "train_config")
    return run_training(config, args.work_dir, build_loss_fn=build_loss_fn,
                        device=device if device is not None else args.device)


if __name__ == "__main__":
    main()
