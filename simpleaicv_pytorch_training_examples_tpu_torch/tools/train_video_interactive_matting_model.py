"""SAM2 video interactive matting training entry point.

``python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.train_video_interactive_matting_model --work-dir D``
loads ``D/train_config.py`` and trains through ``engine.run_training``
(log in ``D/log/train.log``, ``D/checkpoints/{latest,best}.pth``, resume
from ``latest.pth``; the best epoch is the one of the lowest train loss).
One process, one GPU; runs on CUDA unless ``--device cpu`` (or
``device="cpu"``) asks for the CPU.

Port of the JAX package's ``tools/train_video_interactive_matting_model.py``:
each step runs ``SAM2VideoMatting`` on the clips (one encoder call on the
B x T frames, frame 0 prompted, the other frames tracked from the memory,
the matting triple on every frame) and the config's ``train_criterion``
(``SAM2MattingLoss``) over the frames in fp32. With per-frame prompts
(``prompt_point`` [B, T, P, 3], ``SAM2VideoMattingBatchCollater``) the
condition frames fill the reserved memory slots; ``is_cond_frame`` stays
on the host (``run_training(host_keys=...)``), as the JAX tool reduces it
over the batch. With frame-0 prompts (``SAM2VideoMattingCollater``) only
the points go in, as in JAX. With ``use_amp`` the model computes under
bf16 autocast; without it, in fp32.
"""

import argparse

import torch

from ..engine import run_training
from ..utils import load_config_from_work_dir

PROMPT_KEYS = ("prompt_point", "prompt_box", "prompt_box_valid",
               "prompt_mask", "prompt_mask_valid")
HOST_KEYS = ("is_cond_frame",)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="train video interactive matting (SAM2) model")
    parser.add_argument("--work-dir", type=str, required=True,
                        help="path to experiment dir with train_config.py")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; CUDA when not given")
    return parser.parse_args(argv)


def build_loss_fn(model, config):
    """``loss_fn(model, batch, generator) -> (loss, {the criterion's
    terms})`` for ``engine.make_train_step``."""
    criterion = config.train_criterion
    use_amp = getattr(config, "use_amp", True)

    def loss_fn(model, batch, generator):
        images = batch["image"]
        if batch["prompt_point"].dim() == 4:        # [B, T, P, 3]
            prompts = {k: batch[k].float() for k in PROMPT_KEYS}
            kwargs = {"is_cond_frame": batch["is_cond_frame"].amax(dim=0)}
        else:
            prompts = {"prompt_point": batch["prompt_point"].float(),
                       "prompt_box": None, "prompt_mask": None}
            kwargs = {}
        with torch.autocast(images.device.type, dtype=torch.bfloat16,
                            enabled=use_amp):
            out = model(images, prompts, **kwargs)
        loss_dict = criterion(out[:3], batch["alpha"], batch["trimap"])
        total = loss_dict.pop("loss")
        return total, loss_dict

    return loss_fn


def main(argv=None, device=None):
    """Train the work dir's SAM2 matting model; returns ``run_training``'s
    summary."""
    args = parse_args(argv)
    config = load_config_from_work_dir(args.work_dir, "train_config")
    return run_training(config, args.work_dir, build_loss_fn=build_loss_fn,
                        device=device if device is not None else args.device,
                        host_keys=HOST_KEYS)


if __name__ == "__main__":
    main()
