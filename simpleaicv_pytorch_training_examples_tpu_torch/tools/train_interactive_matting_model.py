"""SAM interactive matting training entry point.

``python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.train_interactive_matting_model --work-dir D``
loads ``D/train_config.py`` and trains through ``engine.run_training``
(log in ``D/log/train.log``, ``D/checkpoints/{latest,best}.pth``, resume
from ``latest.pth``; the best epoch is the one of the lowest train loss).
One process, one GPU; runs on CUDA unless ``--device cpu`` (or
``device="cpu"``) asks for the CPU.

Port of the JAX package's ``tools/train_interactive_matting_model.py``:
each step runs ``SAMMatting`` on the prompted images and sums the config's
``train_criterion`` (a dict of the matting losses, each times its
``loss_ratio``), dispatched by name as the JAX tool does: ``Global*`` on
the trimap prediction and the trimap, ``Local*`` on the local alpha, the
alpha and the trimap, ``Composition*`` on the image, the alpha, the
plates and the fused alpha, the others on the fused alpha and the alpha.
One name differs: the JAX tool tests the prefix ``Global``, which the
trimap IoU loss's name, ``GloabelTrimapIouLoss``, misses, so it calls that
loss on the fused alpha and the alpha, and the 13.2 configs' step fails
there on a shape mismatch; this tool gives it the trimap prediction and
the trimap, as ``SAM2MattingLoss`` does.
With ``use_amp`` the model computes under bf16 autocast, and the
composition loss sees the image rounded to bf16, as the JAX tool's does;
the losses compute in fp32.
"""

import argparse

import torch

from ..engine import run_training
from ..utils import load_config_from_work_dir

PROMPT_KEYS = ("prompt_point", "prompt_box", "prompt_box_valid",
               "prompt_mask", "prompt_mask_valid")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="train interactive matting model")
    parser.add_argument("--work-dir", type=str, required=True,
                        help="path to experiment dir with train_config.py")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; CUDA when not given")
    return parser.parse_args(argv)


def build_loss_fn(model, config):
    """``loss_fn(model, batch, generator) -> (loss, {criterion name:
    weighted loss})`` for ``engine.make_train_step``."""
    criterion = config.train_criterion
    ratios = getattr(config, "loss_ratio", {k: 1.0 for k in criterion})
    use_amp = getattr(config, "use_amp", True)
    compute_dtype = torch.bfloat16 if use_amp else torch.float32

    def loss_fn(model, batch, generator):
        images = batch["image"]
        prompts = {k: batch[k].float() for k in PROMPT_KEYS}
        with torch.autocast(images.device.type, dtype=torch.bfloat16,
                            enabled=use_amp):
            g, l, f, _ = model(images, prompts)
        alpha = batch["mask"]
        trimap = batch["trimap"]
        loss_dict = {}
        for name, loss_obj in criterion.items():
            if name.startswith(("Global", "Gloabel")):
                v = loss_obj(g, trimap)
            elif name.startswith("Local"):
                v = loss_obj(l, alpha, trimap)
            elif name.startswith("Composition"):
                v = loss_obj(images.to(compute_dtype).float(), alpha,
                             batch["fg_map"], batch["bg_map"], f)
            else:
                v = loss_obj(f, alpha)
            loss_dict[name] = v * ratios.get(name, 1.0)
        return sum(loss_dict.values()), loss_dict

    return loss_fn


def main(argv=None, device=None):
    """Train the work dir's SAM matting model; returns ``run_training``'s
    summary."""
    args = parse_args(argv)
    config = load_config_from_work_dir(args.work_dir, "train_config")
    return run_training(config, args.work_dir, build_loss_fn=build_loss_fn,
                        device=device if device is not None else args.device)


if __name__ == "__main__":
    main()
