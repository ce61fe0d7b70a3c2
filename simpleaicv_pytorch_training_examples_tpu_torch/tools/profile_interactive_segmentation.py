"""Where the device time of SAM's encoder and decoder goes.

    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.profile_interactive_segmentation \
        [--network sam_b] [--plain-attention]

Builds the network at full width and depth on seeded random weights (as
``predict_interactive_segmentation`` does: bf16 autocast, the rel-pos
attention kernels unless ``--plain-attention``), encodes ``BATCH_SIZE``
copies of the synthetic image, then profiles ``STEPS`` encoder forwards
and ``STEPS`` decoder passes (one point prompt an image) under ``torch.profiler``, and
prints the device time of each by kernel category, the top kernels and one
JSON line each, with the categories of ``profile_classification_eval``.
Needs a CUDA device.
"""

import argparse

import torch

from .predict_interactive_segmentation import (SYNTHETIC_SIZE, build_model,
                                               compute_context, prep_canvas,
                                               prompt_sets, synthetic_image)
from .profile_classification_eval import profile_steps

BATCH_SIZE = 8


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--network", default="sam_b",
                        choices=("sam_b", "sam_l", "sam_h"))
    parser.add_argument("--plain-attention", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_interactive_segmentation needs a CUDA device")
    model = build_model(args.network, device="cuda")
    model.set_flash_attention(not args.plain_attention)
    canvas, factor = prep_canvas(synthetic_image(), model.image_size)
    images = canvas[None].expand(BATCH_SIZE, -1, -1, -1).cuda()
    centre = SYNTHETIC_SIZE / 2   # the synthetic disc's centre
    prompts = prompt_sets([centre, centre], None, factor, BATCH_SIZE,
                          "cuda")["point"]
    extra = {"network": args.network, "kernels": not args.plain_attention}
    with compute_context(images.device):
        embedding = model.forward_image_encoder(images)
        encoder = profile_steps(
            lambda: model.forward_image_encoder(images),
            f"{args.network} encoder", extra, BATCH_SIZE)
        decoder = profile_steps(
            lambda: model.forward_prompt_encoder_mask_decoder(embedding,
                                                              prompts),
            f"{args.network} decoder, point prompts", extra, BATCH_SIZE)
    return encoder, decoder


if __name__ == "__main__":
    main()
