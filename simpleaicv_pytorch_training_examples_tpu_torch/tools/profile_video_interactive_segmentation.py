"""Where the device time of SAM2's video tracking goes.

    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.profile_video_interactive_segmentation \
        [--plain-attention]

Builds SAM2-B+ as ``predict_video_interactive_segmentation`` does (1024^2,
batch 1, bf16 autocast, seeded random weights, the attention kernels K1
and K6 unless ``--plain-attention``), tracks ``WARM_FRAMES`` frames of the
synthetic clip so that every memory slot is filled, then profiles
``encode_frame`` and ``track_frame`` (from that carry) under
``torch.profiler`` and prints the device time of each by kernel category,
the top kernels and one JSON line each, with the categories of
``profile_classification_eval``. Needs a CUDA device.
"""

import argparse

import torch

from .predict_video_interactive_segmentation import (SYNTHETIC_POINT,
                                                     build_model,
                                                     clip_and_prompts,
                                                     compute_context,
                                                     synthetic_clip, track)
from .profile_classification_eval import profile_steps

NETWORK = "sam2_hiera_base_plus_video"
WARM_FRAMES = 8   # 1 prompted + 7 tracked: all 7 memory slots valid


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--plain-attention", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_video_interactive_segmentation needs a "
                         "CUDA device")
    model = build_model(NETWORK, device="cuda")
    model.set_flash_attention(not args.plain_attention)
    frames, prompts = clip_and_prompts(synthetic_clip(WARM_FRAMES),
                                       SYNTHETIC_POINT, model.image_size,
                                       "cuda")
    _, _, carry = track(model, frames, prompts)
    extra = {"network": NETWORK, "kernels": not args.plain_attention}
    with compute_context(frames.device):
        feat, pos, highres = model.encode_frame(frames[-1:])
        encode = profile_steps(lambda: model.encode_frame(frames[-1:]),
                               f"{NETWORK} encode_frame", extra, 1)
        tracked = profile_steps(
            lambda: model.track_frame(feat, pos, carry, highres=highres),
            f"{NETWORK} track_frame, all memory slots valid", extra, 1)
    return encode, tracked


if __name__ == "__main__":
    main()
