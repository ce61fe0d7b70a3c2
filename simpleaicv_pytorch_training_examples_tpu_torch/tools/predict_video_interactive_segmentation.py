"""Video object tracking with SAM2: click an object on frame 0, then stream
every later frame through the tracker.

    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.predict_video_interactive_segmentation \
        --network sam2_hiera_base_plus_video [--checkpoint sam2.pth] \
        (--video frames.npy | --synthetic) [--point 128,256] \
        [--max-frames 16] [--device cpu]

Port of the JAX package's ``sam2_video_predict_example.py`` and
``_example_common.py`` (14.video_interactive_segmentation_training/
sam2_predict_example/): encode frame 0, ``start_track`` with a positive
point, then ``encode_frame`` and ``track_frame`` for each later frame. The
clip is a T x H x W x 3 ``.npy`` array of 0-255 RGB values, or, with
``--synthetic``, the examples' synthetic clip (two discs moving towards
each other over noise, 512 x 512). Each frame's long side is resized to
the model's input size (bilinear) and it is zero-padded to a square, in
[0, 1]. The model is the network at the 14.1 training configs' settings
(1024^2, ``use_high_res_features``, ``head_dim_padding=64``) on seeded
random weights, then the checkpoint if one is given. The point is in the
original frame's pixels; for the synthetic clip it defaults to the first
disc's centre.

Runs on CUDA under bf16 autocast with the attention kernels K1 and K6
(and K2 where a model's heads are not padded); ``--device cpu`` runs fp32
and the kernels' plain versions. Prints one JSON line a frame: the IoU
predictions of the four mask tokens, the best mask's area (pixels with
logit > 0), the object score logit, and the milliseconds of encoding and of
tracking the frame (host clock around work that ends in a synchronise).
"""

import argparse
import json

import numpy as np
import torch

from ..device import resolve_device
from ..engine import init_model
from ..utils.checkpoint import load_sam2_checkpoint
from ..video_interactive_segmentation import models as sam2_models
from ..video_interactive_segmentation.datasets.syntheticdataset import (
    moving_discs)
from .predict_interactive_segmentation import (_timed, compute_context,
                                               prep_canvas)

SEED = 0
SYNTHETIC_SIZE = 512
SYNTHETIC_POINT = (SYNTHETIC_SIZE // 4, SYNTHETIC_SIZE // 2)  # the first disc
NETWORKS = ("sam2_hiera_tiny_video", "sam2_hiera_small_video",
            "sam2_hiera_base_plus_video", "sam2_hiera_large_video")
# the 14.1 training configs' settings (hiera_*/train_config.py)
MODEL_SETTINGS = dict(image_size=1024, use_high_res_features=True,
                      head_dim_padding=64)


def synthetic_clip(frames, size=SYNTHETIC_SIZE):
    """[T, size, size, 3] float32 0-255: noise (0-50) with a disc of radius
    size / 8 (220, 180, 60) moving right from (size / 4, size / 2) and one
    of radius size / 10 (60, 200, 220) moving left from (3 size / 4,
    size / 2), 8 pixels a frame."""
    discs = ((size // 4, size // 2, size // 8, 8, 0, (220.0, 180.0, 60.0)),
             (3 * size // 4, size // 2, size // 10, -8, 0,
              (60.0, 200.0, 220.0)))
    return moving_discs(frames, size, size, discs,
                        np.random.RandomState(0))[0]


def clip_and_prompts(raw, point, image_size, device):
    """The model's canvases of ``raw`` [T, H, W, 3] 0-255 as [T, 3, S, S]
    on ``device``, and frame 0's prompt: ``point`` (x, y on the raw frame)
    scaled to the canvas, a foreground click."""
    canvases = [prep_canvas(frame, image_size) for frame in raw]
    frames = torch.stack([c for c, _ in canvases]).to(device)
    factor = canvases[0][1]
    x, y = point
    prompts = {"prompt_point": torch.tensor([[[x * factor, y * factor, 1.0]]],
                                            device=device)}
    return frames, prompts


def build_model(network, checkpoint="", device=None, **model_kw):
    """The network at the 14.1 configs' settings (``model_kw`` overrides
    any) on ``device`` (CUDA unless the caller asks for the CPU), seeded
    random weights, then the checkpoint if any; the attention takes the
    kernels (``SAM2Video.set_flash_attention`` switches them off)."""
    model = sam2_models.__dict__[network](
        use_flash_attention=True, **{**MODEL_SETTINGS, **model_kw})
    model = init_model(model, SEED, device)
    if checkpoint:
        load_sam2_checkpoint(model, checkpoint)
    return model


def track(model, frames, prompts):
    """Track through ``frames`` [T, 3, S, S] on the model's device: frame 0
    with ``prompts``, every later frame from the memory. Returns ([(masks
    [1, 4, S, S], ious [1, 4], object logits [1, 1]) a frame], [(encode
    ms, track ms) a frame], the last carry)."""
    device = frames.device
    outputs, times = [], []
    carry = None
    with compute_context(device):
        for i in range(frames.shape[0]):
            encoded, encode_ms = _timed(
                lambda: model.encode_frame(frames[i:i + 1]), device)
            feat, pos = encoded[:2]
            highres = encoded[2] if len(encoded) == 3 else None
            if carry is None:
                step = lambda: model.start_track(feat, prompts,
                                                 highres=highres)
            else:
                step = lambda: model.track_frame(feat, pos, carry,
                                                 highres=highres)
            (out, carry), track_ms = _timed(step, device)
            outputs.append(out)
            times.append((encode_ms, track_ms))
    return outputs, times, carry


def argument_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--network", default="sam2_hiera_base_plus_video",
                        choices=NETWORKS)
    parser.add_argument("--checkpoint", default="",
                        help="a SAM2 .pth in the reference torch layout")
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--video",
                        help="T x H x W x 3 .npy array, 0-255 RGB")
    source.add_argument("--synthetic", action="store_true")
    parser.add_argument("--point", default=None, help="x,y on frame 0")
    parser.add_argument("--max-frames", type=int, default=16)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    return parser


def main(argv=None, model_kw=None):
    """Run the tool; ``model_kw`` overrides the network's settings (a test
    cuts the size). Returns a dict with the printed lines, the model, the
    frames, the prompts, the per-frame outputs and the last carry."""
    args = argument_parser().parse_args(argv)
    device = resolve_device(args.device)
    model = build_model(args.network, args.checkpoint, device,
                        **(model_kw or {}))
    if args.synthetic:
        raw, point = synthetic_clip(args.max_frames), SYNTHETIC_POINT
    else:
        raw = np.load(args.video)[:args.max_frames]
        point = (raw.shape[2] / 2, raw.shape[1] / 2)
    if args.point:
        point = [float(v) for v in args.point.split(",")]
    frames, prompts = clip_and_prompts(raw, point, model.image_size, device)

    outputs, times, carry = track(model, frames, prompts)
    lines = []
    for i, ((masks, ious, obj), (encode_ms, track_ms)) in enumerate(
            zip(outputs, times)):
        best = int(ious[0].argmax())
        line = {"frame": i, "network": args.network, "device": str(device),
                "iou_predictions": ious[0].float().cpu().tolist(),
                "mask_area": int((masks[0, best] > 0).sum()),
                "object_score": float(obj[0, 0]),
                "encode_ms": encode_ms, "track_ms": track_ms}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return {"lines": lines, "model": model, "frames": frames,
            "prompts": prompts, "outputs": outputs, "carry": carry}


if __name__ == "__main__":
    main()
