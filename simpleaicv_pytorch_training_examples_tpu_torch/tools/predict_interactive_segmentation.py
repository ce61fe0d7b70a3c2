"""Interactive segmentation with SAM: encode each image once, then decode
once per prompt set (a point, a box, the point and the box).

    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.predict_interactive_segmentation \
        --network sam_b [--checkpoint sam_b.pth] (--image image.npy | --synthetic) \
        [--point 512,512] [--box 100,100,800,800] [--batch-size 1] [--device cpu]

Port of the JAX package's ``sam_predict_example.py`` and
``_example_common.py`` (13.interactive_segmentation_training/
sam_predict_example/). The image is an H x W x 3 ``.npy`` array of 0-255
RGB values, or, with ``--synthetic``, the examples' synthetic image (a
bright disc on dark noise, one noise seed per batch element). Its long side
is resized to the model's input size (bilinear, in torch; cv2's
INTER_LINEAR differs from it when shrinking) and it is zero-padded to a
square, in [0, 1]. Without ``--checkpoint`` the weights are seeded random
ones. Prompt coordinates are in the original image's pixels; for the
synthetic image they default to the disc's centre and bounding box.

Runs on CUDA under bf16 autocast with the rel-pos attention kernels K3, K4
and K5; ``--device cpu`` runs fp32 and the kernels' plain versions. The
encoder and each decoder pass run once to warm up, then once timed. Prints
one JSON line per prompt set: the IoU predictions and mask areas (pixels
with logit > 0) of every image and mask token, and the milliseconds of the
encoder and of the decoder.
"""

import argparse
import contextlib
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..engine import init_model
from ..interactive_segmentation import models as sam_models
from ..utils.checkpoint import load_sam_checkpoint

SEED = 0
SYNTHETIC_SIZE = 640
WARMUP = 1  # untimed runs of the encoder and of each decoder pass


def synthetic_image(size=SYNTHETIC_SIZE, seed=0):
    """Dark noise (0-60) with a filled disc of colour (220, 200, 60) and
    radius size / 5 at the centre: [size, size, 3] float32."""
    image = np.random.RandomState(seed).rand(size, size, 3).astype(
        np.float32) * 60
    yy, xx = np.mgrid[:size, :size]
    disc = (xx - size // 2) ** 2 + (yy - size // 2) ** 2 <= (size // 5) ** 2
    image[disc] = (220.0, 200.0, 60.0)
    return image


def prep_canvas(image, resize):
    """H x W x 3 (0-255) -> ([3, resize, resize] in [0, 1], factor): the long
    side resized to ``resize``, zero padding at the bottom and right."""
    h, w = image.shape[:2]
    factor = resize / max(h, w)
    rh, rw = int(round(h * factor)), int(round(w * factor))
    x = torch.from_numpy(np.ascontiguousarray(image, np.float32)).permute(
        2, 0, 1)[None]
    if (rh, rw) != (h, w):
        x = F.interpolate(x, (rh, rw), mode="bilinear", align_corners=False)
    canvas = torch.zeros(3, resize, resize)
    canvas[:, :rh, :rw] = x[0] / 255.0
    return canvas, factor


def prompt_sets(point, box, factor, batch, device):
    """{name: fixed-shape prompts} for the point, the box (if any) and both,
    in canvas coordinates, the same for every image of the batch."""
    pts = torch.tensor([[[point[0] * factor, point[1] * factor, 1.0]]],
                       device=device).expand(batch, 1, 3)
    sets = {"point": {"prompt_point": pts}}
    if box is not None:
        boxes = torch.tensor([[v * factor for v in box]],
                             device=device).expand(batch, 4)
        valid = torch.ones(batch, device=device)
        sets["box"] = {"prompt_box": boxes, "prompt_box_valid": valid}
        sets["point+box"] = {"prompt_point": pts, "prompt_box": boxes,
                             "prompt_box_valid": valid}
    return sets


def build_model(network, checkpoint="", device=None, **model_kw):
    """SAM of the registry's size on ``device`` (CUDA unless the caller
    asks for the CPU), seeded random weights, then the checkpoint if any;
    the encoder's attention takes the kernels (``SAM.set_flash_attention``
    switches them off)."""
    model = sam_models.__dict__[network](use_flash_attention=True,
                                         **model_kw)
    model = init_model(model, SEED, device)
    if checkpoint:
        load_sam_checkpoint(model, checkpoint)
    return model


def _timed(fn, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, (time.perf_counter() - t0) * 1e3


def compute_context(device):
    """bf16 autocast on the card, fp32 on the CPU, no autograd."""
    stack = contextlib.ExitStack()
    stack.enter_context(torch.inference_mode())
    if device.type == "cuda":
        stack.enter_context(torch.autocast("cuda", dtype=torch.bfloat16))
    return stack


def predict(model, images, sets, warmup=WARMUP):
    """Encode ``images`` once and decode each prompt set; each is run
    ``warmup`` times first and the last run is timed. Returns (embedding,
    {name: (mask logits, iou predictions)}, ms of the encoder, {name: ms of
    the decoder})."""
    device = images.device
    with compute_context(device):
        for _ in range(warmup):
            model.forward_image_encoder(images)
        embedding, encoder_ms = _timed(
            lambda: model.forward_image_encoder(images), device)
        outputs, decoder_ms = {}, {}
        for name, prompts in sets.items():
            decode = lambda: model.forward_prompt_encoder_mask_decoder(
                embedding, prompts)
            for _ in range(warmup):
                decode()
            outputs[name], decoder_ms[name] = _timed(decode, device)
    return embedding, outputs, encoder_ms, decoder_ms


def argument_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--network", default="sam_b",
                        choices=("sam_b", "sam_l", "sam_h"))
    parser.add_argument("--checkpoint", default="",
                        help="a SAM .pth in the reference torch layout")
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--image", help="H x W x 3 .npy array, 0-255 RGB")
    source.add_argument("--synthetic", action="store_true")
    parser.add_argument("--point", default=None, help="x,y")
    parser.add_argument("--box", default=None, help="x0,y0,x1,y1")
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    return parser


def _floats(text):
    return [float(v) for v in text.split(",")] if text else None


def main(argv=None, model_kw=None):
    """Run the tool; ``model_kw`` overrides the network's settings (a test
    or a smoke run cuts the size). Returns a dict with the printed lines,
    the model, the images, the embedding, the outputs and the prompts."""
    args = argument_parser().parse_args(argv)
    device = resolve_device(args.device)
    model = build_model(args.network, args.checkpoint, device,
                        **(model_kw or {}))
    b = args.batch_size
    if args.synthetic:
        raw = [synthetic_image(seed=i) for i in range(b)]
        c, r = SYNTHETIC_SIZE // 2, SYNTHETIC_SIZE // 5
        point = _floats(args.point) or [c, c]
        box = _floats(args.box) or [c - r - 8, c - r - 8, c + r + 8, c + r + 8]
    else:
        raw = [np.load(args.image)] * b
        h, w = raw[0].shape[:2]
        point = _floats(args.point) or [w / 2, h / 2]
        box = _floats(args.box)
    canvases = [prep_canvas(image, model.image_size) for image in raw]
    images = torch.stack([c for c, _ in canvases]).to(device)
    sets = prompt_sets(point, box, canvases[0][1], b, device)

    embedding, outputs, encoder_ms, decoder_ms = predict(model, images, sets)
    lines = []
    for name, (masks, ious) in outputs.items():
        line = {"prompt": name, "network": args.network, "batch": b,
                "device": str(device),
                "iou_predictions": ious.float().cpu().tolist(),
                "mask_areas": (masks > 0).sum(dim=(2, 3)).cpu().tolist(),
                "encoder_ms": encoder_ms, "decoder_ms": decoder_ms[name]}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return {"lines": lines, "model": model, "images": images,
            "embedding": embedding, "outputs": outputs, "prompts": sets,
            "encoder_runs": WARMUP + 1,
            "decoder_runs": (WARMUP + 1) * len(sets)}


if __name__ == "__main__":
    main()
