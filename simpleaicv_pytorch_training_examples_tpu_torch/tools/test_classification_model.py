"""Classification eval entry point.

``python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.test_classification_model --work-dir D``
with a ``test_config.py`` in D naming the model, the test dataset, its
collater and the checkpoint to evaluate. Logs the parameter count and
top-1 / top-k accuracy with images/s. Runs on CUDA unless ``--device cpu``
(or ``device="cpu"``) asks for the CPU.
"""

import argparse
import os
import time

import torch

from ..data import build_loader
from ..device import resolve_device
from ..engine import apply_pretrained, init_model, make_classification_eval_step
from ..utils import AccMeter, get_logger, load_config_from_work_dir, set_seed


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="test classification model")
    parser.add_argument("--work-dir", type=str, required=True)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; CUDA when not given")
    return parser.parse_args(argv)


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, device=None):
    """Evaluate the work dir's model; returns {'top1', 'top5', 'images_per_s',
    'images'} (top-k is top-5)."""
    args = parse_args(argv)
    device = resolve_device(device if device is not None else args.device)
    config = load_config_from_work_dir(args.work_dir, "test_config")
    set_seed(config.seed)
    logger = get_logger("test", os.path.join(args.work_dir, "log"))

    model = init_model(config.model, config.seed, device)
    model = apply_pretrained(model, logger)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model params: {n_params / 1e6:.3f} M")

    eval_step = make_classification_eval_step(model,
                                              compute_dtype=torch.bfloat16)
    loader = build_loader(config.test_dataset, config.batch_size,
                          config.test_collater, device,
                          num_workers=getattr(config, "num_workers", 8))

    acc_meter = AccMeter()
    infer_time = 0.0
    n_images = 0
    for batch in loader:
        batch = {k: v.to(device, non_blocking=True) for k, v in batch.items()}
        _synchronize(device)
        t0 = time.perf_counter()
        top1, topk, _ = eval_step(batch)
        _synchronize(device)
        infer_time += time.perf_counter() - t0
        n = top1.shape[0]
        acc_meter.update(top1.sum().item(), topk.sum().item(), n)
        n_images += n

    images_per_s = n_images / max(infer_time, 1e-9)
    logger.info(f"top1 {acc_meter.acc1:.3f} top5 {acc_meter.acc_topk:.3f} "
                f"images/s {images_per_s:.1f} on {device}")
    return {"top1": acc_meter.acc1, "top5": acc_meter.acc_topk,
            "images_per_s": images_per_s, "images": n_images}


if __name__ == "__main__":
    main()
