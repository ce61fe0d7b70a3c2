"""Where the device time of one classification eval step goes.

    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.profile_classification_eval \
        [--network vit_base_patch16]

Builds the network at full width on seeded random weights (bf16 compute,
global-pool head, fused attention, as the MAE fine-tune configs), runs
``STEPS`` eval steps of ``BATCH_SIZE`` seeded random 224x224 images under
``torch.profiler`` and prints the
device time per step by kernel category and the top kernels, then one JSON
line with the same numbers. Needs a CUDA device.
"""

import argparse
import json
import time

import torch

from ..classification import backbones
from ..engine import init_model, make_classification_eval_step

# kernel-name fragments -> category, first match wins
CATEGORIES = (
    ("attention kernel", ("attention_fwd",)),
    ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "sm80_")),
    ("convolution", ("conv", "cudnn")),
    ("layer norm", ("layer_norm", "LayerNorm")),
    ("reduction", ("reduce", "Reduce")),
    ("elementwise and casts", ("elementwise", "vectorized", "copy", "Copy",
                               "cat", "CatArray", "fill")),
)
BATCH_SIZE, IMAGE_SIZE, STEPS, SEED = 256, 224, 5, 0


def category(name: str) -> str:
    for label, fragments in CATEGORIES:
        if any(f in name for f in fragments):
            return label
    return "other"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--network", default="vit_base_patch16")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_classification_eval needs a CUDA device")
    model = backbones.__dict__[args.network](
        image_size=IMAGE_SIZE, global_pool=True, num_classes=1000,
        dtype=torch.bfloat16, use_fused_attention=True)
    model = init_model(model, SEED, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = {"image": torch.randn(BATCH_SIZE, 3, IMAGE_SIZE, IMAGE_SIZE,
                                  device="cuda", generator=gen),
             "label": torch.zeros(BATCH_SIZE, dtype=torch.int64,
                                  device="cuda")}
    eval_step = make_classification_eval_step(model)
    for _ in range(3):
        eval_step(batch)
    torch.cuda.synchronize()

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            eval_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS

    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "device_time_total", 0.0)
        if us > 0:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us
    device_ms = sum(kernels.values()) / 1e3 / STEPS
    by_category = {}
    for name, us in kernels.items():
        label = category(name)
        by_category[label] = by_category.get(label, 0.0) + us / 1e3 / STEPS
    device = torch.cuda.get_device_name(0)
    print(f"{args.network} eval bs{BATCH_SIZE} on {device}: "
          f"{wall_ms:.3f} ms/step wall (profiler on), device busy "
          f"{device_ms:.3f} ms/step")
    if device_ms == 0.0:
        print("the profiler recorded no device time: not measured")
        return None
    for label, ms in sorted(by_category.items(), key=lambda kv: -kv[1]):
        print(f"  {label:24s} {ms:9.3f} ms/step  {100 * ms / device_ms:5.1f}%")
    print("  top kernels:")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / 1e3 / STEPS:8.3f} ms/step  {name[:100]}")
    result = {"network": args.network, "batch_size": BATCH_SIZE,
              "device": device, "wall_ms_per_step": wall_ms,
              "device_ms_per_step": device_ms,
              "device_busy_share": device_ms / wall_ms,
              "ms_per_step_by_category": by_category}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
