"""Where the device time of one classification eval step goes.

    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.profile_classification_eval \
        [--network vit_base_patch16] [--use-fused-norm] [--use-fused-block]

Builds the network at full width on seeded random weights (bf16 compute,
global-pool head, fused attention, as the MAE fine-tune configs), runs
``STEPS`` eval steps of ``BATCH_SIZE`` seeded random 224x224 images under
``torch.profiler`` and prints the
device time per step by kernel category and the top kernels, then one JSON
line with the same numbers. Needs a CUDA device. The train step's sibling,
``profile_classification_train``, shares the categories and the report.
"""

import argparse
import json
import time

import torch

from ..classification import backbones
from ..engine import init_model, make_classification_eval_step

# kernel-name fragments -> category, first match wins; K8's own kernels
# (its GEMMs among them) before "gemm", which would take them for cuBLAS's;
# K8's attention core is K1's device code and counts as the attention kernel
CATEGORIES = (
    ("fused attention block kernel (K8)", ("attn_block_",)),
    ("attention backward kernel", ("attention_bwd",)),
    ("rel-pos flash attention backward kernel (K5)", ("flash_relpos_bwd",)),
    ("rel-pos flash attention kernel (K5)", ("flash_relpos",)),
    ("key-bias flash attention backward kernel (K6)",
     ("flash_keybias_bwd",)),
    ("key-bias flash attention kernel (K6)", ("flash_keybias",)),
    ("attention kernel", ("attention_fwd",)),
    ("layer norm kernel", ("layer_norm_fwd_", "layer_norm_bwd_",
                           "reduce_partials")),
    ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "sm80_")),
    ("convolution", ("conv", "cudnn", "wgrad", "dgrad")),
    ("layer norm", ("layer_norm", "LayerNorm", "GammaBeta")),
    ("optimizer and gradient scaling", ("multi_tensor_apply",)),
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


def argument_parser(description=None):
    parser = argparse.ArgumentParser(
        description=description or __doc__.splitlines()[0])
    parser.add_argument("--network", default="vit_base_patch16")
    parser.add_argument("--use-fused-norm", action="store_true",
                        help="run the blocks' LayerNorms through kernel K7")
    parser.add_argument("--use-fused-block", action="store_true",
                        help="run each block's norm1, attention and residual "
                             "through kernel K8 where it qualifies")
    return parser


def build_model(args, **kwargs):
    model = backbones.__dict__[args.network](
        image_size=IMAGE_SIZE, global_pool=True, num_classes=1000,
        dtype=torch.bfloat16, use_fused_attention=True,
        use_fused_norm=args.use_fused_norm,
        use_fused_block=args.use_fused_block, **kwargs)
    return init_model(model, SEED, "cuda")


def random_batch():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return {"image": torch.randn(BATCH_SIZE, 3, IMAGE_SIZE, IMAGE_SIZE,
                                 device="cuda", generator=gen),
            "label": torch.zeros(BATCH_SIZE, dtype=torch.int64,
                                 device="cuda")}


def profile_steps(step, label, extra=None, batch_size=BATCH_SIZE):
    """Run ``step()`` 3 times to warm up, then ``STEPS`` times under the
    profiler; print and return the device time per step by category and
    the peak device memory of those steps."""
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
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
        key = category(name)
        by_category[key] = by_category.get(key, 0.0) + us / 1e3 / STEPS
    device = torch.cuda.get_device_name(0)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{label} bs{batch_size} on {device}: "
          f"{wall_ms:.3f} ms/step wall (profiler on), device busy "
          f"{device_ms:.3f} ms/step, peak memory {peak_gb:.3f} GB")
    if device_ms == 0.0:
        print("the profiler recorded no device time: not measured")
        return None
    for key, ms in sorted(by_category.items(), key=lambda kv: -kv[1]):
        print(f"  {key:32s} {ms:9.3f} ms/step  {100 * ms / device_ms:5.1f}%")
    print("  top kernels:")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:16]:
        print(f"    {us / 1e3 / STEPS:8.3f} ms/step  {name[:100]}")
    result = dict(extra or {}, label=label, batch_size=batch_size,
                  device=device, wall_ms_per_step=wall_ms,
                  device_ms_per_step=device_ms,
                  device_busy_share=device_ms / wall_ms,
                  peak_memory_gb=peak_gb,
                  ms_per_step_by_category=by_category)
    print(json.dumps(result))
    return result


def main(argv=None):
    args = argument_parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_classification_eval needs a CUDA device")
    eval_step = make_classification_eval_step(build_model(args))
    batch = random_batch()
    return profile_steps(lambda: eval_step(batch), f"{args.network} eval",
                         {"network": args.network,
                          "use_fused_norm": args.use_fused_norm,
                          "use_fused_block": args.use_fused_block})


if __name__ == "__main__":
    main()
