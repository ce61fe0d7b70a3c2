"""Device ms of each part of K8, the fused ViT attention block, at ViT-B/16's
train micro-batch ``[64, 197, 768]`` in bf16, forward and backward, for this
checkout and another.

    python3 simpleaicv_pytorch_training_examples_tpu_torch/tools/profile_attn_block.py \
        [--other DIR]

Ten forwards, and ten backwards through autograd on a kept graph, run under
``torch.profiler`` after a warm-up. Each kernel launch is named by its part
of the block: the LayerNorm (``layer_norm``), each GEMM by its product in
launch order (the forward's ``qkv`` and ``proj``; the backward's ``qkv``,
``dattn``, ``dwproj``, ``dwqkv`` and ``dxn``), the attention core
(``attention``: K1's kernels), the column sums, the LayerNorm-parameter
sums and the fixed-order slice reductions (``sums``), the LayerNorm backward
(``ln_backward``), and anything else by its kernel name (the casts of the
gradients to the weights' dtype). Prints one JSON line a checkout and
direction: the device ms a call of each part, each GEMM's TFLOP/s (its
operations from its shape over its device time), the call's total device
ms, and its host ms (the host clock over ten calls enqueued while the card
is held busy, so that no launch waits for the card: what a call costs a
train step that the host paces). ``--other DIR`` first runs the same in a
process of its own that imports the package from DIR (for example a parent
unpacked with ``git archive``), whose kernels build into DIR's
``build/kernels``. Needs a CUDA device.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

THIS = Path(__file__).resolve().parents[2]
ITERS = 10
B, N, H, D = 64, 197, 12, 64
# the products in launch order, with (M, N, K) at [B, N, C]
GEMMS = {"forward": ("qkv", "proj"),
         "backward": ("qkv", "dattn", "dwproj", "dwqkv", "dxn")}
PARTS = (("attn_block_layer_norm", "layer_norm"),
         ("attn_block_ln_backward", "ln_backward"),
         ("attn_block_column_sums", "sums"),
         ("attn_block_ln_param_sums", "sums"),
         ("attn_block_reduce_slices", "sums"),
         ("short_attention", "attention"))


def gemm_mnk(name, m, c):
    return {"qkv": (m, 3 * c, c), "proj": (m, c, c), "dattn": (m, c, c),
            "dwproj": (c, c, m), "dwqkv": (3 * c, c, m),
            "dxn": (m, c, 3 * c)}[name]


def split(torch, fn, direction):
    """{part: device ms a call} of fn's kernels, from torch.profiler over
    ITERS calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    order = GEMMS[direction]
    parts, gemms = {}, 0
    for event in kernels:
        name = event.name
        if "attn_block_gemm" in name:
            part = order[gemms % len(order)]
            gemms += 1
        else:
            part = next((p for key, p in PARTS if key in name),
                        name.split("(")[0][:80])
        us = event.time_range.end - event.time_range.start
        parts[part] = parts.get(part, 0.0) + us / 1e3 / ITERS
    if gemms != len(order) * ITERS:
        raise SystemExit(f"{direction}: {gemms} GEMM launches in {ITERS} "
                         f"calls, expected {len(order)} a call")
    return parts


def host_ms(torch, fn):
    """Host ms a call of fn, ITERS calls enqueued behind a busy card."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(500_000_000)
    start = time.perf_counter()
    for _ in range(ITERS):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return 1e3 * elapsed / ITERS


def worker(root):
    """One checkout: import the package from root, print one JSON line a
    direction."""
    sys.path.insert(0, str(root))
    import torch
    from simpleaicv_pytorch_training_examples_tpu_torch.ops.kernels import (
        attn_block as ab, build)
    build.build(("attn_block",))
    c, m = H * D, B * N
    gen = torch.Generator(device="cuda").manual_seed(30)
    randn = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    bf16 = torch.bfloat16
    inputs = [randn(B, N, c).to(bf16), (randn(3 * c, c) * c ** -0.5).to(bf16),
              (0.02 * randn(3 * c)).to(bf16), (randn(c, c) * c ** -0.5).to(bf16),
              (0.02 * randn(c)).to(bf16), 1.0 + 0.1 * randn(c), 0.1 * randn(c)]
    dy = randn(B, N, c).to(bf16)
    leaves = [t.requires_grad_() for t in inputs]
    out = ab.attn_block(*leaves, H)
    calls = {"forward": lambda: ab.attn_block(*inputs, H),
             "backward": lambda: torch.autograd.grad(out, leaves, dy,
                                                     retain_graph=True)}
    for direction, fn in calls.items():
        with torch.set_grad_enabled(direction == "backward"):
            parts = split(torch, fn, direction)
            host = host_ms(torch, fn)
        tflops = {name: 2.0 * (lambda d: d[0] * d[1] * d[2])(
            gemm_mnk(name, m, c)) / parts[name] / 1e9
            for name in GEMMS[direction]}
        print(json.dumps({
            "root": str(root), "card": torch.cuda.get_device_name(0),
            "shape": [B, N, c], "direction": direction,
            "ms": {k: round(v, 5) for k, v in parts.items()},
            "gemm_ms": round(sum(parts[n] for n in GEMMS[direction]), 5),
            "gemm_tflops": {k: round(v, 1) for k, v in tflops.items()},
            "total_ms": round(sum(parts.values()), 5),
            "host_ms": round(host, 5)}), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", type=Path,
                        help="another checkout's root, profiled first")
    parser.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker is not None:
        worker(args.worker.resolve())
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    roots = ([args.other.resolve()] if args.other else []) + [THIS]
    for root in roots:
        done = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--worker", str(root)], cwd=root)
        if done.returncode != 0:
            raise SystemExit(f"the turn in {root} failed")


if __name__ == "__main__":
    main()
