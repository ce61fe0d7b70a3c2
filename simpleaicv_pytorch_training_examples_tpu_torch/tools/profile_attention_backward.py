"""Device time of each kernel of the short-sequence attention backwards.

    python3 simpleaicv_pytorch_training_examples_tpu_torch/tools/profile_attention_backward.py

Runs the backward cases of ``compare_attention_kernels`` (K1, K2 and K9 at
ViT's shapes, K2b, K3 and K4 at SAM's windows, K8, and K5 at SAM's global
blocks and its off-path shapes) through autograd on a kept graph under
``torch.profiler`` and prints, for each case, the device ms a call of every
kernel it launches (the dQ and dK/dV kernels apart), then each
``short_attention_bwd`` and ``flash_relpos_bwd`` kernel's registers and
spills as ptxas reported them when the library was built. Needs a CUDA
device.
"""

import collections
import itertools
import json
import re
import subprocess
import sys
from pathlib import Path

ITERS = 5


def kernel_ms(torch, fn):
    """{kernel: device ms a call} of ``fn`` over ITERS calls, warmed up."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    out = collections.defaultdict(float)
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0:
            out[re.sub(r"\(.*", "", e.key)] += e.device_time_total / ITERS / 1e3
    return dict(out)


def ptxas_lines(build, source):
    """Registers and spills of each kernel of a source, from the ptxas log
    its build left (empty where the library was built before)."""
    log = build.BUILD_DIR / f"{source}.log"
    if not log.exists():
        return {}
    out, name = {}, None
    for line in log.read_text().splitlines():
        found = re.search(r"(?:Compiling entry function|Function properties for) '?([^' ]+)", line)
        if found:
            name = found.group(1)
        elif name and ("Used" in line or "spill" in line):
            out.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    return out


def main():
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_attention_backward needs a CUDA device")
    from simpleaicv_pytorch_training_examples_tpu_torch.ops.kernels import (
        attn_block as ab, build, flash_attention as fl, fused_attention as fa)
    from simpleaicv_pytorch_training_examples_tpu_torch.tools.compare_attention_kernels import (
        backward_cases, flash_backward_cases)
    build.build()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cases = itertools.chain(backward_cases(torch, fa, ab),
                            flash_backward_cases(torch, fl))
    for name, (kernel, _, _) in cases:
        ms = kernel_ms(torch, kernel)
        print(json.dumps({"case": name, "total_ms": sum(ms.values()),
                          "kernels_ms": ms}), flush=True)
        torch.cuda.empty_cache()
    for source, prefix in (("short_attention_bwd", "short_attention_bwd_d"),
                           ("flash_relpos_bwd", "flash_relpos_bwd_d")):
        for name, lines in ptxas_lines(build, source).items():
            if prefix in name:
                print(json.dumps({"kernel": name, "ptxas": lines}))


if __name__ == "__main__":
    main()
