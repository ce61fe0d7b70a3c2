"""Device ms of each kernel of K5's bf16 backward at SAM-B's and SAM-H's
global blocks, for this checkout, timing-only ablations of its source and
another checkout.

    python3 simpleaicv_pytorch_training_examples_tpu_torch/tools/profile_relpos_backward.py \
        [--other DIR] [--ablations]

Each case runs the backward through autograd on a kept graph (q, k, v views
of a packed qkv, rel_h and rel_w fp32, as SAM's attention calls K5) under
``torch.profiler`` and prints one JSON line a turn with the device ms a
backward of every kernel whose name holds ``flash_relpos_bwd`` (the dQ and
dK/dV walks apart). ``--other DIR`` times another checkout's kernels in a
process of its own that imports the package from DIR (for example a parent
unpacked with ``git archive``). ``--ablations`` also builds variants of
this checkout's ``csrc/flash_relpos_bwd.cu`` that each drop one piece of
work (their results are wrong: they are timed, never used) and times them
in turns with the source as it is: ``no_rel_w_tma`` (the dK/dV walk loads
no rel_w tile), ``no_exp`` (no exponentials), ``no_grad_products`` (no dQ,
dK or dV products). The ablations edit the source's text and fail where
that text has changed. Needs a CUDA device.
"""

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

THIS = Path(__file__).resolve().parents[2]
ITERS = 10
# (b, h, kh, kw, d): SAM-B's and SAM-H's global blocks
CASES = {"sam_b": (8, 12, 64, 64, 64), "sam_h_d80": (2, 16, 64, 64, 80)}
ABLATIONS = {
    "no_rel_w_tma": (
        ("        mbar_expect_tx(&bars.full[st], L::kTermsAt);",
         "        mbar_expect_tx(&bars.full[st], 2 * T::kTile);"),
        ("          tma_box(dst + L::kRelAt, &p.w_map, &bars.full[st], 0, 64 * i, "
         "hy, bz);\n", ""),
        ("          tma_box(dst + L::kRelAt + kRelTile / 2, &p.w_map, &bars.full[st], "
         "32, 64 * i, hy, bz);\n", "")),
    "no_exp": (("exp2_approx(", "(0.001f * "),),
    "no_grad_products": (
        ("    times_tile<kBlk, kTail>(acc, acct, a, kt, 64 * chunk);\n", ""),
        ("    times_tile<kBlk, kTail>(dv, dvt, ph, dot, 64 * chunk);\n", ""),
        ("    times_tile<kBlk, kTail>(dk, dkt, dh, qt, 64 * chunk);\n", "")),
}


def kernel_ms(torch, fn):
    """{kernel: device ms a call} of fn's K5 backward kernels."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for event in prof.key_averages():
        found = re.search(r"(flash_relpos_bwd\w*?)[<(]", event.key)
        if found:
            us = getattr(event, "device_time_total", None)
            if us is None:
                us = event.cuda_time_total
            out[found.group(1)] = out.get(found.group(1), 0.0) + us / 1e3 / ITERS
    return out


def backward(torch, fl, b, h, kh, kw, d):
    """A K5 backward of seeded inputs, as a function of no arguments."""
    n = kh * kw
    gen = torch.Generator(device="cuda").manual_seed(30)
    randn = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    qkv = randn(b, n, 3 * h * d).to(torch.bfloat16)
    q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    rel_h, rel_w = randn(b, h, n, kh), randn(b, h, n, kw)
    dout = randn(b, n, h, d).to(torch.bfloat16).transpose(1, 2)
    leaves = [t.detach().requires_grad_() for t in (q, k, v, rel_h, rel_w)]
    out = fl.flash_attention_relpos(*leaves)
    return lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)


def ablation_libraries(build, names):
    """{name: the built variant library}, compiled together under
    build/kernels/ablation_<name>/."""
    source = (build.CSRC_DIR / "flash_relpos_bwd.cu").read_text()
    running = {}
    for name in names:
        text = source
        for old, new in ABLATIONS[name]:
            if old not in text:
                raise SystemExit(f"ablation {name}: the source no longer holds "
                                 f"{old.strip()!r}")
            text = text.replace(old, new)
        folder = build.BUILD_DIR / f"ablation_{name}"
        folder.mkdir(parents=True, exist_ok=True)
        for header in build.CSRC_DIR.glob("*.cuh"):
            shutil.copy(header, folder)
        (folder / "flash_relpos_bwd.cu").write_text(text)
        running[name] = (folder / "lib.so", subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(folder / "lib.so"),
             str(folder / "flash_relpos_bwd.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libraries = {}
    for name, (library, proc) in running.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"ablation {name} did not build:\n{log}")
        libraries[name] = library
    return libraries


def worker(root, ablations):
    """Turns in this process over the package imported from root: the
    source as it is (and its ablations, in turns, there and back)."""
    sys.path.insert(0, str(root))
    import torch
    from simpleaicv_pytorch_training_examples_tpu_torch.ops.kernels import (
        build, flash_attention as fl)
    build.build([n for n in build.SOURCES if n.startswith("flash_")])
    variants = {"as_built": None}
    if ablations:
        entry = fl._bf16_backward()
        for name, library in ablation_libraries(build, ABLATIONS).items():
            fn = ctypes.CDLL(str(library)).saicv_flash_relpos_bwd_bf16
            fn.argtypes, fn.restype = entry.argtypes, entry.restype
            variants[name] = fn
        variants["as_built"] = entry
    order = list(variants) + list(variants)[::-1] if ablations else ["as_built"]
    for case, shape in CASES.items():
        run = backward(torch, fl, *shape)
        for name in order:
            if variants[name] is not None:
                fl._bf16_backward = lambda fn=variants[name]: fn
            print(json.dumps({"root": str(root), "case": case,
                              "variant": name,
                              "kernels_ms": kernel_ms(torch, run)}),
                  flush=True)
        del run
        torch.cuda.empty_cache()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", type=Path,
                        help="another checkout's root, timed first")
    parser.add_argument("--ablations", action="store_true")
    parser.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker is not None:
        worker(args.worker.resolve(), args.ablations)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    roots = ([args.other.resolve()] if args.other else []) + [THIS]
    for root in roots:
        command = [sys.executable, str(Path(__file__).resolve()), "--worker",
                   str(root)] + (["--ablations"] if args.ablations
                                 and root == THIS else [])
        done = subprocess.run(command, cwd=root)
        if done.returncode != 0:
            raise SystemExit(f"the turn in {root} failed")


if __name__ == "__main__":
    main()
