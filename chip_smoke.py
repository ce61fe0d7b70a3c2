"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version at the shapes of the main path, then
drives the main path: full-width ViT-B/16 eval (bf16, global-pool head,
fused attention) through the work-dir eval CLI on seeded random weights and
seeded synthetic images, and full-width ViT-H/14 at reduced depth through
init_model -> make_classification_eval_step -> the DataLoader. Each kernel's
launch counter is set to 0 just before its path runs and read just after.

Prints one line per phase, the ``kernels`` JSON line, the card's name and
power limit, and last ``{"ok": true, "device": {...}}``. Any failed check
raises, so the exit code is not 0 and the last line is not printed. Without
CUDA it exits at once with a message.

Tolerances: kernel vs plain version, bf16 atol 2e-2 (a few bf16 ulps at
|out| <= 2, from rounding P and the output in another order); fp32 atol
1e-4. Model logits, bf16, kernel vs plain attention on the same weights:
max |diff| <= 0.02 * max(1, std of the logits), and top-1 agreement >= 99%.
For that comparison the fc head is set to per-class feature prototypes
(``fit_head``), so top-1 is decided by the features and not by near-ties.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SMOKE_DIR = REPO / "build" / "smoke"

# One H100 SXM at its 700 W limit (NVIDIA data sheet, dense rates).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # tensor cores / FMA
BF16_ATOL, FP32_ATOL = 2e-2, 1e-4
VIT_B_BATCHES, BATCH = 3, 256
VIT_H_DEPTH = 4

VIT_B_CONFIG = """
import torch

from simpleaicv_pytorch_training_examples_tpu_torch.classification import backbones
from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    ClassificationCollater)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.syntheticdataset import (
    SyntheticClassificationDataset)


class config:
    network = "vit_base_patch16"
    num_classes = 1000
    input_image_size = 224
    model = backbones.__dict__[network](
        image_size=input_image_size, global_pool=True,
        num_classes=num_classes, dtype=torch.bfloat16,
        use_fused_attention=True)
    test_dataset = SyntheticClassificationDataset(
        n={n}, image_size=input_image_size, num_classes=num_classes, seed=0)
    test_collater = ClassificationCollater()
    seed = 0
    batch_size = {batch}
    num_workers = 0
"""


def log(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(b, h, n, d, n_real, dtype_name, element_size):
    """Least time (ms) of one attention launch on this card, and what bounds
    it: q and the output in full, k and v for the n_real keys that count,
    against 4*b*h*n*n_real*d operations."""
    nbytes = element_size * b * h * d * (2 * n + 2 * n_real)
    flops = 4.0 * b * h * n * n_real * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def check_kernel(torch, F, fa, name, case, results):
    """Hold one kernel against its plain version at one shape; time both
    and SDPA; append the record to results[name]."""
    dtype = case["dtype"]
    gen = torch.Generator(device="cuda").manual_seed(case["seed"])
    n_real = case.get("n_real")
    if name == "K1":
        b, n, h, d = case["shape"]
        qkv = torch.randn(b, n, 3 * h * d, device="cuda", generator=gen,
                          dtype=torch.float32).to(dtype)
        kernel = lambda: fa.fused_attention_dense(qkv, h, n_real)
        plain = lambda: fa.fused_attention_dense_reference(qkv, h, n_real)
        q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    elif case.get("packed"):  # views of a packed qkv, as attention gives K2
        b, h, n, d = case["shape"]
        qkv = torch.randn(b, n, 3 * h * d, device="cuda", generator=gen,
                          dtype=torch.float32).to(dtype)
        q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    else:
        b, h, n, d = case["shape"]
        q, k, v = (torch.randn(b, h, n, d, device="cuda", generator=gen,
                               dtype=torch.float32).to(dtype)
                   for _ in range(3))
    if name == "K2":
        kernel = lambda: fa.fused_attention(q, k, v, n_real)
        plain = lambda: fa.fused_attention_reference(q, k, v, n_real)
    mask = None
    if n_real is not None:
        mask = (torch.arange(n, device="cuda") < n_real)[None, :]
    library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    out = kernel()
    torch.cuda.synchronize()
    ref = plain()
    err = (out.float() - ref.float()).abs().max().item()
    tol = BF16_ATOL if dtype == torch.bfloat16 else FP32_ATOL
    dtype_name = str(dtype).split(".")[-1]
    bound_ms, bound_by = attention_bound(b, h, n, d,
                                         n if n_real is None else n_real,
                                         dtype_name, out.element_size())
    record = {"case": case["label"], "shape": list(case["shape"]),
              "dtype": dtype_name, "n_real": n_real, "max_abs_err": err,
              "tol": tol, "finite": bool(torch.isfinite(out).all()),
              "ms": time_ms(torch, kernel), "plain_ms": time_ms(torch, plain),
              "library_ms": time_ms(torch, library), "bound_ms": bound_ms,
              "bound_by": bound_by}
    log(f"{name} {case['label']}", **record)
    if not (record["finite"] and err <= tol):
        raise AssertionError(f"{name} {case['label']}: max |kernel - plain| "
                             f"{err} > {tol} or non-finite output")
    results.setdefault(name, []).append(record)


def set_fused_attention(model, on):
    from simpleaicv_pytorch_training_examples_tpu_torch.models.common import (
        MultiHeadSelfAttention)
    for m in model.modules():
        if isinstance(m, MultiHeadSelfAttention):
            m.use_fused_attention = on


def logits_of(torch, eval_step, loader):
    out = [eval_step(batch)[2] for batch in loader]
    torch.cuda.synchronize()
    return torch.cat(out)


def compare_paths(torch, model, loader, label):
    """Logits with the kernels and with plain attention on the same weights;
    returns the kernel logits after checking the agreement."""
    from simpleaicv_pytorch_training_examples_tpu_torch.engine import (
        make_classification_eval_step)
    eval_step = make_classification_eval_step(model)
    set_fused_attention(model, True)
    fused = logits_of(torch, eval_step, loader)
    set_fused_attention(model, False)
    plain = logits_of(torch, eval_step, loader)
    set_fused_attention(model, True)
    diff = (fused - plain).abs().max().item()
    scale = max(1.0, plain.std().item())
    agree = (fused.argmax(-1) == plain.argmax(-1)).float().mean().item()
    log(f"{label} vs plain attention", max_abs_logit_diff=diff,
        logit_std=plain.std().item(), top1_agreement=agree,
        shape=list(fused.shape), finite=bool(torch.isfinite(fused).all()))
    if not (torch.isfinite(fused).all() and diff <= 0.02 * scale
            and agree >= 0.99):
        raise AssertionError(f"{label}: kernel logits disagree with plain "
                             f"attention (max diff {diff}, top-1 {agree})")
    return fused


def fit_head(torch, model, loader):
    """Set the fc head to one prototype per class: the unit-length mean of
    that class's pooled features (the global-pool LayerNorm's output, plain
    attention) less the mean over all images, with the bias that subtracts
    that mean; classes without images get zero. Each image's top-1 is then
    decided by its own features with a wide margin, where the seeded init's
    2e-5 head leaves all 1000 logits within 1e-3 of each other and top-1 is
    a coin toss between near-ties."""
    from simpleaicv_pytorch_training_examples_tpu_torch.engine import (
        make_classification_eval_step)
    feats, labels = [], []
    hook = model.norm.register_forward_hook(
        lambda module, args, out: feats.append(out.float()))
    set_fused_attention(model, False)
    eval_step = make_classification_eval_step(model)
    for batch in loader:
        eval_step(batch)
        labels.append(batch["label"].cuda())
    hook.remove()
    set_fused_attention(model, True)
    feats, labels = torch.cat(feats), torch.cat(labels)
    mean = feats.mean(dim=0)
    protos = torch.zeros_like(model.fc.weight)
    protos.index_add_(0, labels, feats - mean)
    protos = torch.nn.functional.normalize(protos, dim=1)
    with torch.no_grad():
        model.fc.weight.copy_(protos)
        model.fc.bias.copy_(-(protos @ mean))


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "needs an NVIDIA GPU")
    import torch.nn.functional as F

    from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.syntheticdataset import (
        SyntheticClassificationDataset)
    from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
        ClassificationCollater)
    from simpleaicv_pytorch_training_examples_tpu_torch.data import build_loader
    from simpleaicv_pytorch_training_examples_tpu_torch.engine import (
        init_model, make_classification_eval_step)
    from simpleaicv_pytorch_training_examples_tpu_torch.models.backbones.vit import ViT
    from simpleaicv_pytorch_training_examples_tpu_torch.ops.kernels import (
        build, fused_attention as fa)
    from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
        test_classification_model as eval_cli)
    from simpleaicv_pytorch_training_examples_tpu_torch.utils import (
        load_config_from_work_dir)

    # plain fp32 references in full fp32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log("device", name=kind, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)

    # 2. build every kernel from the sources in this checkout
    t0 = time.perf_counter()
    build_logs = build.build()
    built = {n: build.library_path(n).name for n in build.SOURCES}
    ptxas = [line.strip() for text in build_logs.values()
             for line in text.splitlines() if "registers" in line]
    log("build", seconds=round(time.perf_counter() - t0, 2), libraries=built,
        kernels_compiled=len(ptxas),
        max_registers=max((int(l.split("Used ")[1].split()[0])
                           for l in ptxas), default="cached"))

    # 3-4. each kernel against its plain version at the main path's shapes
    bf16, fp32 = torch.bfloat16, torch.float32
    results = {}
    for case in (
            dict(label="vit_b16_eval", shape=(BATCH, 197, 12, 64), dtype=bf16,
                 seed=1),
            dict(label="head_dim_128", shape=(BATCH, 197, 6, 128), dtype=bf16,
                 seed=2),
            dict(label="n_real_150", shape=(BATCH, 197, 12, 64), dtype=bf16,
                 seed=3, n_real=150),
            dict(label="fp32", shape=(8, 197, 12, 64), dtype=fp32, seed=4),
            # K/V too large to stay in shared memory: the streamed pipeline
            dict(label="streamed_n1024", shape=(8, 1024, 2, 128), dtype=bf16,
                 seed=8)):
        check_kernel(torch, F, fa, "K1", case, results)
    for case in (
            dict(label="vit_h14_eval", shape=(BATCH, 16, 257, 80), dtype=bf16,
                 seed=5, packed=True),
            dict(label="n_real_200", shape=(BATCH, 16, 257, 80), dtype=bf16,
                 seed=6, n_real=200),
            dict(label="fp32", shape=(8, 16, 257, 80), dtype=fp32, seed=7),
            # odd head dim: element-wise loads and stores
            dict(label="head_dim_35", shape=(8, 4, 50, 35), dtype=bf16,
                 seed=9)):
        check_kernel(torch, F, fa, "K2", case, results)

    # 5. the slice: ViT-B/16 eval through the work-dir CLI
    work_dir = SMOKE_DIR / "vit_base_patch16"
    work_dir.mkdir(parents=True, exist_ok=True)
    (work_dir / "test_config.py").write_text(VIT_B_CONFIG.format(
        n=VIT_B_BATCHES * BATCH, batch=BATCH))
    fa.fused_attention_dense.launches = 0
    fa.fused_attention.launches = 0
    summary = eval_cli.main(["--work-dir", str(work_dir)])
    launches = {"K1": fa.fused_attention_dense.launches,
                "K2": fa.fused_attention.launches}
    log("vit_b16 eval cli", images=summary["images"],
        images_per_s=summary["images_per_s"], top1=summary["top1"],
        k1_launches=launches["K1"], k2_launches=launches["K2"], card=kind)
    if launches["K1"] != 12 * VIT_B_BATCHES or launches["K2"] != 0:
        raise AssertionError(f"ViT-B/16 path launched K1 {launches['K1']} "
                             f"times, expected {12 * VIT_B_BATCHES}")

    config = load_config_from_work_dir(str(work_dir), "test_config")
    model = init_model(config.model, config.seed)
    loader = build_loader(config.test_dataset, BATCH, config.test_collater,
                          "cuda")
    fit_head(torch, model, loader)
    compare_paths(torch, model, loader, "vit_b16 logits")
    batch = {k: v.cuda() for k, v in next(iter(loader)).items()}
    eval_step = make_classification_eval_step(model)
    step_ms = time_ms(torch, lambda: eval_step(batch), iters=10)
    set_fused_attention(model, False)
    plain_step_ms = time_ms(torch, lambda: eval_step(batch), iters=10)
    set_fused_attention(model, True)
    log("vit_b16 eval step", batch=BATCH, ms=step_ms,
        images_per_s=BATCH / step_ms * 1e3, plain_attention_ms=plain_step_ms,
        k1_share=12 * results["K1"][0]["ms"] / step_ms, card=kind)
    del model, config

    # 6. ViT-H/14 at full width, reduced depth, through the engine
    vit_h = ViT(14, 1280, VIT_H_DEPTH, 16, 4, image_size=224,
                global_pool=True, num_classes=1000, dtype=bf16,
                use_fused_attention=True)
    vit_h = init_model(vit_h, 0)
    loader = build_loader(
        SyntheticClassificationDataset(n=BATCH, image_size=224,
                                       num_classes=1000, seed=1),
        BATCH, ClassificationCollater(), "cuda")
    fa.fused_attention_dense.launches = 0
    fa.fused_attention.launches = 0
    eval_step = make_classification_eval_step(vit_h)
    for batch in loader:
        _, _, logits = eval_step(batch)
    torch.cuda.synchronize()
    launches_h = {"K1": fa.fused_attention_dense.launches,
                  "K2": fa.fused_attention.launches}
    log("vit_h14 eval", reduced=f"depth {VIT_H_DEPTH} of 32 blocks",
        batch=BATCH, k1_launches=launches_h["K1"],
        k2_launches=launches_h["K2"], logits=list(logits.shape))
    if launches_h["K2"] != VIT_H_DEPTH or launches_h["K1"] != 0:
        raise AssertionError(f"ViT-H/14 path launched K2 {launches_h['K2']} "
                             f"times, expected {VIT_H_DEPTH}")
    fit_head(torch, vit_h, loader)
    compare_paths(torch, vit_h, loader, "vit_h14 logits")

    # 7. kernels line
    def entry(name, label, source_fn, launches):
        main_case = results[name][0]
        return {"name": label, "route": "cuda",
                "source": "simpleaicv_pytorch_training_examples_tpu_torch/"
                          "csrc/fused_attention.cu",
                "replaces": source_fn, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in results[name]),
                "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
                "bound_ms": main_case["bound_ms"],
                "bound_by": main_case["bound_by"],
                "library_ms": main_case["library_ms"]}
    pallas = "simpleaicv_pytorch_training_examples_tpu/ops/pallas/"
    kernels = [
        entry("K1", "K1 fused_attention_dense fwd",
              pallas + "fused_attention.py:536", launches["K1"]),
        entry("K2", "K2 fused_attention fwd",
              pallas + "fused_attention.py:121", launches_h["K2"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    main()
