"""Per-epoch evaluators for the runner (``run_training(build_eval=...)``)
and the eval tools (``run_test``).

Counterpart of the JAX package's ``engine/evaluators.py``. An evaluator is
built by ``build_eval(model, config, ctx)`` (``ctx``: the runner's
``RunContext``) and called with no arguments; it returns ``(metric,
log_line, values)``: the scalar the runner keeps the best epoch by, the
text of the epoch's log line, and a dict of named numbers. Its
``metric_name`` attribute names the metric in the resume line.
"""

import time

import torch
import torch.distributed as dist

from ..parallel.mesh import pad_batch_to_multiple, process_group
from ..utils.meters import AccMeter
from .engine import make_classification_eval_step


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def classification_evaluator(model, config, ctx, output_index=None, topk=5):
    """Top-1 / top-k accuracy (in %) over ``ctx.test_loader``, every image
    counted once, the short last batch too. Soft labels count by their
    argmax; ``output_index`` picks one output of a model that returns a
    tuple (a distillation model's student); with ``use_ema_model`` in
    training the EMA parameters (``ctx.ema_params``) run with the model's
    live BatchNorm statistics (an eval run has no EMA: the weights it
    loaded are evaluated). Values: ``top1``, ``top{topk}``, ``images`` and
    ``images_per_s`` (the eval steps alone, between synchronisations).

    Each batch is padded to a multiple of the first (full) batch's rows
    (``pad_batch_to_multiple``), so every step has one shape, and only its
    real rows count; in a process group each rank evaluates its slice of
    each batch and the counts are summed over the world."""
    compute_dtype = torch.bfloat16 if getattr(config, "use_amp", True) \
        else torch.float32
    use_ema = getattr(config, "use_ema_model", False) \
        and ctx.ema_params is not None
    names = [name for name, _ in model.named_parameters()]

    def evaluate():
        params = dict(zip(names, ctx.ema_params)) if use_ema else None
        eval_step = make_classification_eval_step(
            model, topk, compute_dtype, output_index, params)
        meter, seconds, rows = AccMeter(), 0.0, None
        for batch in ctx.test_loader:
            rows = rows or len(batch["label"])   # the first, full batch's
            batch, n_real = pad_batch_to_multiple(batch, rows)
            batch = {k: v.to(ctx.device, non_blocking=True)
                     for k, v in batch.items()}
            _synchronize(ctx.device)
            t0 = time.perf_counter()
            top1, topk_hit, _ = eval_step(batch)
            _synchronize(ctx.device)
            seconds += time.perf_counter() - t0
            meter.update(top1[:n_real].sum().item(),
                         topk_hit[:n_real].sum().item(), n_real)
        if process_group():
            counts = torch.tensor([meter.correct_num, meter.topk_correct_num,
                                   meter.sample_num], dtype=torch.float64,
                                  device=ctx.device)
            dist.all_reduce(counts)
            meter.correct_num, meter.topk_correct_num, meter.sample_num = (
                int(c) for c in counts.tolist())
        values = {"top1": meter.acc1, f"top{topk}": meter.acc_topk,
                  "images": meter.sample_num,
                  "images_per_s": meter.sample_num / max(seconds, 1e-9)}
        return meter.acc1, (f"top1 {meter.acc1:.3f} "
                            f"top{topk} {meter.acc_topk:.3f}"), values

    evaluate.metric_name = "acc"
    return evaluate
