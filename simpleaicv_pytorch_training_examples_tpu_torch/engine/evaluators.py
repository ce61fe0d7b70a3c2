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
    ``images_per_s`` (the eval steps alone, between synchronisations)."""
    compute_dtype = torch.bfloat16 if getattr(config, "use_amp", True) \
        else torch.float32
    use_ema = getattr(config, "use_ema_model", False) \
        and ctx.ema_params is not None
    names = [name for name, _ in model.named_parameters()]

    def evaluate():
        params = dict(zip(names, ctx.ema_params)) if use_ema else None
        eval_step = make_classification_eval_step(
            model, topk, compute_dtype, output_index, params)
        meter, seconds = AccMeter(), 0.0
        for batch in ctx.test_loader:
            batch = {k: v.to(ctx.device, non_blocking=True)
                     for k, v in batch.items()}
            _synchronize(ctx.device)
            t0 = time.perf_counter()
            top1, topk_hit, _ = eval_step(batch)
            _synchronize(ctx.device)
            seconds += time.perf_counter() - t0
            meter.update(top1.sum().item(), topk_hit.sum().item(),
                         top1.shape[0])
        values = {"top1": meter.acc1, f"top{topk}": meter.acc_topk,
                  "images": meter.sample_num,
                  "images_per_s": meter.sample_num / max(seconds, 1e-9)}
        return meter.acc1, (f"top1 {meter.acc1:.3f} "
                            f"top{topk} {meter.acc_topk:.3f}"), values

    evaluate.metric_name = "acc"
    return evaluate
