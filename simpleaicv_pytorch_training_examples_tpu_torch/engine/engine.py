"""Model set-up, the train step and the classification eval step.

Counterpart of the JAX package's ``engine/engine.py`` (``init_model``,
``apply_pretrained``, ``make_train_step``,
``make_classification_eval_step``).

The train step computes in ``compute_dtype`` over fp32 parameters with no
GradScaler and no ``torch.autocast``: the layers cast for themselves and the
gradients arrive in fp32 on the fp32 parameters. A non-finite loss or
gradient skips the update on the device, through a flag tensor that the
optimizer takes (``utils/optimizers.py``), so no step waits for the host;
the BatchNorm running statistics that the step's forward moved go back to
their values from the step's start, on the device too.
"""

import os

import torch

from ..device import resolve_device
from ..models.common import (attach_mask_generator, batch_stat_buffers,
                             init_parameters_)
from ..parallel.mesh import all_reduce_mean_
from ..utils.ema import ema_update
from ..utils.checkpoint import load_state_dict_filtered, load_torch_state_dict


def init_model(model, seed: int, device=None):
    """Initialise ``model``'s parameters from a generator seeded with
    ``seed``, move it to ``device`` (CUDA unless the caller asks for the
    CPU) and put it in eval mode. Returns the model."""
    device = resolve_device(device)
    init_parameters_(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def apply_pretrained(model, logger=None):
    """Load the torch checkpoint recorded on the model by the config's
    ``load_state_dict`` (name- and shape-filtered, pos-embed resized; a
    model type with a ``load_pretrained(path, logger)`` method, SAM2's,
    loads its own, when the file exists). Returns the model."""
    path = getattr(model, "pretrained_path", "")
    if path and hasattr(model, "load_pretrained"):
        if os.path.isfile(path):
            loaded, total = model.load_pretrained(path, logger)
            if logger:
                logger.info(f"pretrained load: {loaded}/{total} tensors "
                            f"from {path}")
        elif logger:
            logger.info(f"pretrained load: no file at {path}, seeded init")
        return model
    saved = load_torch_state_dict(path)
    if saved is None:
        return model
    excluded = getattr(model, "pretrained_excluded", ())
    saved = {k: v for k, v in saved.items()
             if not any(e in k for e in excluded)}
    loaded, total = load_state_dict_filtered(model, saved, logger)
    if logger:
        logger.info(f"pretrained load: {loaded}/{total} tensors from {path}")
    return model


def mask_seed(seed: int, iteration: int, micro_batch: int) -> int:
    """Seed of the Dropout/DropPath generator for one micro-batch of one
    global iteration: a function of (seed + 7, iteration, micro-batch) alone,
    so a resumed run draws what an uninterrupted one would."""
    mixed = ((seed + 7) * 1000003 + iteration) * 1000003 + micro_batch
    return mixed % (2 ** 63 - 1)


def make_train_step(model, criterion, optimizer, accumulation_steps: int = 1,
                    use_ema_model: bool = False,
                    ema_model_decay: float = 0.9999, ema_params=None,
                    clip_max_norm: float = 0.0, clip_grad_value: float = 0.0,
                    compute_dtype=torch.bfloat16, seed: int = 0,
                    loss_fn=None, host_keys=()):
    """Build ``train_step(batch, iteration) -> metrics``.

    ``batch`` is a dict of tensors whose leading dim splits into
    ``accumulation_steps`` micro-batches; gradients, loss and metrics are
    averaged over them. By default it is {'image': NCHW, 'label': [B] or
    [B, classes]} and the loss is ``criterion(model(image in
    compute_dtype), label)``; ``loss_fn(model, micro_batch, generator) ->
    (loss, {name: 0-dim tensor})`` replaces that for richer batches (SAM's
    prompt loop) and handles its own dtypes. ``iteration`` is the global
    iteration: with the micro-batch index it seeds ``generator``, which
    Dropout and DropPath draw from and which ``loss_fn`` may draw from too.
    The entries named in ``host_keys`` stay where the batch has them (SAM2's
    frame roles, on which ``loss_fn`` branches without waiting for the
    card); the others go to the model's device.
    ``ema_params`` (from ``utils.ema.ema_init``) is updated in place when
    ``use_ema_model``. The model, the optimizer state and the EMA are
    updated in place; ``metrics`` holds 0-dim device tensors: 'loss' and
    each of ``loss_fn``'s metrics (0 on a skipped step) and 'skipped' (1.0
    or 0.0).

    The model's Dropout and DropPath layers are handed the step's generator.
    The finite check comes before clipping and covers the loss and every
    gradient through its L2 norm (a gradient whose squared sum overflows
    fp32 counts as non-finite). On a non-finite step the parameters, the
    optimizer state and its step count keep their values, and so do the
    BatchNorm buffers (running statistics and batch count), which the
    forward moves in training: each micro-batch's forward moves them in
    turn, as the JAX package's scan does, and a skipped step puts back the
    copy taken at its start (``torch.where`` on the flag, no host sync).
    The EMA covers the parameters only, and still averages in the
    (unchanged) parameters on a skipped step.

    In a process group (``parallel/mesh.py``) each rank's batch is its slice
    of the global batch: after the micro-batches the gradients, the loss and
    the metrics are averaged over the world in one bucketed ``all_reduce``,
    before the finite check, clipping and the update, so every rank takes
    the same step or skips it.
    """
    params = list(model.parameters())
    device = params[0].device
    stats = batch_stat_buffers(model)
    stats_at_start = [b.clone() for b in stats]
    generator = torch.Generator(device=device)
    attach_mask_generator(model, generator)
    inv = 1.0 / accumulation_steps

    def default_loss_fn(model, batch, generator):
        return criterion(model(batch["image"].to(compute_dtype)),
                         batch["label"]), {}

    forward = loss_fn if loss_fn is not None else default_loss_fn

    def train_step(batch, iteration):
        model.train()
        batch = {k: v if k in host_keys else v.to(device, non_blocking=True)
                 for k, v in batch.items()}
        micro_batches = [dict(zip(batch, parts)) for parts in zip(
            *(v.chunk(accumulation_steps) for v in batch.values()))]
        for p in params:
            p.grad = None
        if stats:
            torch._foreach_copy_(stats_at_start, stats)
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        metric_sums = {}
        for i, micro in enumerate(micro_batches):
            generator.manual_seed(mask_seed(seed, iteration, i))
            loss, metrics = forward(model, micro, generator)
            loss.backward()
            loss_sum += loss.detach()
            for name, value in metrics.items():
                metric_sums[name] = metric_sums.get(name, 0.0) + \
                    value.detach().float()

        with torch.no_grad():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            if accumulation_steps > 1:
                torch._foreach_mul_(grads, inv)
            loss = loss_sum * inv
            names = sorted(metric_sums)
            summed = [loss] + [metric_sums[n] for n in names]
            all_reduce_mean_(grads + summed)
            metric_sums = dict(zip(names, summed[1:]))
            norms = torch.stack(torch._foreach_norm(grads))
            finite = torch.isfinite(loss) & torch.isfinite(norms).all()
            if clip_max_norm > 0:
                gnorm = torch.linalg.vector_norm(norms)
                scale = torch.clamp(clip_max_norm / (gnorm + 1e-6), max=1.0)
                torch._foreach_mul_(grads, scale)
            if clip_grad_value > 0:
                torch._foreach_clamp_min_(grads, -clip_grad_value)
                torch._foreach_clamp_max_(grads, clip_grad_value)
            optimizer.update(grads, finite)
            if stats:
                torch._foreach_copy_(stats, [
                    torch.where(finite, b, b0)
                    for b, b0 in zip(stats, stats_at_start)])
            if use_ema_model:
                ema_update(ema_params, params, ema_model_decay)
            out = {name: torch.where(finite, value * inv, 0.0)
                   for name, value in metric_sums.items()}
            out["loss"] = torch.where(finite, loss, 0.0)
            out["skipped"] = (~finite).to(torch.float32)
            return out

    return train_step


def make_classification_eval_step(model, topk: int = 5,
                                  compute_dtype=torch.bfloat16,
                                  output_index=None, params=None):
    """Eval step: batch {'image': NCHW, 'label': [B] or soft [B, classes]}
    -> (top-1 bools [B], top-k bools [B], fp32 logits [B, classes]), on the
    model's device. Soft labels count by their argmax; ``output_index``
    picks one output of a model that returns a tuple; ``params`` ({name:
    tensor}, e.g. the EMA's) replace the model's parameters for the call,
    its buffers (the live BatchNorm statistics) staying as they are."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def eval_step(batch):
        model.eval()
        images = batch["image"].to(device, non_blocking=True).to(compute_dtype)
        labels = batch["label"].to(device, non_blocking=True)
        if params is None:
            out = model(images)
        else:
            out = torch.func.functional_call(model, params, (images,))
        if output_index is not None:
            out = out[output_index]
        logits = out.float()
        if labels.ndim == 2:
            labels = labels.argmax(dim=-1)
        top1 = logits.argmax(dim=-1) == labels
        topk_idx = logits.topk(topk, dim=-1).indices
        topk_hit = (topk_idx == labels[:, None]).any(dim=-1)
        return top1, topk_hit, logits

    return eval_step
