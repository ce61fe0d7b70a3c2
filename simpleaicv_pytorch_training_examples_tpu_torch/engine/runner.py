"""The generic work-dir training loop and the eval run: one process a GPU,
one process or several (``torchrun``, ``parallel/mesh.py``).

Counterpart of the JAX package's ``engine/runner.py::run_training`` and of
the root ``tools/_test_common.py::run_test``. A task hands ``run_training``
``build_loss_fn(model, config) -> loss_fn`` (see ``engine.make_train_step``)
and, where it evaluates, ``build_eval(model, config, ctx) -> evaluate``
(``engine/evaluators.py``); everything else is shared: the seeded train
loader, the model's seeded init and pretrained load, ``build_optimizer``,
the train step, the EMA, ``CheckpointStore`` (``latest.pth`` to resume,
``best.pth`` for the best epoch) and the log. The best epoch is the
evaluator's best metric (``higher_is_better``), or, without an evaluator,
the one of the lowest mean train loss. The running sums of loss and metrics
stay on the device and are read once per print interval.

Under torchrun each process joins the group (``distributed_init``: NCCL on
``cuda:LOCAL_RANK``, ``gloo`` on the CPU), loads its slice of each global
batch of ``config.batch_size``, which the world size must divide, and
trains the same replica (the train step averages the gradients, BatchNorm
its statistics). The log says ``mesh: N devices``; rank 0 alone logs and
writes checkpoints, and every rank resumes from them.
"""

import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..data import TrainLoader, build_loader
from ..device import resolve_device
from ..parallel.mesh import (distributed_init, is_main_process, rank,
                             world_size)
from ..utils import (build_optimizer, get_logger, load_config_from_work_dir,
                     set_seed)
from ..utils.checkpoint import CheckpointStore
from ..utils.ema import ema_init
from ..utils.flops import compute_flops_and_params
from ..utils.schedules import schedule_value
from .engine import apply_pretrained, init_model, make_train_step


@dataclass
class RunContext:
    """What an evaluator is built with: the eval loader, the logger, the
    device, and the EMA of the parameters (None without EMA)."""
    test_loader: Any
    logger: Any
    device: torch.device
    ema_params: Optional[list] = None


def _log_config(config, log):
    for key, value in sorted(config.__dict__.items()):
        if not key.startswith("__"):
            log(f"config: {key} = {value}")


def _model_params(model, logger):
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model params: {n_params / 1e6:.3f} M")


def _test_loader(config, device):
    """The eval loader of ``config.test_dataset`` (None without one), with
    its ``test_collater``, this rank's slice of each batch; a collater that
    augments never evaluates."""
    if getattr(config, "test_dataset", None) is None:
        return None
    collater = getattr(config, "test_collater", None) or config.train_collater
    if getattr(collater, "augments", False):
        raise ValueError("the collater augments at random: set "
                         "config.test_collater for the eval loader")
    return build_loader(config.test_dataset, config.batch_size, collater,
                        device, num_workers=getattr(config, "num_workers", 8),
                        process_index=rank(), process_count=world_size())


def _run_logger(name, work_dir):
    """The run's logger on rank 0; the other ranks' logs go nowhere."""
    if is_main_process():
        return get_logger(name, os.path.join(work_dir, "log"))
    quiet = logging.getLogger(f"{name}.rank{rank()}")
    quiet.disabled = True
    return quiet


def _ema_state_dict(model, ema_params):
    """The model's state dict with each parameter replaced by its EMA (the
    buffers, BatchNorm's statistics among them, stay the live ones)."""
    state = model.state_dict()
    for (name, _), ema in zip(model.named_parameters(), ema_params):
        state[name] = ema
    return state


def run_training(config, work_dir: str, *, build_loss_fn=None,
                 build_eval=None, higher_is_better=True, device=None,
                 host_keys=()):
    """Train ``config`` in ``work_dir`` (log in ``log/train.log``,
    checkpoints in ``checkpoints/``), resuming from ``latest.pth`` when it
    is there. Returns {'best_metric', 'resumed_from' (epoch or None),
    'model', 'epochs': [{'epoch', 'loss_avg', <metric>_avg..., 'skipped',
    'train_images_per_s', 'seconds', 'loader_wait_seconds',
    'loader_start_seconds', 'first_batch_wait_seconds', 'step_seconds',
    'eval' (the evaluator's values, where it ran)}, ...]} for the epochs
    run in this call; ``loader_wait_seconds`` is the time the loop waited
    for the loader: ``loader_start_seconds`` to start its workers, then
    ``first_batch_wait_seconds`` for the first batch, then the waits for
    each next batch; ``step_seconds`` is the rest of the epoch's training
    time. ``host_keys`` name the batch entries that stay on the host
    (``make_train_step``)."""
    device = distributed_init(resolve_device(device))
    set_seed(config.seed)
    work_dir = os.path.abspath(work_dir)
    logger = _run_logger("train", work_dir)
    log = logger.info
    _log_config(config, log)
    log(f"device: {device}")
    n_devices = world_size()
    log(f"mesh: {n_devices} devices")
    batch_size = config.batch_size
    assert batch_size % n_devices == 0, (
        f"global batch {batch_size} % devices {n_devices} != 0")

    train_loader = TrainLoader(
        config.train_dataset, batch_size, config.train_collater, device,
        seed=config.seed, num_workers=getattr(config, "num_workers", 8),
        process_index=rank(), process_count=n_devices)
    steps_per_epoch = len(train_loader)

    model = init_model(config.model, config.seed, device)
    model = apply_pretrained(model, logger)
    _model_params(model, logger)
    optimizer, group_report = build_optimizer(config, model, steps_per_epoch)
    for group in group_report:
        log(f"param group: lr={group.get('lr')} "
            f"wd={group.get('weight_decay')} n={len(group['name'])}")
    if getattr(config, "use_zero1", False):
        log("zero1: optimizer state sharded over the data axis")

    use_ema = getattr(config, "use_ema_model", False)
    ema_params = ema_init(model.parameters()) if use_ema else None
    compute_dtype = torch.bfloat16 if getattr(config, "use_amp", True) \
        else torch.float32
    train_step = make_train_step(
        model, getattr(config, "train_criterion", None), optimizer,
        accumulation_steps=getattr(config, "accumulation_steps", 1),
        use_ema_model=use_ema,
        ema_model_decay=getattr(config, "ema_model_decay", 0.9999),
        ema_params=ema_params,
        clip_max_norm=getattr(config, "clip_max_norm", 0.0),
        clip_grad_value=getattr(config, "clip_grad_value", 0.0),
        compute_dtype=compute_dtype, seed=config.seed,
        loss_fn=build_loss_fn(model, config) if build_loss_fn else None,
        host_keys=host_keys)
    evaluator = None
    if build_eval is not None:
        evaluator = build_eval(model, config, RunContext(
            _test_loader(config, device), logger, device, ema_params))

    store = CheckpointStore(os.path.join(work_dir, "checkpoints"))
    start_epoch, best_metric, train_hours, resumed_from = 1, None, 0.0, None
    if store.has_latest():
        restored = store.restore_latest(device)
        model.load_state_dict(restored["model_state_dict"])
        optimizer.load_state_dict(restored["optimizer_state_dict"])
        if use_ema:
            saved = restored["ema_state_dict"]
            with torch.no_grad():
                for (name, _), ema in zip(model.named_parameters(),
                                          ema_params):
                    ema.copy_(saved[name])
        resumed_from = int(restored["epoch"])
        start_epoch = resumed_from + 1
        best_metric = restored["best_metric"]
        train_hours = float(restored["train_hours"])
        best = "" if evaluator is None or best_metric is None else \
            f", best {evaluator.metric_name} {best_metric:.3f}"
        log(f"resumed from epoch {resumed_from}{best}")

    scheduler_name, scheduler_params = config.scheduler
    base_lr = config.optimizer[1]["lr"]
    print_interval = getattr(config, "print_interval", 100)
    save_interval = getattr(config, "save_interval", None)
    eval_epochs = getattr(config, "eval_epochs", None)  # None: every epoch
    epochs_run = []
    for epoch in range(start_epoch, config.epochs + 1):
        train_loader.set_epoch(epoch)
        epoch_start = time.perf_counter()
        sums, n_iters, averages, skips = None, 0, {"loss": 0.0}, 0
        batches = iter(train_loader)   # starts the epoch's workers
        loader_start = loader_wait = time.perf_counter() - epoch_start
        for it in range(steps_per_epoch):
            t0 = time.perf_counter()
            batch = next(batches)
            wait = time.perf_counter() - t0
            loader_wait += wait
            if it == 0:
                first_batch_wait = wait
            metrics = train_step(batch, (epoch - 1) * steps_per_epoch + it)
            sums = dict(metrics) if sums is None else {
                k: sums[k] + v for k, v in metrics.items()}
            n_iters += 1
            at_interval = (it + 1) % print_interval == 0
            if at_interval or it + 1 == steps_per_epoch:
                host = {k: v.item() for k, v in sums.items()}
                skips = int(host.pop("skipped"))
                averages = {k: v / max(1, n_iters - skips)
                            for k, v in host.items()}
                if at_interval:
                    lr_now = schedule_value(
                        scheduler_name, scheduler_params, config.epochs,
                        base_lr, (epoch - 1) + it / steps_per_epoch)
                    extra = "".join(f" {k} {v:.4f}" for k, v in
                                    averages.items() if k != "loss")
                    log(f"epoch {epoch} iter {it + 1}/{steps_per_epoch} "
                        f"lr {lr_now:.6f} loss {metrics['loss'].item():.4f} "
                        f"avg {averages['loss']:.4f}{extra} skipped {skips}")
        del batches
        seconds = time.perf_counter() - epoch_start
        train_hours += seconds / 3600.0
        loss_avg = averages["loss"]
        record = {
            "epoch": epoch, "loss_avg": loss_avg, "skipped": skips,
            **{f"{k}_avg": v for k, v in averages.items() if k != "loss"},
            "train_images_per_s": n_iters * batch_size / seconds,
            "seconds": seconds, "loader_wait_seconds": loader_wait,
            "loader_start_seconds": loader_start,
            "first_batch_wait_seconds": first_batch_wait,
            "step_seconds": seconds - loader_wait}

        if evaluator is not None and (eval_epochs is None
                                      or epoch in eval_epochs):
            metric, metric_log, record["eval"] = evaluator()
            log(f"epoch {epoch}: {metric_log} train loss avg "
                f"{loss_avg:.4f} hours {train_hours:.2f}")
            improved = best_metric is None or (
                metric > best_metric if higher_is_better
                else metric < best_metric)
        else:
            log(f"epoch {epoch}: train loss avg {loss_avg:.4f} "
                f"hours {train_hours:.2f}")
            metric = loss_avg if evaluator is None else None
            improved = metric is not None and (best_metric is None
                                               or metric < best_metric)
        epochs_run.append(record)

        if improved:
            best_metric = metric
            if is_main_process():
                store.save_best(_ema_state_dict(model, ema_params) if use_ema
                                else model.state_dict())
        if save_interval is None or epoch % save_interval == 0 \
                or epoch == config.epochs:
            optimizer_state = optimizer.state_dict()   # every rank gathers
            if is_main_process():
                store.save_latest({
                    "model_state_dict": model.state_dict(),
                    "optimizer_state_dict": optimizer_state,
                    "ema_state_dict": (_ema_state_dict(model, ema_params)
                                       if use_ema else None),
                    "epoch": epoch, "best_metric": best_metric,
                    "train_hours": train_hours})

    log(f"done: best metric {best_metric}")
    return {"best_metric": best_metric, "resumed_from": resumed_from,
            "model": model, "epochs": epochs_run}


def _input_shape(config):
    """[1, 3, H, W] of one input: the config's ``input_image_size``, else
    the size of the test set's first image."""
    size = getattr(config, "input_image_size", None)
    if size is None:
        size = config.test_dataset[0]["image"].shape[:2]
    h, w = (size, size) if isinstance(size, int) else size
    return (1, 3, h, w)


def run_test(work_dir: str, build_eval, device=None):
    """Evaluate ``work_dir``'s ``test_config.py`` once: the model
    initialised from the config's seed, its pretrained weights
    (``load_state_dict``) loaded, its FLOPs and parameters counted on one
    image of ``_input_shape`` (``utils/flops.py``), the test
    loader, ``build_eval``'s evaluator. Logs to ``log/test.log``; returns
    ``(metric, log_line, values)``, ``values`` with the evaluator's numbers
    and ``flops`` and ``params``."""
    device = distributed_init(resolve_device(device))
    config = load_config_from_work_dir(work_dir, "test_config")
    set_seed(config.seed)
    logger = _run_logger("test", os.path.abspath(work_dir))
    model = init_model(config.model, config.seed, device)
    model = apply_pretrained(model, logger)
    flops, n_params = compute_flops_and_params(model, _input_shape(config))
    logger.info(f"model params: {n_params / 1e6:.3f} M, flops: "
                f"{flops / 1e9:.3f} G")
    ctx = RunContext(_test_loader(config, device), logger, device)
    metric, metric_log, values = build_eval(model, config, ctx)()
    values = {**values, "flops": flops, "params": n_params}
    rate = values.get("images_per_s")
    logger.info(metric_log + ("" if rate is None else
                              f" images/s {rate:.1f}") + f" on {device}")
    return metric, metric_log, values
