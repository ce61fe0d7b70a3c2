"""The generic work-dir training loop: one process, one GPU.

Counterpart of the JAX package's ``engine/runner.py::run_training``. A task
hands it ``build_loss_fn(model, config) -> loss_fn`` (see
``engine.make_train_step``); everything else is shared: the seeded train
loader, the model's seeded init and pretrained load, ``build_optimizer``,
the train step, ``CheckpointStore`` (``latest.pth`` to resume, ``best.pth``
for the best epoch) and the log. There is no evaluator yet: the best
epoch is the one of the lowest mean train loss (the JAX runner's choice
without an evaluator). The running sums of loss and metrics stay on the device and
are read once per print interval. The classification CLI keeps its own
loop.
"""

import os
import time

import torch

from ..data import TrainLoader
from ..device import resolve_device
from ..utils import build_optimizer, get_logger, set_seed
from ..utils.checkpoint import CheckpointStore
from ..utils.schedules import schedule_value
from .engine import apply_pretrained, init_model, make_train_step


def run_training(config, work_dir: str, *, build_loss_fn=None, device=None,
                 host_keys=()):
    """Train ``config`` in ``work_dir`` (log in ``log/train.log``,
    checkpoints in ``checkpoints/``), resuming from ``latest.pth`` when it
    is there. Returns {'best_metric', 'resumed_from' (epoch or None),
    'model', 'epochs': [{'epoch', 'loss_avg', <metric>_avg..., 'skipped',
    'train_images_per_s', 'seconds'}, ...]} for the epochs run in this
    call. ``host_keys`` name the batch entries that stay on the host
    (``make_train_step``)."""
    device = resolve_device(device)
    set_seed(config.seed)
    work_dir = os.path.abspath(work_dir)
    logger = get_logger("train", os.path.join(work_dir, "log"))
    log = logger.info
    for key, value in sorted(config.__dict__.items()):
        if not key.startswith("__"):
            log(f"config: {key} = {value}")
    log(f"device: {device}")

    batch_size = config.batch_size
    train_loader = TrainLoader(
        config.train_dataset, batch_size, config.train_collater, device,
        seed=config.seed, num_workers=getattr(config, "num_workers", 8))
    steps_per_epoch = len(train_loader)

    model = init_model(config.model, config.seed, device)
    model = apply_pretrained(model, logger)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model params: {n_params / 1e6:.3f} M")
    optimizer, group_report = build_optimizer(config, model, steps_per_epoch)
    for group in group_report:
        log(f"param group: lr={group.get('lr')} "
            f"wd={group.get('weight_decay')} n={len(group['name'])}")

    compute_dtype = torch.bfloat16 if getattr(config, "use_amp", True) \
        else torch.float32
    train_step = make_train_step(
        model, getattr(config, "train_criterion", None), optimizer,
        accumulation_steps=getattr(config, "accumulation_steps", 1),
        clip_max_norm=getattr(config, "clip_max_norm", 0.0),
        clip_grad_value=getattr(config, "clip_grad_value", 0.0),
        compute_dtype=compute_dtype, seed=config.seed,
        loss_fn=build_loss_fn(model, config) if build_loss_fn else None,
        host_keys=host_keys)

    store = CheckpointStore(os.path.join(work_dir, "checkpoints"))
    start_epoch, best_metric, train_hours, resumed_from = 1, None, 0.0, None
    if store.has_latest():
        restored = store.restore_latest(device)
        model.load_state_dict(restored["model_state_dict"])
        optimizer.load_state_dict(restored["optimizer_state_dict"])
        resumed_from = int(restored["epoch"])
        start_epoch = resumed_from + 1
        best_metric = restored["best_metric"]
        train_hours = float(restored["train_hours"])
        log(f"resumed from epoch {resumed_from}")

    scheduler_name, scheduler_params = config.scheduler
    base_lr = config.optimizer[1]["lr"]
    print_interval = getattr(config, "print_interval", 100)
    save_interval = getattr(config, "save_interval", None)
    epochs_run = []
    for epoch in range(start_epoch, config.epochs + 1):
        train_loader.set_epoch(epoch)
        epoch_start = time.time()
        sums, n_iters, averages, skips = None, 0, {"loss": 0.0}, 0
        for it, batch in enumerate(train_loader):
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
                    extra = " ".join(f"{k} {v:.4f}" for k, v in
                                     averages.items() if k != "loss")
                    log(f"epoch {epoch} iter {it + 1}/{steps_per_epoch} "
                        f"lr {lr_now:.6f} loss {metrics['loss'].item():.4f} "
                        f"avg {averages['loss']:.4f} {extra} skipped {skips}")
        seconds = time.time() - epoch_start
        train_hours += seconds / 3600.0
        loss_avg = averages["loss"]
        log(f"epoch {epoch}: train loss avg {loss_avg:.4f} "
            f"hours {train_hours:.2f}")
        epochs_run.append({
            "epoch": epoch, "loss_avg": loss_avg, "skipped": skips,
            **{f"{k}_avg": v for k, v in averages.items() if k != "loss"},
            "train_images_per_s": n_iters * batch_size / seconds,
            "seconds": seconds})

        if best_metric is None or loss_avg < best_metric:
            best_metric = loss_avg
            store.save_best(model.state_dict())
        if save_interval is None or epoch % save_interval == 0 \
                or epoch == config.epochs:
            store.save_latest({
                "model_state_dict": model.state_dict(),
                "optimizer_state_dict": optimizer.state_dict(),
                "epoch": epoch, "best_metric": best_metric,
                "train_hours": train_hours})

    log(f"done: best metric {best_metric}")
    return {"best_metric": best_metric, "resumed_from": resumed_from,
            "model": model, "epochs": epochs_run}
