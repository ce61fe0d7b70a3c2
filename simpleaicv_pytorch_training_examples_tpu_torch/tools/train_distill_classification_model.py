"""Distillation training entry point (KD, DML or L2 on a teacher and a
student).

``python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.train_distill_classification_model --work-dir D``
loads ``D/train_config.py``: a ``KDModel``, ``train_criterion`` a dict
{loss name: loss} with weights in ``loss_ratio``, and ``freeze_teacher``.
The cross-entropy losses (``CELoss``, ``OneHotLabelCELoss``) hit the
student, and the teacher too when it is not frozen; the pairwise losses take
(student logits, teacher logits). The step's metrics are ``stu_<loss>``,
``tea_<loss>`` and each pairwise loss by its name; ``loss`` is their sum. A
frozen teacher's lr is set to 0 through ``sub_layer_lr``, so neither the
gradient (it has none) nor weight decay moves it. Each epoch evaluates the
student's top-1 / top-5 (``classification_evaluator(output_index=1)``),
keeps ``best.pth`` by it and writes ``latest.pth`` to resume. Logs to
``D/log/train.log``. One process, one GPU; runs on CUDA unless ``--device
cpu`` (or ``device="cpu"``) asks for the CPU.
"""

import argparse

import torch

from ..engine import classification_evaluator, run_training
from ..utils import load_config_from_work_dir
from .train_classification_model import epoch_summaries

_CE_LOSSES = ("CELoss", "OneHotLabelCELoss")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="train distillation model")
    parser.add_argument("--work-dir", type=str, required=True,
                        help="path to experiment dir with train_config.py")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; CUDA when not given")
    return parser.parse_args(argv)


def build_loss_fn(model, config):
    """``loss_fn(model, batch, generator)`` of one micro-batch: the weighted
    sum of the config's losses and each of them as a metric."""
    criterion = config.train_criterion
    ratios = config.loss_ratio
    freeze = getattr(config, "freeze_teacher", True)
    compute_dtype = torch.bfloat16 if getattr(config, "use_amp", True) \
        else torch.float32

    def loss_fn(model, batch, generator):
        tea_out, stu_out = model(batch["image"].to(compute_dtype))
        label = batch["label"]
        loss_dict = {}
        for name, loss_obj in criterion.items():
            if name in _CE_LOSSES:
                if not freeze:
                    loss_dict["tea_" + name] = loss_obj(tea_out, label) * \
                        ratios[name]
                loss_dict["stu_" + name] = loss_obj(stu_out, label) * \
                    ratios[name]
            else:
                loss_dict[name] = loss_obj(stu_out, tea_out) * ratios[name]
        return sum(loss_dict.values()), loss_dict

    return loss_fn


def freeze_teacher_lr(config):
    """With ``freeze_teacher`` (the default), the optimizer's
    ``sub_layer_lr`` gets ``{'teacher': 0.0}``."""
    if getattr(config, "freeze_teacher", True):
        name, params_dict = config.optimizer
        params_dict = dict(params_dict)
        sub = dict(params_dict.get("sub_layer_lr") or {})
        sub["teacher"] = 0.0
        params_dict["sub_layer_lr"] = sub
        config.optimizer = (name, params_dict)
    return config


def build_eval(model, config, ctx):
    """The student's top-1 / top-5."""
    return classification_evaluator(model, config, ctx, output_index=1)


def main(argv=None, device=None):
    """Train the work dir's teacher and student; returns {'best_top1' (the
    student's), 'resumed_from' (epoch or None), 'model', 'epochs': [{'epoch',
    'loss_avg', '<loss>_avg'..., 'skipped', 'top1', 'top5', ...}, ...]}."""
    args = parse_args(argv)
    config = freeze_teacher_lr(load_config_from_work_dir(args.work_dir,
                                                         "train_config"))
    run = run_training(config, args.work_dir, build_loss_fn=build_loss_fn,
                       build_eval=build_eval,
                       device=device if device is not None else args.device)
    return {"best_top1": run["best_metric"],
            "resumed_from": run["resumed_from"], "model": run["model"],
            "epochs": epoch_summaries(run)}


if __name__ == "__main__":
    main()
