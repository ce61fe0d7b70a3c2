"""Where the device time of one classification train step goes.

    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.profile_classification_train \
        [--network vit_base_patch16] [--use-fused-norm] [--use-fused-block] \
        [--micro-batches 4] [--drop-path-prob 0.1]

The train step's sibling of ``profile_classification_eval``, with its
categories and report: the network at full width on seeded random weights
(bf16 compute, global-pool head, fused attention, drop path 0.1 unless
``--drop-path-prob`` says otherwise: with ``--use-fused-block`` only the
blocks without a live drop path take K8, all 12 at 0), AdamW
with layer-wise lr decay as the MAE fine-tune config, soft labels, the
batch of 256 split into ``--micro-batches``. Needs a CUDA device.
"""

from types import SimpleNamespace

import torch

from ..classification import losses
from ..engine import make_train_step
from ..utils import build_optimizer
from . import profile_classification_eval as common


def optimizer_config(n_blocks):
    return SimpleNamespace(
        optimizer=("AdamW", {
            "lr": 4e-3, "global_weight_decay": False, "weight_decay": 5e-2,
            "lr_layer_decay": 0.65, "lr_layer_decay_block": n_blocks,
            "block_name": "blocks.",
            "no_weight_decay_layer_name_list": ["pos_embed", "cls_token"]}),
        scheduler=("CosineLR", {"warm_up_epochs": 5, "min_lr": 1e-6}),
        epochs=100)


def main(argv=None):
    parser = common.argument_parser(__doc__.splitlines()[0])
    parser.add_argument("--micro-batches", type=int, default=4)
    parser.add_argument("--drop-path-prob", type=float, default=0.1)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_classification_train needs a CUDA device")
    model = common.build_model(args, drop_path_prob=args.drop_path_prob)
    optimizer, _ = build_optimizer(optimizer_config(len(model.blocks)), model,
                                   100)
    train_step = make_train_step(model, losses.OneHotLabelCELoss(), optimizer,
                                 accumulation_steps=args.micro_batches)
    batch = common.random_batch()
    batch["label"] = torch.nn.functional.one_hot(batch["label"], 1000).float()
    iteration = iter(range(10 ** 6))
    return common.profile_steps(
        lambda: train_step(batch, next(iteration)),
        f"{args.network} train {args.micro_batches} micro-batches",
        {"network": args.network, "use_fused_norm": args.use_fused_norm,
         "use_fused_block": args.use_fused_block,
         "drop_path_prob": args.drop_path_prob,
         "micro_batches": args.micro_batches})


if __name__ == "__main__":
    main()
