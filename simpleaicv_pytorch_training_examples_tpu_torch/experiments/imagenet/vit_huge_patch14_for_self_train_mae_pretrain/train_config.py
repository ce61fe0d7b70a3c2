"""ViT-H/14 ImageNet-1K fine-tune from a self-trained MAE pre-training.

The port's counterpart of the JAX experiment
00.classification_training/imagenet/vit_huge_patch14_for_self_train_mae_pretrain/train_config.py,
with the same values: drop path 0.3, global-pool head, bf16 compute, fused
attention, Mixup 0.8 / CutMix 1.0 / label smoothing 0.1 with
``OneHotLabelCELoss``, batch 128 in 4 micro-batches, AdamW lr 4e-3 with
weight decay 5e-2 and layer-wise lr decay 0.75 over the 32 blocks, cosine
schedule with 5 warm-up epochs, 50 epochs. The optimizer's name rules are
keyed on the port's parameter names (``blocks.{i}``, ``pos_embed``). Point
``trained_model_path`` at a torch ``.pth`` to start from it (the port's
MAE pretraining writes ``best.pth`` with ``encoder.``-prefixed names, which
this model's names do not match: as in the JAX package, no tensor of it
loads); the ImageNet root is ``$SIMPLEAICV_DATA_ROOT/ILSVRC2012``.

Run from the repository root:
    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.train_classification_model --work-dir <this dir>
"""

import os

import torch

from simpleaicv_pytorch_training_examples_tpu_torch.classification import backbones
from simpleaicv_pytorch_training_examples_tpu_torch.classification import losses
from simpleaicv_pytorch_training_examples_tpu_torch.classification.auto_rand_augment import (
    RandAugment)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    ClassificationCollater, Opencv2PIL, RandomErasing, TorchCenterCrop,
    TorchMeanStdNormalize, TorchRandomHorizontalFlip, TorchRandomResizedCrop,
    TorchResize, load_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.ilsvrc2012dataset import (
    ILSVRC2012Dataset)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.mixupcutmixclassificationcollator import (
    MixupCutmixClassificationCollater)
from simpleaicv_pytorch_training_examples_tpu_torch.data import Compose

ILSVRC2012_path = os.path.join(
    os.environ.get("SIMPLEAICV_DATA_ROOT", "datasets"), "ILSVRC2012")


class config:
    network = "vit_huge_patch14"
    num_classes = 1000
    input_image_size = 224
    scale = 256 / 224

    model = backbones.__dict__[network](**{
        "image_size": input_image_size,
        "drop_path_prob": 0.3,
        "global_pool": True,
        "num_classes": num_classes,
        # mixed precision: fp32 parameters, bf16 layer compute
        "dtype": torch.bfloat16,
        # hand-written fused short-N attention kernels, forward and backward
        "use_fused_attention": True,
    })

    # path to the self-trained MAE encoder checkpoint
    trained_model_path = ""
    load_state_dict(trained_model_path, model)

    train_criterion = losses.__dict__["OneHotLabelCELoss"]()
    test_criterion = losses.__dict__["CELoss"]()

    train_dataset = ILSVRC2012Dataset(
        root_dir=ILSVRC2012_path,
        set_name="train",
        transform=Compose([
            Opencv2PIL(),
            TorchRandomResizedCrop(resize=input_image_size),
            TorchRandomHorizontalFlip(prob=0.5),
            RandAugment(N=2, M=9),
            TorchMeanStdNormalize(mean=[0.485, 0.456, 0.406],
                                  std=[0.229, 0.224, 0.225]),
            RandomErasing(prob=0.25),
        ]))
    test_dataset = ILSVRC2012Dataset(
        root_dir=ILSVRC2012_path,
        set_name="val",
        transform=Compose([
            Opencv2PIL(),
            TorchResize(resize=int(input_image_size * scale)),
            TorchCenterCrop(resize=input_image_size),
            TorchMeanStdNormalize(mean=[0.485, 0.456, 0.406],
                                  std=[0.229, 0.224, 0.225]),
        ]))
    train_collater = MixupCutmixClassificationCollater(
        use_mixup=True,
        mixup_alpha=0.8,
        cutmix_alpha=1.0,
        cutmix_minmax=None,
        mixup_cutmix_prob=1.0,
        switch_to_cutmix_prob=0.5,
        mode="batch",
        correct_lam=True,
        label_smoothing=0.1,
        num_classes=num_classes)
    test_collater = ClassificationCollater()

    seed = 0
    batch_size = 128
    num_workers = 32
    accumulation_steps = 4

    optimizer = (
        "AdamW",
        {
            # lr = base_lr:1e-3 * batch_size * accumulation_steps / 256
            "lr": 4e-3,
            "global_weight_decay": False,
            "weight_decay": 5e-2,
            # ViT layer-wise lr decay (utils/optimizers.py)
            "lr_layer_decay": 0.75,
            "lr_layer_decay_block": 32,
            "block_name": "blocks.",
            "no_weight_decay_layer_name_list": [
                "pos_embed",
                "cls_token",
            ],
        },
    )

    scheduler = (
        "CosineLR",
        {
            "warm_up_epochs": 5,
            "min_lr": 1e-6,
        },
    )

    epochs = 50
    print_interval = 100

    use_amp = True
    use_ema_model = False
    ema_model_decay = 0.9999
