"""ResNet-152 on ImageNet-1K with ViT-style augmentation, from the
ImageNet-21K semantic-softmax checkpoint.

The port's counterpart of the JAX experiment
00.classification_training/imagenet/resnet152_vit_aug_imagenet21k_pretrain/train_config.py,
with the same values: random resized crop, flip, ``RandAugment(N=2, M=9)``
(through Pillow), random erasing 0.25, Mixup 0.8 / CutMix 1.0 / label
smoothing 0.1 with ``OneHotLabelCELoss``, AdamW lr 2e-3 with weight decay
5e-2, cosine schedule with 5 warm-up epochs, 300 epochs, batch 2048, 64
loader workers, gradients clipped to norm 1. The layers compute in bf16 over
fp32 parameters (the JAX config leaves its model's dtype at float32 and
rounds only the input to bf16). The starting checkpoint is
``resnet_train_semantic_softmax_on_imagenet21k/resnet152_semantic_softmax.pth``
under ``$SIMPLEAICV_PRETRAINED_ROOT`` (default
``$SIMPLEAICV_DATA_ROOT/pretrained_models``); without the file the model
starts from its seeded init. The ImageNet root is
``$SIMPLEAICV_DATA_ROOT/ILSVRC2012``.

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

_data_root = os.environ.get("SIMPLEAICV_DATA_ROOT", "datasets")
ILSVRC2012_path = os.path.join(_data_root, "ILSVRC2012")
pretrained_models_path = os.environ.get(
    "SIMPLEAICV_PRETRAINED_ROOT", os.path.join(_data_root,
                                               "pretrained_models"))


class config:
    network = "resnet152"
    num_classes = 1000
    input_image_size = 224
    scale = 256 / 224

    model = backbones.__dict__[network](**{
        "num_classes": num_classes,
        # mixed precision: fp32 parameters, bf16 layer compute
        "dtype": torch.bfloat16,
    })

    # imagenet21k semantic-softmax pretrained checkpoint
    trained_model_path = os.path.join(
        pretrained_models_path, "resnet_train_semantic_softmax_on_imagenet21k/resnet152_semantic_softmax.pth")
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
    batch_size = 2048
    num_workers = 64
    accumulation_steps = 1

    optimizer = (
        "AdamW",
        {
            "lr": 2e-3,
            "global_weight_decay": False,
            "weight_decay": 5e-2,
            "no_weight_decay_layer_name_list": [],
        },
    )

    scheduler = (
        "CosineLR",
        {
            "warm_up_epochs": 5,
            "min_lr": 1e-6,
        },
    )

    epochs = 300
    print_interval = 100

    clip_max_norm = 1

    use_amp = True
    use_ema_model = False
    ema_model_decay = 0.9999
