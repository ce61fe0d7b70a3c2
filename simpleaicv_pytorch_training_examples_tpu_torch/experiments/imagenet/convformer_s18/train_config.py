"""convformer_s18 on ImageNet-1K.

The port's counterpart of the JAX experiment
00.classification_training/imagenet/convformer_s18/train_config.py, with the
same values (AdamW 2e-3, cosine, 300ep, bs2048, drop_path 0.2, clip_grad_value 1).
The layers compute in bf16 over fp32 parameters (BatchNorm's statistics
and the head in fp32); the JAX config leaves its model's dtype at float32
and rounds only the input to bf16. The ImageNet root is
``$SIMPLEAICV_DATA_ROOT/ILSVRC2012``, the pretrained weights'
``$SIMPLEAICV_PRETRAINED_ROOT``.

Run from the repository root:
    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.train_classification_model --work-dir <this dir>
"""

import os

import torch

from simpleaicv_pytorch_training_examples_tpu_torch.classification import backbones
from simpleaicv_pytorch_training_examples_tpu_torch.classification import losses
from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.ilsvrc2012dataset import ILSVRC2012Dataset
from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    Opencv2PIL, TorchRandomResizedCrop, TorchRandomHorizontalFlip,
    TorchResize, TorchCenterCrop, TorchMeanStdNormalize, RandomErasing,
    ClassificationCollater, load_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.auto_rand_augment import (
    RandAugment)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.mixupcutmixclassificationcollator import (
    MixupCutmixClassificationCollater)
from simpleaicv_pytorch_training_examples_tpu_torch.data import Compose

ILSVRC2012_path = os.path.join(
    os.environ.get("SIMPLEAICV_DATA_ROOT", "datasets"), "ILSVRC2012")
pretrained_models_path = os.environ.get(
    "SIMPLEAICV_PRETRAINED_ROOT",
    os.path.join(os.environ.get("SIMPLEAICV_DATA_ROOT", "datasets"),
                 "pretrained_models"))


class config:
    network = "convformer_s18"
    num_classes = 1000
    input_image_size = 224
    scale = 256 / 224

    # drop_path s18:0.2 s36:0.3 m36:0.4 b36:0.6
    model = backbones.__dict__[network](**{
        "drop_path_prob": 0.2,
        "num_classes": num_classes,
        # mixed precision: fp32 parameters, bf16 layer compute
        "dtype": torch.bfloat16,
    })

    # the official torch weights (the reference names load as they are)
    trained_model_path = os.path.join(
        pretrained_models_path, "convformer_convert_from_pytorch_official_weights/convformer_s18_384_in21ft1k_pytorch_official_weight_convert.pth")
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

    clip_grad_value = 1

    use_amp = True
    use_ema_model = False
    ema_model_decay = 0.9999
