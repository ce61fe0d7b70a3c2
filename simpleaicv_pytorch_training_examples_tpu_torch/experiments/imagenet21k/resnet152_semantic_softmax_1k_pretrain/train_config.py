"""ResNet-152 on ImageNet-21K with the semantic softmax, from an ImageNet-1K
checkpoint.

The port's counterpart of the JAX experiment
00.classification_training/imagenet21k/resnet152_semantic_softmax_1k_pretrain/train_config.py,
with the same values: 10,450 classes, ``SemanticSoftmaxLoss`` over the
dataset's semantic tree (``imagenet21k_miil_tree.pth`` in the data root;
without it a one-level tree), AdamW lr 3e-4 with weight decay 1e-4, cosine
schedule with 1 warm-up epoch, 80 epochs, batch 256, 16 loader workers,
the ImageNet-1K weights loaded without the fc (``trained_model_path``).
The layers compute in bf16 over fp32 parameters (the JAX config leaves its
model's dtype at float32). The data root is
``$SIMPLEAICV_DATA_ROOT/ImageNet21K`` ({train,val}/<wnid>/*.JPEG).

Run from the repository root:
    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.train_imagenet21k_classification_model --work-dir <this dir>
"""

import os

import torch

from simpleaicv_pytorch_training_examples_tpu_torch.classification import (
    backbones, losses)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    ClassificationCollater, Opencv2PIL, TorchCenterCrop, TorchMeanStdNormalize,
    TorchRandomHorizontalFlip, TorchRandomResizedCrop, TorchResize,
    load_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.imagenet21kdataset import (
    ImageNet21KSemanticTreeLabelDataset)
from simpleaicv_pytorch_training_examples_tpu_torch.data import Compose

ImageNet21K_path = os.path.join(
    os.environ.get("SIMPLEAICV_DATA_ROOT", "datasets"), "ImageNet21K")


class config:
    network = "resnet152"
    num_classes = 10450
    input_image_size = 224
    scale = 256 / 224

    model = backbones.__dict__[network](**{
        "num_classes": num_classes,
        "dtype": torch.bfloat16,
    })

    # start from the ImageNet-1K checkpoint, without its fc
    trained_model_path = ""
    load_state_dict(trained_model_path, model, excluded_layer_name=("fc",))

    train_dataset = ImageNet21KSemanticTreeLabelDataset(
        root_dir=ImageNet21K_path, set_name="train",
        transform=Compose([
            Opencv2PIL(),
            TorchRandomResizedCrop(resize=input_image_size),
            TorchRandomHorizontalFlip(prob=0.5),
            TorchMeanStdNormalize(mean=[0.485, 0.456, 0.406],
                                  std=[0.229, 0.224, 0.225]),
        ]))
    test_dataset = ImageNet21KSemanticTreeLabelDataset(
        root_dir=ImageNet21K_path, set_name="val",
        transform=Compose([
            Opencv2PIL(),
            TorchResize(resize=int(input_image_size * scale)),
            TorchCenterCrop(resize=input_image_size),
            TorchMeanStdNormalize(mean=[0.485, 0.456, 0.406],
                                  std=[0.229, 0.224, 0.225]),
        ]))
    train_collater = ClassificationCollater()
    test_collater = ClassificationCollater()

    # the semantic softmax over the tree's levels, weighted by their sizes
    train_criterion = losses.SemanticSoftmaxLoss(
        train_dataset.normalization_factor_list)
    test_criterion = losses.CELoss()

    seed = 0
    batch_size = 256
    num_workers = 16
    accumulation_steps = 1

    optimizer = (
        "AdamW",
        {
            "lr": 3e-4,
            "global_weight_decay": False,
            "weight_decay": 1e-4,
            "no_weight_decay_layer_name_list": [],
        },
    )

    scheduler = (
        "CosineLR",
        {
            "warm_up_epochs": 1,
            "min_lr": 1e-6,
        },
    )

    epochs = 80
    print_interval = 100

    use_amp = True
    use_ema_model = False
    ema_model_decay = 0.9999
