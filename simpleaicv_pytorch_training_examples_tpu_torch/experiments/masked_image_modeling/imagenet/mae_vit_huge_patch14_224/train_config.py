"""ViT-H/14 MAE self-supervised pretraining on ImageNet-1K.

The port's counterpart of the JAX experiment
02.masked_image_modeling_training/imagenet/mae_vit_huge_patch14_224/train_config.py,
with the same values: 75% of the patches masked, random resized crop (scale
0.2-1) and flip, pixels / 255, labels normalised per patch, the masked-patch
``MSELoss``, AdamW lr 6e-4 (betas 0.9, 0.95) with weight decay 5e-2, cosine
schedule with 40 warm-up epochs, 400 epochs, batch 1024, 32 loader workers.
The layers compute in bf16 over fp32 parameters (the JAX config leaves its
model's dtype at float32 and rounds only the input to bf16), so the encoder's
attention (head dim 80, 65 tokens) and the decoder's run K2; each block is
checkpointed (``use_gradient_checkpoint``). The ImageNet root is
``$SIMPLEAICV_DATA_ROOT/ILSVRC2012``.

Run from the repository root:
    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.train_mae_self_supervised_model --work-dir <this dir>
"""

import os

import torch

from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    Normalize, Opencv2PIL, TorchRandomHorizontalFlip, TorchRandomResizedCrop,
    load_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.ilsvrc2012dataset import (
    ILSVRC2012Dataset)
from simpleaicv_pytorch_training_examples_tpu_torch.data import Compose
from simpleaicv_pytorch_training_examples_tpu_torch.masked_image_modeling import (
    losses, models)
from simpleaicv_pytorch_training_examples_tpu_torch.masked_image_modeling.common import (
    MAESelfSupervisedPretrainCollater)

ILSVRC2012_path = os.path.join(
    os.environ.get("SIMPLEAICV_DATA_ROOT", "datasets"), "ILSVRC2012")


class config:
    network = "vit_huge_patch14_224_mae_pretrain_model"
    input_image_size = 224

    model = models.__dict__[network](**{
        # mixed precision: fp32 parameters, bf16 layer compute
        "dtype": torch.bfloat16,
        "use_gradient_checkpoint": True,
        # hand-written fused short-N attention kernels, forward and backward
        "use_fused_attention": True,
    })

    trained_model_path = ""
    load_state_dict(trained_model_path, model)

    train_criterion = losses.MSELoss()

    train_dataset = ILSVRC2012Dataset(
        root_dir=ILSVRC2012_path,
        set_name="train",
        transform=Compose([
            Opencv2PIL(),
            TorchRandomResizedCrop(resize=input_image_size,
                                   scale=(0.2, 1.0)),
            TorchRandomHorizontalFlip(prob=0.5),
            Normalize(),
        ]))
    test_dataset = None
    train_collater = MAESelfSupervisedPretrainCollater(
        image_size=input_image_size, patch_size=14, norm_label=True)

    seed = 0
    batch_size = 1024
    num_workers = 32
    accumulation_steps = 1

    optimizer = (
        "AdamW",
        {
            # lr = base_lr:1.5e-4 * batch_size * accumulation_steps / 256
            "lr": 6e-4,
            "global_weight_decay": False,
            "weight_decay": 5e-2,
            "no_weight_decay_layer_name_list": [],
            "beta1": 0.9,
            "beta2": 0.95,
        },
    )

    scheduler = (
        "CosineLR",
        {
            "warm_up_epochs": 40,
            "min_lr": 1e-6,
        },
    )

    epochs = 400
    print_interval = 100

    use_amp = True
    use_ema_model = False
