"""Hiera-L encoder -> DINOv3 ViT-B/16 encoder distillation at 1024^2.

The port's counterpart of the JAX experiment
14.video_interactive_segmentation_training/14.0.encoder_distill_training/hiera_l_encoder_distill_dinov3_vit_base_patch16_encoder/train_config.py,
with the same values: a frozen SAM2 Hiera-L image encoder teacher (trunk and
FPN neck, plain attention), a DINOv3 ViT-B/16 student with the SAM
distillation's neck to 256 channels, MSE on the /16 FPN map (64 x 64, the
student's grid, so no resize), the SA-1B sets sa_000020-22 through
SAMCollater at 1024^2, batch 64, AdamW lr 1e-4 with weight decay 1e-4 off
the 1-D parameters (the teacher's lr 0), a cosine schedule without warm-up
to 1e-6, 4 epochs. As in JAX the model computes in fp32 (``use_amp`` rounds
the images to bf16). The dataset root is
``$SIMPLEAICV_DATA_ROOT/interactive_segmentation``.

Run from the repository root:
    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.train_video_interactive_segmentation_distill_encoder_model --work-dir <this dir>
"""

import os

from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    load_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.datasets.sam_segmentation_dataset import (
    SAMCollater, SamSegmentationDataset)
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.distill_losses import (
    MSELoss)
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.distill_model import (
    DINOV3ImageEncoderDistillModel)

interactive_segmentation_dataset_path = os.path.join(
    os.environ.get("SIMPLEAICV_DATA_ROOT", "datasets"),
    "interactive_segmentation")


class config:
    input_image_size = 1024
    freeze_teacher = True

    # Hiera-L trunk (sam2_hiera_large sizes)
    teacher_params = {
        "embedding_planes": 144,
        "head_nums": 2,
        "block_nums": (2, 6, 36, 4),
        "window_specification": (8, 4, 16, 8),
        "global_attention_blocks": (23, 33, 43),
        "fpn_planes": 256,
    }
    teacher_pretrained_path = ""
    student_pretrained_path = ""

    model = DINOV3ImageEncoderDistillModel(
        teacher_params=teacher_params,
        student_backbone_type="dinov3_vit_base_patch16_backbone",
        out_planes=256,
        teacher_pretrained_path=teacher_pretrained_path,
        student_pretrained_path=student_pretrained_path,
        freeze_teacher=freeze_teacher)

    trained_model_path = ""
    load_state_dict(trained_model_path, model)

    train_criterion = MSELoss()

    train_dataset = SamSegmentationDataset(
        interactive_segmentation_dataset_path,
        set_name_list=["sa_000020", "sa_000021", "sa_000022"],
        set_type="train")
    test_dataset = None
    train_collater = SAMCollater(resize=input_image_size, n_points=1,
                                 prompt_probs=(1.0, 0.0, 0.0))

    seed = 0
    batch_size = 64
    num_workers = 32
    accumulation_steps = 1

    optimizer = (
        "AdamW",
        {
            "lr": 1e-4,
            "global_weight_decay": False,
            "weight_decay": 1e-4,
            "no_weight_decay_layer_name_list": [],
        },
    )

    scheduler = (
        "CosineLR",
        {
            "warm_up_epochs": 0,
            "min_lr": 1e-6,
        },
    )

    epochs = 4
    print_interval = 50
    save_interval = 1

    use_amp = True
    use_ema_model = False
