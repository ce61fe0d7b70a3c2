"""SAM-H encoder -> DINOv3 ViT-B/16 encoder distillation at 1024^2.

The port's counterpart of the JAX experiment
13.interactive_segmentation_training/13.0.encoder_distill_training/sam_h_encoder_distill_dinov3_vit_base_patch16_encoder/train_config.py,
with the same values: a frozen SAM-H ViT encoder teacher (plain attention,
as the JAX config sets no ``use_flash_attention``), a DINOv3 ViT-B/16
student with the 1x1 conv / LayerNorm2d / 3x3 conv / LayerNorm2d neck to
256 channels, MSE on the 256 x 64 x 64 embeddings, the SA-1B sets
sa_000020-22 through SAMCollater at 1024^2, batch 64, AdamW lr 1e-4 with
weight decay 1e-4 off the 1-D parameters (the teacher's lr 0), a cosine
schedule without warm-up to 1e-6, 4 epochs. As in JAX the model computes
in fp32 (``use_amp`` rounds the images to bf16). Point
``teacher_pretrained_path`` / ``trained_model_path`` at torch ``.pth``
files to start from them; the dataset root is
``$SIMPLEAICV_DATA_ROOT/interactive_segmentation``. The JAX config's
target distill loss is 0.1412 with the released SAM-H and DINOv3 weights.

Run from the repository root:
    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.train_interactive_segmentation_distill_encoder_model --work-dir <this dir>
"""

import os

from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    load_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.datasets.sam_segmentation_dataset import (
    SAMCollater, SamSegmentationDataset)
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.distill_losses import (
    MSELoss)
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.distill_model import (
    DINOV3ImageEncoderDistillModel)

interactive_segmentation_dataset_path = os.path.join(
    os.environ.get("SIMPLEAICV_DATA_ROOT", "datasets"),
    "interactive_segmentation")


class config:
    input_image_size = 1024
    freeze_teacher = True

    teacher_params = {
        "image_size": input_image_size,
        "patch_size": 16,
        "embedding_planes": 1280,
        "block_nums": 32,
        "head_nums": 16,
        "out_planes": 256,
        "window_size": 14,
        "global_attn_indexes": (7, 15, 23, 31),
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
