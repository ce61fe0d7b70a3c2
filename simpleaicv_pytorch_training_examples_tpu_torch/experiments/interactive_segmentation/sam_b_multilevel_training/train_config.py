"""SAM-B interactive segmentation training at 1024^2, multilevel: every one
of the 4 mask outputs supervised.

The port's counterpart of the JAX experiment
13.interactive_segmentation_training/13.1.sam_segmentation_training/sam_b_multilevel_training/train_config.py,
with the same values: SAM-B with gradient checkpointing (full recompute)
and the rel-pos attention kernels, SAMMultiLevelLoss (focal 20, dice 1,
IoU 1, over all 4 mask outputs), the SA-1B sets sa_000020-22, SAMCollater at 1024^2 with 9
points and prompt odds (0.5, 0.25, 0.25), 4 extra decoder passes, batch
160, AdamW lr 1e-4 with weight decay 1e-4 off the 1-D parameters, a cosine
schedule without warm-up to 1e-6, 2 epochs, bf16 compute. Point
``trained_model_path`` at a SAM ``.pth`` in the reference torch layout to
start from it; the dataset root is
``$SIMPLEAICV_DATA_ROOT/interactive_segmentation``.

Run from the repository root:
    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.train_interactive_segmentation_model --work-dir <this dir>
"""

import os

from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    load_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation import losses
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.datasets.sam_segmentation_dataset import (
    SAMCollater, SamSegmentationDataset)
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.models import (
    sam_b)

interactive_segmentation_dataset_path = os.path.join(
    os.environ.get("SIMPLEAICV_DATA_ROOT", "datasets"),
    "interactive_segmentation")


class config:
    network = "sam_b"
    input_image_size = 1024

    model = sam_b(image_size=input_image_size,
                  use_gradient_checkpoint=True,
                  # hand-written rel-pos attention kernels K3 and K5,
                  # forward and backward
                  use_flash_attention=True)

    trained_model_path = ""
    load_state_dict(trained_model_path, model)

    train_criterion = losses.SAMMultiLevelLoss(
        alpha=0.25, gamma=2, focal_loss_weight=20, dice_loss_weight=1,
        iou_predict_loss_weight=1, mask_threshold=0.0)

    train_dataset = SamSegmentationDataset(
        interactive_segmentation_dataset_path,
        set_name_list=["sa_000020", "sa_000021", "sa_000022"],
        set_type="train")
    test_dataset = None
    train_collater = SAMCollater(resize=input_image_size, n_points=9,
                                 prompt_probs=(0.5, 0.25, 0.25))

    decoder_iters = 4
    # read by neither train tool, the JAX package's nor this one's
    mask_out_idxs = [0, 1, 2, 3]

    seed = 0
    batch_size = 160
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

    epochs = 2
    print_interval = 50
    save_interval = 1

    use_amp = True
    use_ema_model = False
