"""SAM-B interactive matting training at 1024^2, multilevel.

The port's counterpart of the JAX experiment
13.interactive_segmentation_training/13.2.sam_matting_training/sam_b_matting_multilevel_training/train_config.py,
with the same values: SAMMatting (SAM-B with gradient checkpointing; its
encoder's attention plain, as the JAX model builds it), the seven matting
losses of ``losses_matting`` at ratio 1, the Deep_Automatic_Portrait_Matting
set, SAMMattingCollater at 1024^2 with 9 points and prompt odds (0.5,
0.25, 0.25), batch 32, AdamW lr 1e-4 with weight decay 1e-4 off the 1-D
parameters, a cosine schedule without warm-up to 1e-6, 30 epochs, bf16
compute. Point ``trained_model_path`` at a checkpoint to start from it; the
dataset root is ``$SIMPLEAICV_DATA_ROOT/human_matting``.

Run from the repository root:
    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.train_interactive_matting_model --work-dir <this dir>
"""

import os

from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    load_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation import (
    losses_matting)
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.datasets.sam_matting_dataset import (
    SAMMattingCollater, SAMMattingDataset)
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.models import (
    sam_b_matting)

human_matting_dataset_path = os.path.join(
    os.environ.get("SIMPLEAICV_DATA_ROOT", "datasets"), "human_matting")


class config:
    network = "sam_b_matting"
    input_image_size = 1024

    model = sam_b_matting(image_size=input_image_size,
                          use_gradient_checkpoint=True)

    trained_model_path = ""
    load_state_dict(trained_model_path, model)

    train_criterion = {
        "GlobalTrimapCELoss": losses_matting.GlobalTrimapCELoss(),
        "GloabelTrimapIouLoss": losses_matting.GloabelTrimapIouLoss(),
        "LocalAlphaLoss": losses_matting.LocalAlphaLoss(),
        "LocalLaplacianLoss": losses_matting.LocalLaplacianLoss(),
        "FusionAlphaLoss": losses_matting.FusionAlphaLoss(),
        "FusionLaplacianLoss": losses_matting.FusionLaplacianLoss(),
        "CompositionLoss": losses_matting.CompositionLoss(),
    }
    loss_ratio = {k: 1.0 for k in train_criterion}

    train_dataset = SAMMattingDataset(
        human_matting_dataset_path,
        set_name_list=("Deep_Automatic_Portrait_Matting",),
        set_type="train")
    test_dataset = None
    train_collater = SAMMattingCollater(resize=input_image_size,
                                        n_points=9,
                                        prompt_probs=(0.5, 0.25, 0.25))
    # all 4 multimask outputs; read by neither train tool, the JAX
    # package's nor this one's (the matting loss takes the best mask's)
    mask_out_idxs = [0, 1, 2, 3]

    seed = 0
    batch_size = 32
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

    epochs = 30
    print_interval = 50
    save_interval = 1

    use_amp = True
    use_ema_model = False
