"""SAM2 (Hiera) encoder distillation training entry point (14.0).

``python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.train_video_interactive_segmentation_distill_encoder_model --work-dir D``:
the SAM encoder distillation CLI
(``train_interactive_segmentation_distill_encoder_model``) with a model
from ``video_interactive_segmentation/distill_model.py`` in the config: the
same loss, the frozen teacher's lr 0, the runner. Port of the JAX
package's ``tools/train_video_interactive_segmentation_distill_encoder_
model.py``.
"""

from .train_interactive_segmentation_distill_encoder_model import main as _main


def main(argv=None, device=None):
    return _main(argv, device, "train SAM2 encoder distill model")


if __name__ == "__main__":
    main()
