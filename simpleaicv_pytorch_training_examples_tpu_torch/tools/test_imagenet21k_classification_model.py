"""ImageNet-21K classification eval entry point: flat top-1 / top-5 over
the 21K label space (the semantic levels collapse to the flat labels for
eval), as the classification eval tool.

``python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.test_imagenet21k_classification_model --work-dir D``
"""

from .test_classification_model import main, parse_args  # noqa: F401

if __name__ == "__main__":
    main()
