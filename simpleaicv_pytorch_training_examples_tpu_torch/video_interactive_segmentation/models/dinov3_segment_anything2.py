"""DINOv3-encoder SAM2 variants.

Counterpart of the JAX package's ``video_interactive_segmentation/models/
dinov3_segment_anything2.py``: Hiera and its FPN replaced by a DINOv3 ViT
whose /16 grid is brought to SAM2's encoder contract, ([stride-4, -8, -16
features of ``fpn_planes`` channels], their sine positions): two 2x2 / 2
transposed convolutions with a tanh GELU between them (``p2_up1``,
``p2_up2``; Flax's default GELU), one (``p3_up``), and a 1x1 convolution
(``p4_conv``). The prompt encoder, SAM2 decoder, memory attention and
encoder and the matting head are SAM2's. The JAX encoder calls its backbone
in inference mode (no train-time RoPE jitter), so the backbone is built
without the RoPE augmentation; at 1024^2 it has 4,096 tokens and its
attention is the plain one. The transposed convolutions are torch's,
whose kernel is the spatial flip of Flax's (``utils/jax_weights.py``
flips it). Factories: ``dinov3_vit_<size>_sam2_video``,
``..._sam2_image_matting`` and ``..._sam2_video_matting`` for the six
DINOv3 sizes.
"""

import torch.nn.functional as F
from torch import nn

from ...models import backbones as cls_backbones
from ...models.common import ConvTranspose2d
from .segment_anything2.image_encoder import sine_positions_like
from .segment_anything2.sam2 import SAM2Video
from .segment_anything2_matting import SAM2ImageMatting, SAM2VideoMatting

__all__ = ["DINOv3SAM2ImageEncoder"]


class DINOv3SAM2ImageEncoder(nn.Module):
    """[B, 3, H, W] -> ([p2 /4, p3 /8, p4 /16], [their sine positions]),
    NCHW, ``fpn_planes`` channels each."""

    def __init__(self, backbone_type="dinov3_vit_base_patch16_backbone",
                 fpn_planes=256, use_gradient_checkpoint=False):
        super().__init__()
        self.backbone = cls_backbones.__dict__[backbone_type](
            use_gradient_checkpoint=use_gradient_checkpoint,
            rope_rescale_coords=None)
        planes = self.backbone.embedding_planes
        self.p2_up1 = ConvTranspose2d(planes, fpn_planes)
        self.p2_up2 = ConvTranspose2d(fpn_planes, fpn_planes)
        self.p3_up = ConvTranspose2d(planes, fpn_planes)
        self.p4_conv = nn.Conv2d(planes, fpn_planes, 1)

    def forward(self, x):
        grid = self.backbone(x)
        p2 = self.p2_up2(F.gelu(self.p2_up1(grid), approximate="tanh"))
        features = [p2, self.p3_up(grid), self.p4_conv(grid)]
        return features, [sine_positions_like(f) for f in features]


_DINOV3_SAM2_SIZES = (
    "dinov3_vit_small_patch16", "dinov3_vit_small_plus_patch16",
    "dinov3_vit_base_patch16", "dinov3_vit_large_patch16",
    "dinov3_vit_large_plus_patch16", "dinov3_vit_huge_plus_patch16",
)

for _n in _DINOV3_SAM2_SIZES:
    def _video_factory(_n=_n, **kwargs):
        return SAM2Video(image_encoder_type=f"{_n}_backbone", **kwargs)

    def _image_matting_factory(_n=_n, **kwargs):
        return SAM2ImageMatting(image_encoder_type=f"{_n}_backbone",
                                **kwargs)

    def _video_matting_factory(_n=_n, **kwargs):
        return SAM2VideoMatting(image_encoder_type=f"{_n}_backbone",
                                **kwargs)

    globals()[f"{_n}_sam2_video"] = _video_factory
    globals()[f"{_n}_sam2_image_matting"] = _image_matting_factory
    globals()[f"{_n}_sam2_video_matting"] = _video_matting_factory
    __all__ += [f"{_n}_sam2_video", f"{_n}_sam2_image_matting",
                f"{_n}_sam2_video_matting"]
