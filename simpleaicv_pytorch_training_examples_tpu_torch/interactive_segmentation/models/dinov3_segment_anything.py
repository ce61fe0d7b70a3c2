"""DINOv3-encoder SAM variants.

Counterpart of the JAX package's ``interactive_segmentation/models/
dinov3_segment_anything.py``: SAM's ViT encoder replaced by a DINOv3 ViT
(``models/backbones/dinov3_vit.py``) and a neck to the 256-channel
embedding (a 1x1 convolution, a channel LayerNorm, a 3x3 convolution, a
channel LayerNorm; ``neck.{0,1,2,3}`` as SAM's neck). The prompt encoder,
mask decoder and matting head are SAM's. The JAX encoder calls its
backbone in inference mode (no train-time RoPE jitter), so the backbone is
built without the RoPE augmentation; at 1024^2 it has 4,096 tokens and
its attention is the plain one, as the JAX backbone routes it. The
factories ``dinov3_vit_<size>_sam`` and ``dinov3_vit_<size>_sam_matting``
build SAM and SAM matting on each of the six DINOv3 sizes.
"""

from torch import nn

from ...models import backbones as cls_backbones
from .segment_anything.image_encoder import LayerNorm2d
from .segment_anything.sam import SAM
from .segment_anything_matting import SAMMatting

__all__ = ["DINOv3SAMImageEncoder"]


class DINOv3SAMImageEncoder(nn.Module):
    """[B, 3, H, W] -> the DINOv3 grid through the neck, [B, out_planes,
    H/16, W/16]."""

    def __init__(self, backbone_type="dinov3_vit_base_patch16_backbone",
                 out_planes=256, use_gradient_checkpoint=False,
                 use_flash_attention=False):
        super().__init__()
        self.backbone = cls_backbones.__dict__[backbone_type](
            use_gradient_checkpoint=use_gradient_checkpoint,
            rope_rescale_coords=None)
        planes = self.backbone.embedding_planes
        self.neck = nn.Sequential(
            nn.Conv2d(planes, out_planes, 1, bias=False),
            LayerNorm2d(out_planes),
            nn.Conv2d(out_planes, out_planes, 3, padding=1, bias=False),
            LayerNorm2d(out_planes))

    def forward(self, x):
        return self.neck(self.backbone(x))


_DINOV3_SAM_SIZES = (
    "dinov3_vit_small_patch16", "dinov3_vit_small_plus_patch16",
    "dinov3_vit_base_patch16", "dinov3_vit_large_patch16",
    "dinov3_vit_large_plus_patch16", "dinov3_vit_huge_plus_patch16",
)

for _n in _DINOV3_SAM_SIZES:
    def _sam_factory(image_size=1024, _n=_n, **kwargs):
        return SAM(image_size=image_size,
                   image_encoder_type=f"{_n}_backbone", **kwargs)

    def _sam_matting_factory(image_size=1024, _n=_n, **kwargs):
        return SAMMatting(image_size=image_size,
                          image_encoder_type=f"{_n}_backbone", **kwargs)

    globals()[f"{_n}_sam"] = _sam_factory
    globals()[f"{_n}_sam_matting"] = _sam_matting_factory
    __all__ += [f"{_n}_sam", f"{_n}_sam_matting"]
