"""SAM2 (Hiera) encoder distillation models: a frozen Hiera image encoder
teacher and a student, compared on the /16 FPN map.

Counterpart of the JAX package's ``video_interactive_segmentation/
distill_model.py``: ``ImageEncoderDistillModel`` distils one SAM2
``ImageEncoder`` into another; ``DINOV3ImageEncoderDistillModel`` into a
DINOv3 backbone with the SAM encoder distillation's neck. Both compare the
teacher's last FPN map (``features[-1]``, stride 16). Where the student's
grid differs from the teacher's, its map is resized to the teacher's
bilinearly with half-pixel centres, antialiased when it shrinks
(``jax.image.resize(..., "bilinear")``). The freeze rule and dtypes are
``interactive_segmentation/distill_model.py``'s.
"""

import torch
import torch.nn.functional as F

from ..interactive_segmentation.distill_model import (
    DINOV3ImageEncoderDistillModel as _SAMDINOv3Distill, _FrozenTeacher)
from .models.segment_anything2.image_encoder import ImageEncoder

__all__ = ["ImageEncoderDistillModel", "DINOV3ImageEncoderDistillModel"]


def _last_fpn_map(encoder, x):
    features, _ = encoder(x)
    return features[-1]


class ImageEncoderDistillModel(_FrozenTeacher):

    def __init__(self, teacher_params=None, student_params=None,
                 teacher_pretrained_path="", student_pretrained_path="",
                 freeze_teacher=True, dtype=torch.float32):
        super().__init__()
        self.freeze_teacher = freeze_teacher
        self.dtype = dtype
        self.teacher = ImageEncoder(**dict(teacher_params or {}))
        self.student = ImageEncoder(**dict(student_params or {}))

    def teacher_features(self, x):
        return self.compute(lambda t: _last_fpn_map(self.teacher, t), x)

    def forward(self, x):
        return self.teacher_forward(x), self.compute(
            lambda t: _last_fpn_map(self.student, t), x)


class DINOV3ImageEncoderDistillModel(_SAMDINOv3Distill):

    @staticmethod
    def build_teacher(teacher_params):
        return ImageEncoder(**dict(teacher_params or {}))

    def teacher_features(self, x):
        return self.compute(lambda t: _last_fpn_map(self.teacher, t), x)

    def student_features(self, x, tea_out):
        stu = super().student_features(x, tea_out)
        if stu.shape[-2:] != tea_out.shape[-2:]:
            stu = F.interpolate(stu, size=tea_out.shape[-2:],
                                mode="bilinear", align_corners=False,
                                antialias=True)
        return stu
