"""SAM encoder distillation models: a frozen SAM ViT teacher encoder and a
student.

Counterpart of the JAX package's ``interactive_segmentation/
distill_model.py``: ``ImageEncoderDistillModel`` distils a SAM ViT encoder
into another, ``DINOV3ImageEncoderDistillModel`` into a DINOv3 backbone
(``student_backbone_type``) with a neck to the teacher's embedding (1x1
conv, LayerNorm2d, 3x3 conv, LayerNorm2d; the convolutions without bias).
``forward`` returns ``(teacher embedding, student embedding)``, NCHW.

A frozen teacher (``freeze_teacher``) stays in eval mode whatever
``train()`` sets and runs under ``torch.no_grad()``, the counterpart of
JAX's ``stop_gradient``; the distill train CLIs also set its lr to 0
(``sub_layer_lr``), so weight decay cannot move it. The teacher keeps its
JAX route: without ``use_flash_attention`` in ``teacher_params`` its
attention is plain.

dtype: the JAX models compute in ``dtype`` (float32 in the configs, which
cast only the images to bf16 with ``use_amp``): the student computes in
``dtype``, the teacher (the port's SAM encoder, which has no dtype of its
own) in fp32, or under bf16 autocast where ``dtype`` is bf16.
"""

import contextlib

import torch
from torch import nn

from ..models import backbones
from ..models.common import Conv2d
from .models.segment_anything.image_encoder import (LayerNorm2d,
                                                    ViTImageEncoder)

__all__ = ["ImageEncoderDistillModel", "DINOV3ImageEncoderDistillModel"]


class _FrozenTeacher(nn.Module):
    """Holds ``teacher`` and the freeze rule shared by the distill models."""

    dtype = torch.float32

    def train(self, mode: bool = True):
        super().train(mode)
        if self.freeze_teacher:
            self.teacher.eval()
        return self

    def compute(self, module, x):
        """``module(x)`` in the model's dtype: fp32 input, or bf16
        autocast."""
        if self.dtype == torch.float32:
            return module(x.float())
        with torch.autocast(x.device.type, dtype=self.dtype):
            return module(x)

    def teacher_forward(self, x):
        grad = contextlib.nullcontext() if not self.freeze_teacher \
            else torch.no_grad()
        with grad:
            return self.teacher_features(x)

    def teacher_features(self, x):
        return self.compute(self.teacher, x)


def _encoder_params(params):
    params = dict(params or {})
    params.pop("inplanes", None)
    return params


class ImageEncoderDistillModel(_FrozenTeacher):

    def __init__(self, teacher_params=None, student_params=None,
                 teacher_pretrained_path="", student_pretrained_path="",
                 freeze_teacher=True, dtype=torch.float32):
        super().__init__()
        self.freeze_teacher = freeze_teacher
        self.dtype = dtype
        self.teacher = ViTImageEncoder(**_encoder_params(teacher_params))
        self.student = ViTImageEncoder(**_encoder_params(student_params))

    def forward(self, x):
        return self.teacher_forward(x), self.compute(self.student, x)


class DINOV3ImageEncoderDistillModel(_FrozenTeacher):
    """The student's neck is ``student_neck_{conv1,ln1,conv2,ln2}`` (the
    JAX package's names), its output at the teacher's grid."""

    def __init__(self, teacher_params=None,
                 student_backbone_type="dinov3_vit_base_patch16_backbone",
                 out_planes=256, teacher_pretrained_path="",
                 student_pretrained_path="", freeze_teacher=True,
                 dtype=torch.float32):
        super().__init__()
        self.freeze_teacher = freeze_teacher
        self.dtype = dtype
        self.teacher = self.build_teacher(teacher_params)
        self.student = backbones.__dict__[student_backbone_type](dtype=dtype)
        planes = self.student.out_channels
        self.student_neck_conv1 = Conv2d(planes, out_planes, 1, bias=False,
                                         dtype=dtype,
                                         init_std=planes ** -0.5)
        self.student_neck_ln1 = LayerNorm2d(out_planes)
        self.student_neck_conv2 = Conv2d(out_planes, out_planes, 3,
                                         padding=1, bias=False, dtype=dtype,
                                         init_std=(9 * out_planes) ** -0.5)
        self.student_neck_ln2 = LayerNorm2d(out_planes)

    @staticmethod
    def build_teacher(teacher_params):
        return ViTImageEncoder(**_encoder_params(teacher_params))

    def student_features(self, x, tea_out):
        stu = self.student(x.to(self.dtype))
        stu = self.student_neck_ln1(self.student_neck_conv1(stu))
        return self.student_neck_ln2(self.student_neck_conv2(stu))

    def forward(self, x):
        tea_out = self.teacher_forward(x)
        return tea_out, self.student_features(x, tea_out)
