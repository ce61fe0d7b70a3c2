"""Knowledge-distillation model: a teacher and a student backbone.

Counterpart of the JAX package's ``distillation/distillmodel.py``
(``KDModel``): any two registered classification backbones by name, under
``teacher.`` and ``student.``; ``forward`` returns ``(teacher logits,
student logits)``.

A frozen teacher (``freeze_teacher``) stays in eval mode whatever
``train()`` sets, so its BatchNorm layers normalise by their running
statistics and never move them, and runs under ``torch.no_grad()``, the
counterpart of JAX's ``stop_gradient``: its parameters get no gradient. The
distillation train CLI also sets its lr to 0 (``sub_layer_lr``), so weight
decay cannot move it either. A joint teacher (DML) trains as the student
does and its BatchNorm statistics move.
"""

import torch
from torch import nn

from ..models import backbones

__all__ = ["KDModel"]


class KDModel(nn.Module):

    def __init__(self, teacher_type="resnet34", student_type="resnet18",
                 teacher_pretrained_path="", student_pretrained_path="",
                 freeze_teacher=True, num_classes=1000,
                 use_gradient_checkpoint=False, dtype=torch.float32):
        super().__init__()
        self.teacher_type, self.student_type = teacher_type, student_type
        self.freeze_teacher = freeze_teacher
        self.teacher = backbones.__dict__[teacher_type](
            num_classes=num_classes, dtype=dtype)
        self.student = backbones.__dict__[student_type](
            num_classes=num_classes, dtype=dtype)

    def train(self, mode: bool = True):
        super().train(mode)
        if self.freeze_teacher:
            self.teacher.eval()
        return self

    def forward(self, x):
        if self.freeze_teacher:
            with torch.no_grad():
                tea_out = self.teacher(x)
        else:
            tea_out = self.teacher(x)
        return tea_out, self.student(x)
