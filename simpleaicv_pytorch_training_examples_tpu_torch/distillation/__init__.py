from . import losses
from .distillmodel import KDModel
