from . import losses
from . import models
