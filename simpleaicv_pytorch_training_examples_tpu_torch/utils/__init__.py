from .config_loader import load_config_from_work_dir
from .logger import get_logger
from .meters import AccMeter
from .seed import set_seed

__all__ = ["load_config_from_work_dir", "get_logger", "AccMeter", "set_seed"]
