from .segment_anything import SAM, sam_b, sam_h, sam_l
from .segment_anything_matting import (SAMMatting, sam_b_matting,
                                       sam_h_matting, sam_l_matting)

__all__ = ["SAM", "sam_b", "sam_l", "sam_h", "SAMMatting", "sam_b_matting",
           "sam_l_matting", "sam_h_matting"]
