from .sam import SAM, sam_b, sam_h, sam_l
