from .segment_anything import SAM, sam_b, sam_h, sam_l

__all__ = ["SAM", "sam_b", "sam_l", "sam_h"]
