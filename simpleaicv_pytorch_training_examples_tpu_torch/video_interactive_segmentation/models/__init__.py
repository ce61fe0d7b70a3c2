from .segment_anything2.sam2 import (SAM2Video, sam2_hiera_base_plus_video,
                                     sam2_hiera_large_video,
                                     sam2_hiera_small_video,
                                     sam2_hiera_tiny_video)

__all__ = ["SAM2Video", "sam2_hiera_tiny_video", "sam2_hiera_small_video",
           "sam2_hiera_base_plus_video", "sam2_hiera_large_video"]
