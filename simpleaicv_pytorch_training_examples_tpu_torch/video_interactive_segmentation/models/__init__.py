from .segment_anything2.sam2 import (SAM2Video, sam2_hiera_base_plus_video,
                                     sam2_hiera_large_video,
                                     sam2_hiera_small_video,
                                     sam2_hiera_tiny_video)
from .segment_anything2.sam2_image import (SAM2Image,
                                           sam2_hiera_base_plus_image,
                                           sam2_hiera_large_image,
                                           sam2_hiera_small_image,
                                           sam2_hiera_tiny_image)
from .segment_anything2_matting import (
    SAM2ImageMatting, SAM2VideoMatting, sam2_hiera_base_plus_image_matting,
    sam2_hiera_base_plus_video_matting, sam2_hiera_large_image_matting,
    sam2_hiera_large_video_matting, sam2_hiera_small_image_matting,
    sam2_hiera_small_video_matting, sam2_hiera_tiny_image_matting,
    sam2_hiera_tiny_video_matting)

__all__ = ["SAM2Video", "sam2_hiera_tiny_video", "sam2_hiera_small_video",
           "sam2_hiera_base_plus_video", "sam2_hiera_large_video",
           "SAM2Image", "sam2_hiera_tiny_image", "sam2_hiera_small_image",
           "sam2_hiera_base_plus_image", "sam2_hiera_large_image",
           "SAM2ImageMatting", "SAM2VideoMatting",
           "sam2_hiera_tiny_image_matting", "sam2_hiera_small_image_matting",
           "sam2_hiera_base_plus_image_matting",
           "sam2_hiera_large_image_matting", "sam2_hiera_tiny_video_matting",
           "sam2_hiera_small_video_matting",
           "sam2_hiera_base_plus_video_matting",
           "sam2_hiera_large_video_matting"]
