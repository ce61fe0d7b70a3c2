"""Image and mask files of the segmentation and matting datasets, read
without cv2.

The JAX package's SAM, SAM2 and matting datasets read their files with
``cv2.imread``; these readers give the same arrays:

- ``read_rgb(path)``: a JPEG through the native libjpeg core
  (``data/native_jpeg.decode_jpeg``: libjpeg's default islow IDCT and
  fancy upsampling, as cv2's libjpeg-turbo decodes it), RGB float32 [H, W,
  3] of 0-255 values (``cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
  .astype(np.float32)``). A file that libjpeg rejects (a PNG named
  ``.jpg``) goes through Pillow.
- ``read_gray(path)``: a PNG mask or matte through Pillow, uint8 [H, W]
  (``cv2.imread(p, cv2.IMREAD_GRAYSCALE)`` of a grayscale file; Pillow's
  "L" conversion of a colour file rounds its luma weights as cv2 does to
  within one level). None where the file is missing or unreadable, as
  ``cv2.imread`` gives.
"""

import os

import numpy as np

__all__ = ["read_rgb", "read_gray"]

_JPEG_MAGIC = b"\xff\xd8"


def read_rgb(path):
    """RGB float32 [H, W, 3] of 0-255 values of an image file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == _JPEG_MAGIC:
        from .native_jpeg import decode_jpeg
        image = decode_jpeg(data, name=path)
        if image is None:
            raise ValueError(f"{path}: libjpeg could not decode it")
    else:
        import io

        from PIL import Image
        with Image.open(io.BytesIO(data)) as im:
            image = np.asarray(im.convert("RGB"))
    return image.astype(np.float32)


def read_gray(path):
    """uint8 [H, W] of a mask or matte file; None where it cannot be
    read."""
    if not os.path.isfile(path):
        return None
    from PIL import Image, UnidentifiedImageError
    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("L"))
    except (OSError, UnidentifiedImageError):
        return None
