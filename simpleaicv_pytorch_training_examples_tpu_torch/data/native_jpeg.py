"""numpy front-end of the native data core (``native/data_core.cpp``).

Counterpart of the JAX package's ``data/native_jpeg.py``: ``decode_jpeg``
and ``decode_jpeg_batch`` decode JPEG files with libjpeg (DCT-domain
prescale for large downscales, bilinear to finish), and
``normalize_into_canvas`` fuses the uint8 -> float32 normalise and the
write into a padded canvas in one native pass.

JPEG data goes through libjpeg only: where the core cannot be built, these
functions raise (``native.lib``). cv2 decodes only bytes that libjpeg
rejects, such as a PNG file, and is imported there; without it that
raises an error naming the file.
"""

import ctypes

import numpy as np

from ..native import lib

__all__ = ["decode_jpeg", "decode_jpeg_batch", "normalize_into_canvas"]


def _cv2_decode(data, max_side, name):
    """RGB uint8 of bytes libjpeg rejected, or None where cv2 cannot read
    them either."""
    try:
        import cv2
    except ImportError as exc:
        raise RuntimeError(f"{name}: not a JPEG file that libjpeg reads, and "
                           f"cv2, which would decode it, is not installed"
                           ) from exc
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        return None
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if max_side and max(img.shape[:2]) != max_side:
        h, w = img.shape[:2]
        f = max_side / max(h, w)
        img = cv2.resize(img, (max(1, int(round(w * f))),
                               max(1, int(round(h * f)))))
    return img


def decode_jpeg(data, max_side=0, name=None):
    """JPEG bytes or a path -> RGB uint8 [H, W, 3]; with ``max_side`` > 0
    scaled so that max(H, W) == max_side. None when neither libjpeg nor cv2
    decodes it. ``name`` names the data in errors (a path names itself)."""
    if isinstance(data, str):
        name = data
        with open(data, "rb") as f:
            data = f.read()
    cdll = lib()
    h = ctypes.c_int()
    w = ctypes.c_int()
    ptr = cdll.saicv_decode_jpeg(data, len(data), int(max_side),
                                 ctypes.byref(h), ctypes.byref(w))
    if not ptr:
        return _cv2_decode(data, max_side, name or "<bytes>")
    try:
        arr = np.ctypeslib.as_array(ptr, shape=(h.value, w.value, 3)).copy()
    finally:
        cdll.saicv_free(ptr)
    return arr


def decode_jpeg_batch(blobs, max_side=0, n_threads=8):
    """List of JPEG bytes -> list of RGB uint8 arrays (None for failures),
    decoded on ``n_threads`` native threads without the GIL; what libjpeg
    rejects goes through ``decode_jpeg`` one by one."""
    cdll = lib()
    n = len(blobs)
    bufs = (ctypes.c_char_p * n)(*blobs)
    lens = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
    outs = (ctypes.POINTER(ctypes.c_uint8) * n)()
    hs = (ctypes.c_int * n)()
    ws = (ctypes.c_int * n)()
    cdll.saicv_decode_jpeg_batch(bufs, lens, n, int(max_side), outs, hs,
                                 ws, int(n_threads))
    images = []
    for i in range(n):
        if outs[i]:
            arr = np.ctypeslib.as_array(
                outs[i], shape=(hs[i], ws[i], 3)).copy()
            cdll.saicv_free(outs[i])
            images.append(arr)
        else:
            images.append(decode_jpeg(blobs[i], max_side,
                                      name=f"<bytes {i} of the batch>"))
    return images


def normalize_into_canvas(img, canvas, scale=1.0 / 255.0,
                          mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0)):
    """Write RGB [h, w, 3] into the float32 canvas [H, W, 3] at the top left
    as (px * scale - mean) / std: one native pass for uint8 pixels and a C
    contiguous canvas, numpy otherwise."""
    h, w = img.shape[:2]
    if (img.ndim != 3 or img.shape[2] != 3 or canvas.ndim != 3
            or canvas.shape[2] != 3 or h > canvas.shape[0]
            or w > canvas.shape[1]):
        raise ValueError(f"image {img.shape} does not fit the canvas "
                         f"{canvas.shape} as RGB")
    if (img.dtype != np.uint8 or canvas.dtype != np.float32
            or not canvas.flags["C_CONTIGUOUS"]):
        canvas[:h, :w] = (img.astype(np.float32) * scale -
                          np.asarray(mean, np.float32)) / \
            np.asarray(std, np.float32)
        return canvas
    cdll = lib()
    img = np.ascontiguousarray(img)
    mean_a = (ctypes.c_float * 3)(*[float(x) for x in mean])
    std_a = (ctypes.c_float * 3)(*[float(x) for x in std])
    cdll.saicv_normalize_into_canvas(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        canvas.shape[0], canvas.shape[1], float(scale), mean_a, std_a)
    return canvas
