"""COCO-compatible RLE mask codec (pure numpy).

pycocotools is not available in this environment; this implements the same
on-disk format so SA-1B/SA-V json annotations and COCO segm results can be
read/written interchangeably (format spec: pycocotools/mask.py — column-
major runs; the compressed form packs counts as 6-bit chunks offset by 48
with delta coding from the second-previous count).
Used by the SA-1B/SA-V preprocessing scripts
(reference SimpleAICV/interactive_segmentation/
interactive_segmentation_dataset_preprocessing/003.resave_sa_1b_image_json
.py etc.).
"""

import numpy as np

__all__ = ["rle_encode", "rle_decode", "rle_to_string", "rle_from_string",
           "mask_to_coco_rle", "coco_rle_to_mask"]


def rle_encode(mask):
    """mask [H,W] {0,1} -> dict(size=[H,W], counts=list) column-major runs
    starting with the zero-run length."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).T.reshape(-1)  # column-major
    # run-length: positions where the value changes
    change = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]]))
    counts = runs.tolist()
    if flat.size and flat[0] == 1:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def rle_decode(rle):
    """dict(size, counts=list) -> mask [H,W] uint8."""
    h, w = rle["size"]
    counts = rle["counts"]
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape(w, h).T


def rle_to_string(counts):
    """counts list -> COCO compressed counts string (6-bit chunks + 48
    offset, delta-coded from the second count on)."""
    out = []
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            chunk = x & 0x1F
            x >>= 5
            # sign-extend check: if remaining bits match the sign of chunk
            more = not (x == 0 and not (chunk & 0x10)
                        or x == -1 and (chunk & 0x10))
            if more:
                chunk |= 0x20
            out.append(chr(chunk + 48))
    return "".join(out)


def rle_from_string(s):
    """COCO compressed counts string -> counts list."""
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * (k + 1))  # sign extension
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def mask_to_coco_rle(mask):
    rle = rle_encode(mask)
    return {"size": rle["size"], "counts": rle_to_string(rle["counts"])}


def coco_rle_to_mask(rle):
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        if isinstance(counts, bytes):
            counts = counts.decode("ascii")
        counts = rle_from_string(counts)
    return rle_decode({"size": rle["size"], "counts": counts})
