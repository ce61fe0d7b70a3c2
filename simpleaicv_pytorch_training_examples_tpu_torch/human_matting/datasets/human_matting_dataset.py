"""Human matting dataset.

Counterpart of the JAX package's ``human_matting/datasets/
human_matting_dataset.py``: ``root/<set_name>/<set_type>/`` holds pairs of
``image.jpg`` and its alpha matte ``image.png``; the trimap comes from the
alpha (the foreground eroded, the transition band and the erosion's rim
dilated, both with an ellipse of a random size k drawn from
``np.random.randint(*kernel_size_range)``; band 128, foreground 255), and
the foreground and background plates from the image and the alpha.

The JAX dataset erodes and dilates with cv2 and its
``getStructuringElement(MORPH_ELLIPSE, (k, k))``; here
``ellipse_footprint`` builds the same footprint in numpy, and ``erode`` /
``dilate`` apply it as scipy's 1-D minimum and maximum filters
(``mode="nearest"``), one a row of the footprint, with the same result as
cv2's erode and dilate. Files are read without cv2
(``data/image_files.py``). Items are HWC float32 numpy arrays, as in JAX.
"""

import os

import numpy as np
from scipy import ndimage

from ...data.image_files import read_gray, read_rgb

__all__ = ["HumanMattingDataset", "ellipse_footprint"]


def ellipse_footprint(k):
    """cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k)) as a bool [k,
    k] array: row i spans columns c - dx .. c + dx with r = c = k // 2, dy =
    i - r and dx = round(c * sqrt((r^2 - dy^2) / r^2)) (half to even, as
    cv2's saturate_cast)."""
    r = c = k // 2
    out = np.zeros((k, k), bool)
    inv_r2 = 1.0 / (r * r) if r else 0.0
    for i in range(k):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)))
            out[i, max(c - dx, 0):min(c + dx + 1, k)] = True
    return out


def _morph(x, footprint, filter1d, reduce):
    """A min or max filter of ``x`` [H, W] over a footprint whose rows are
    each one run of columns around the centre (an ellipse's), with edge
    values past the border (``mode="nearest"``): each row's run as a 1-D
    filter along W, shifted by the row's offset along H, and reduced over
    the rows. Equal to the 2-D filter with that footprint, at a cost of a
    few 1-D passes."""
    k = footprint.shape[0]
    r = c = k // 2
    rows = np.arange(x.shape[0])
    lines, out = {}, None
    for i in range(k):
        cols = np.nonzero(footprint[i])[0]
        if not len(cols):
            continue
        size = int(cols[-1] - cols[0] + 1)
        origin = c - int(cols[0]) - size // 2
        if (size, origin) not in lines:   # rows i and k - 1 - i share it
            lines[size, origin] = filter1d(x, size, axis=1, mode="nearest",
                                           origin=origin)
        line = lines[size, origin][np.clip(rows + i - r, 0, x.shape[0] - 1)]
        out = line if out is None else reduce(out, line)
    return out


def erode(x, footprint):
    """``cv2.erode(x, footprint)``: the minimum over the footprint."""
    return _morph(x, footprint, ndimage.minimum_filter1d, np.minimum)


def dilate(x, footprint):
    """``cv2.dilate(x, footprint)``: the maximum over the footprint."""
    return _morph(x, footprint, ndimage.maximum_filter1d, np.maximum)


class HumanMattingDataset:

    def __init__(self, root_dir, set_name_list=(), set_type="train",
                 transform=None, kernel_size_range=(10, 20)):
        self.transform = transform
        self.kernel_size_range = kernel_size_range
        pairs = {}
        for set_name in set_name_list:
            set_dir = os.path.join(root_dir, set_name, set_type)
            if not os.path.isdir(set_dir):
                continue
            for name in os.listdir(set_dir):
                if not name.endswith(".jpg"):
                    continue
                mask_path = os.path.join(set_dir,
                                         name.rsplit(".", 1)[0] + ".png")
                if os.path.exists(mask_path):
                    pairs[name] = (os.path.join(set_dir, name), mask_path)
        self.names = sorted(pairs)
        self.pairs = pairs

    def __len__(self):
        return len(self.names)

    def _make_trimap(self, alpha):
        k = np.random.randint(*self.kernel_size_range)
        footprint = ellipse_footprint(k)
        fg = (alpha > 0.95).astype(np.uint8)
        unknown = ((alpha > 0.05) & (alpha <= 0.95)).astype(np.uint8)
        fg_eroded = erode(fg, footprint)
        unknown_dilated = dilate(unknown | (fg - fg_eroded), footprint)
        trimap = np.zeros_like(alpha, np.float32)
        trimap[unknown_dilated > 0] = 128.0
        trimap[fg_eroded > 0] = 255.0
        return trimap

    def __getitem__(self, idx):
        image_path, mask_path = self.pairs[self.names[idx]]
        image = read_rgb(image_path)
        alpha = read_gray(mask_path).astype(np.float32) / 255.0
        trimap = self._make_trimap(alpha)
        sample = {
            "image": image,
            "mask": alpha,
            "trimap": trimap,
            "fg_map": image * alpha[..., None],
            "bg_map": image * (1.0 - alpha[..., None]),
            "size": np.array(image.shape[:2], np.float32),
        }
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
