"""SAM interactive segmentation dataset and prompt collater.

Counterpart of the JAX package's ``interactive_segmentation/datasets/
sam_segmentation_dataset.py``: one item per (image, instance mask) pair
across several sources (capped per source and per image, tiny masks
dropped), and a collater that builds fixed-shape batches with synthesised
prompts: points sampled from the mask's foreground, the mask's box with
noise on its corners, or the mask eroded or dilated and downsampled 4x.

The collater works in NCHW (images ``[B, 3, r, r]`` of 0-255 values as the
JAX collater leaves them, masks ``[B, 1, r, r]``, prompt masks
``[B, 1, r/4, r/4]``) and draws from the global ``np.random`` in the JAX
collater's order, so both give the same batch from one seed. It resizes
with torch and erodes and dilates with scipy, where the JAX package calls
cv2: bilinear ``F.interpolate`` (half-pixel centres) equals cv2's
INTER_LINEAR for the 4x mask downsample and its image upsampling to float
rounding, ``mode="nearest"`` equals INTER_NEAREST, and scipy's
``minimum_filter`` / ``maximum_filter`` over a k x k box with
``mode="nearest"`` equal ``cv2.erode`` / ``cv2.dilate`` with a k x k kernel
for odd and even k. The dataset reads its files without cv2
(``data/image_files.py``: JPEG images through the native libjpeg core, PNG
masks through Pillow).

Disk layouts: ``root/<set>/<type>/`` with ``image.jpg`` and
``image_mask<k>.png`` files, or with ``image.jpg`` and an SA-1B
``image.json`` (``{"annotations": [{"segmentation": <RLE>}, ...]}``,
decoded with ``detection.rle``).
"""

import json
import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from ...data.image_files import read_gray, read_rgb

__all__ = [
    "SamSegmentationDataset", "SAMCollater", "load_points", "mask_to_box",
    "noise_box", "noise_mask",
]


def load_points(mask, n_points=1, rs=None):
    """Prompt points [n_points, 3] (x, y, label) sampled from the mask's
    foreground (label 1), or from its background (label 0) when it has
    none; rows past the pixels available are -1."""
    rs = rs or np.random
    ys, xs = np.nonzero(mask > 0.5)
    label = 1.0
    if len(ys) == 0:
        ys, xs = np.nonzero(mask <= 0.5)
        label = 0.0
    out = np.full((n_points, 3), -1.0, np.float32)
    if len(ys) == 0:
        return out
    take = min(n_points, len(ys))
    sel = rs.choice(len(ys), take, replace=False)
    out[:take, 0] = xs[sel]
    out[:take, 1] = ys[sel]
    out[:take, 2] = label
    return out


def mask_to_box(mask):
    """(x0, y0, x1, y1) of the foreground and True, or zeros and False."""
    ys, xs = np.nonzero(mask > 0.5)
    if len(ys) == 0:
        return np.zeros(4, np.float32), False
    return np.array([xs.min(), ys.min(), xs.max(), ys.max()],
                    np.float32), True


def noise_box(box, image_hw, noise_ratio=0.1, area_filter_ratio=0.0001,
              rs=None):
    """Shift each corner by up to noise_ratio of the box side (at most 2% of
    the image side, at most half the box); near-degenerate boxes, and noise
    that would invert the box, leave it as it was."""
    rs = rs or np.random
    h, w = image_hw
    bw, bh = float(box[2] - box[0]), float(box[3] - box[1])
    if bh / h <= math.sqrt(area_filter_ratio) or \
            bw / w <= math.sqrt(area_filter_ratio):
        return box.astype(np.float32)
    noise_x = min(int(w * 0.02), bw * noise_ratio)
    noise_y = min(int(h * 0.02), bh * noise_ratio)
    if noise_x <= 1 or noise_y <= 1:
        return box.astype(np.float32)

    def shift(amp, half):
        return max(min(rs.randint(-int(amp), int(amp)), half), -half)

    out = np.array([
        box[0] + shift(noise_x, bw / 2),
        box[1] + shift(noise_y, bh / 2),
        box[2] + shift(noise_x, bw / 2),
        box[3] + shift(noise_y, bh / 2),
    ], np.float32)
    out[0::2] = np.clip(out[0::2], 0, w)
    out[1::2] = np.clip(out[1::2], 0, h)
    if out[0] >= out[2] or out[1] >= out[3]:
        return box.astype(np.float32)
    return out


def noise_mask(mask, mask_noise_area_ratio=0.04, area_filter_ratio=0.0001,
               rs=None):
    """Erode or dilate the mask (even odds) with a k x k box, k drawn below
    sqrt(noise area) / 2; tiny masks, and noise that would wipe the mask,
    leave it as it was."""
    rs = rs or np.random
    h, w = mask.shape[:2]
    area = float(np.count_nonzero(mask))
    total = float(h * w)
    if area / total < area_filter_ratio:
        return mask.astype(np.float32)
    reduce_area = area * mask_noise_area_ratio
    if reduce_area / total < area_filter_ratio:
        return mask.astype(np.float32)
    max_kernel = math.sqrt(reduce_area) / 2.0
    if int(max_kernel) <= 1:
        return mask.astype(np.float32)
    k = rs.randint(1, int(max_kernel))
    morph = ndimage.minimum_filter if rs.uniform(0, 1) < 0.5 \
        else ndimage.maximum_filter
    out = morph(mask.astype(np.float32), size=k, mode="nearest")
    if np.count_nonzero(out) / total > area_filter_ratio:
        return out.astype(np.float32)
    return mask.astype(np.float32)


class SamSegmentationDataset:
    """One item per (image, instance mask) pair across mixed sources.

    Args:
      root_dir: dataset root.
      set_name_list: source set names (subdirs of root_dir).
      set_type: "train" / "val" split subdir.
      per_set_image_choose_max_num: int or {set_name: int} cap on images
        taken from each source.
      per_image_mask_chosse_max_num: cap on masks per image (the reference
        configs' spelling).
      area_filter_ratio: drop masks whose area is below this fraction of
        the image.
    Items are {"image": H x W x 3 float32 RGB 0-255, "mask": H x W float32
    {0, 1}, "size": (H, W)}.
    """

    def __init__(self, root_dir, set_name_list=(), set_type="train",
                 per_set_image_choose_max_num=None,
                 per_image_mask_chosse_max_num=16,
                 area_filter_ratio=0.0001, transform=None, max_points=9):
        self.transform = transform
        self.max_points = max_points
        self.area_filter_ratio = area_filter_ratio
        entries = []  # (image_path, kind, payload)
        for set_name in set_name_list:
            set_dir = os.path.join(root_dir, set_name, set_type)
            if not os.path.isdir(set_dir):
                continue
            cap = per_set_image_choose_max_num
            if isinstance(cap, dict):
                cap = cap.get(set_name)
            images = sorted(n for n in os.listdir(set_dir)
                            if n.endswith(".jpg"))
            if cap is not None:
                images = images[:cap]
            for name in images:
                stem = name.rsplit(".", 1)[0]
                image_path = os.path.join(set_dir, name)
                json_path = os.path.join(set_dir, stem + ".json")
                if os.path.exists(json_path):
                    with open(json_path) as f:
                        anns = json.load(f).get("annotations", [])
                    kept = 0
                    for k, ann in enumerate(anns):
                        if kept >= per_image_mask_chosse_max_num:
                            break
                        seg = ann.get("segmentation", {})
                        area = ann.get("area")
                        if area is not None and isinstance(seg, dict) \
                                and "size" in seg:
                            h0, w0 = seg["size"]
                            if area / float(h0 * w0) < area_filter_ratio:
                                continue
                        entries.append((image_path, "json", (json_path, k)))
                        kept += 1
                    continue
                masks = sorted(
                    n for n in os.listdir(set_dir)
                    if n.startswith(stem + "_mask") and n.endswith(".png"))
                for m in masks[:per_image_mask_chosse_max_num]:
                    entries.append((image_path, "png",
                                    os.path.join(set_dir, m)))
        self.entries = entries

    def __len__(self):
        return len(self.entries)

    @staticmethod
    def _load_mask(kind, payload):
        if kind == "png":
            return (read_gray(payload) > 127).astype(np.float32)
        json_path, k = payload
        with open(json_path) as f:
            seg = json.load(f)["annotations"][k]["segmentation"]
        from ...detection.rle import coco_rle_to_mask, rle_decode
        # SA-1B ships compressed string counts; list counts also accepted
        if isinstance(seg.get("counts"), str):
            return coco_rle_to_mask(seg).astype(np.float32)
        return rle_decode(seg).astype(np.float32)

    def __getitem__(self, idx):
        image_path, kind, payload = self.entries[idx]
        image = read_rgb(image_path)
        sample = {"image": image, "mask": self._load_mask(kind, payload),
                  "size": np.array(image.shape[:2], np.float32)}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample


def _resize(x, size, mode):
    """[C, H, W] or [H, W] float32 numpy -> torch, resized to size (h, w)."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    lead = t.dim() == 2
    t = t[None, None] if lead else t[None]
    if tuple(t.shape[-2:]) != tuple(size):
        kw = {} if mode == "nearest" else {"align_corners": False}
        t = F.interpolate(t, size=size, mode=mode, **kw)
    return t[0, 0] if lead else t[0]


class SAMCollater:
    """Fixed-shape SAM batch: ``resize``-square images (the long side
    resized to ``resize``, zero padding at the bottom and right), one target
    mask an image, and one prompt kind an image, drawn with
    ``prompt_probs`` = (points, box, mask): 1 to ``n_points`` foreground
    points, the noised box, or the noised mask downsampled 4x and
    binarised. Returns torch tensors: image [B, 3, r, r], mask [B, 1, r, r],
    prompt_point [B, n_points, 3] (-1 rows unused), prompt_box [B, 4],
    prompt_box_valid [B], prompt_mask [B, 1, r/4, r/4], prompt_mask_valid
    [B]."""

    def __init__(self, resize=1024, n_points=9, prompt_probs=(0.5, 0.25,
                                                              0.25),
                 box_noise_wh_ratio=0.1, mask_noise_area_ratio=0.04,
                 area_filter_ratio=0.0001):
        self.resize = resize
        self.n_points = n_points
        self.prompt_probs = prompt_probs
        self.box_noise_wh_ratio = box_noise_wh_ratio
        self.mask_noise_area_ratio = mask_noise_area_ratio
        self.area_filter_ratio = area_filter_ratio

    def __call__(self, samples):
        n = len(samples)
        r = self.resize
        rq = r // 4
        images = torch.zeros((n, 3, r, r))
        masks = torch.zeros((n, 1, r, r))
        points = np.full((n, self.n_points, 3), -1.0, np.float32)
        boxes = np.zeros((n, 4), np.float32)
        boxes_valid = np.zeros((n,), np.float32)
        prompt_masks = torch.zeros((n, 1, rq, rq))
        masks_valid = np.zeros((n,), np.float32)
        for i, s in enumerate(samples):
            img, m = s["image"], s["mask"]
            h, w = img.shape[:2]
            factor = r / max(h, w)
            rh, rw = int(round(h * factor)), int(round(w * factor))
            images[i, :, :rh, :rw] = _resize(img.transpose(2, 0, 1), (rh, rw),
                                             "bilinear")
            masks[i, 0, :rh, :rw] = _resize(m, (rh, rw), "nearest")

            ptype = np.random.choice(3, p=self.prompt_probs)
            full = masks[i, 0].numpy()
            if ptype == 0:
                k = np.random.randint(1, self.n_points + 1)
                points[i, :k] = load_points(full, k)
            elif ptype == 1:
                box, ok = mask_to_box(full)
                if ok:
                    boxes[i] = noise_box(
                        box, (r, r), noise_ratio=self.box_noise_wh_ratio,
                        area_filter_ratio=self.area_filter_ratio)
                    boxes_valid[i] = 1.0
            else:
                noised = noise_mask(
                    full, mask_noise_area_ratio=self.mask_noise_area_ratio,
                    area_filter_ratio=self.area_filter_ratio)
                small = _resize(noised, (rq, rq), "bilinear")
                prompt_masks[i, 0] = (small > 0.5).float()
                masks_valid[i] = 1.0
        return {
            "image": images,
            "mask": masks,
            "prompt_point": torch.from_numpy(points),
            "prompt_box": torch.from_numpy(boxes),
            "prompt_box_valid": torch.from_numpy(boxes_valid),
            "prompt_mask": prompt_masks,
            "prompt_mask_valid": torch.from_numpy(masks_valid),
        }
