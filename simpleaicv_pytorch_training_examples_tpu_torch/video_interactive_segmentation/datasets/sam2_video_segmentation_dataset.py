"""SAM2 video segmentation dataset and collaters.

Counterpart of the JAX package's ``video_interactive_segmentation/
datasets/sam2_video_segmentation_dataset.py``:

- ``SAM2VideoSegmentationDataset``: video sets and image sets mixed (an
  image becomes a static clip of repeated frames), capped per source; one
  item per (video, object) pair (``per_video_choose_object_nums`` objects
  of a video fold into the batch axis); a clip of ``frame_nums``
  consecutive frames from a random start, the last frame repeated when a
  video is shorter;
- ``SAM2VideoCollater``: fixed-shape clips with frame-0 point prompts (the
  frame-0-only recipe of the stage-1 configs);
- ``SAM2VideoBatchCollater``: the condition-frame recipe: one prompt kind a
  batch drawn with ``prompt_probs`` (points, box, mask), frame 0 and up to
  ``extra_cond_frames`` random frames as condition frames (shared by the
  batch), each prompted from its own target with the SAM collater's noise,
  ``point_iter_frame_num`` random other frames flagged for point-iteration
  refinement, and all-invalid prompts on the other frames.

The collaters work in NCHW: image [B, T, 3, r, r] in [0, 1], mask [B, T,
r, r], prompt_point [B, P, 3] or [B, T, P, 3], prompt_box [B, T, 4] with
prompt_box_valid [B, T], prompt_mask [B, T, 1, r/4, r/4] with
prompt_mask_valid [B, T], is_cond_frame and is_iter_frame [B, T] (the
frame roles, the same for every clip of the batch: the train tool keeps
them on the host). They resize with torch as ``SAMCollater`` does
(bilinear for images and the 4x mask-prompt downsample, nearest for
targets: cv2's INTER_LINEAR and INTER_NEAREST) and draw from the global
``np.random`` in the JAX collaters' order, so both give the same batch from
one seed. The dataset reads its files without cv2 (``data/image_files.py``:
JPEG frames through the native libjpeg core, PNG masks through Pillow).

Disk layouts under ``root/<set>/<type>/``: video sets hold
``<video_id>/00000.jpg`` with ``00000_mask.png`` (object 0) or
``00000_mask<k>.png`` per object k; image sets hold ``image.jpg`` and
``image_mask<k>.png``.
"""

import os

import numpy as np
import torch

from ...data.image_files import read_gray, read_rgb
from ...interactive_segmentation.datasets.sam_segmentation_dataset import (
    _resize, load_points, mask_to_box, noise_box, noise_mask)

__all__ = ["SAM2VideoSegmentationDataset", "SAM2VideoCollater",
           "SAM2VideoBatchCollater"]


def _list_object_ids(vdir, frames):
    """Object ids of a video dir: the ``_mask<k>.png`` suffixes of its first
    frame (a bare ``_mask.png`` is object 0)."""
    stem0 = frames[0].rsplit(".", 1)[0]
    ids = set()
    for n in os.listdir(vdir):
        if not (n.startswith(stem0 + "_mask") and n.endswith(".png")):
            continue
        suffix = n[len(stem0 + "_mask"):-len(".png")]
        ids.add(int(suffix) if suffix.isdigit() else 0)
    return sorted(ids)


def _capped(names, cap, set_name):
    cap = cap.get(set_name) if isinstance(cap, dict) else cap
    return names if cap is None else names[:cap]


class SAM2VideoSegmentationDataset:
    """Items are {"images": T frames H x W x 3 float32 RGB 0-255, "masks": T
    masks H x W float32 {0, 1}}. ``root_dir``, ``set_name_list`` and
    ``set_type`` are the single-root signature of the stage-1 configs (video
    sets only)."""

    def __init__(self, video_root_dir=None, video_set_name=(),
                 video_set_type="train",
                 image_root_dir=None, image_set_name=(),
                 image_set_type="train",
                 image_per_set_image_choose_max_num=None,
                 per_set_video_choose_max_num=None,
                 per_image_mask_chosse_max_num=16,
                 per_video_choose_object_nums=2,
                 frame_nums=8, transform=None,
                 root_dir=None, set_name_list=(), set_type="train"):
        if root_dir is not None:
            video_root_dir = root_dir
            video_set_name = set_name_list
            video_set_type = set_type
        self.transform = transform
        self.frame_nums = frame_nums
        self.entries = []  # ("video", vdir, frames, obj) or ("image", jpg, png)
        for set_name in (video_set_name if video_root_dir else ()):
            set_dir = os.path.join(video_root_dir, set_name, video_set_type)
            if not os.path.isdir(set_dir):
                continue
            vids = _capped(sorted(v for v in os.listdir(set_dir)
                                  if os.path.isdir(os.path.join(set_dir, v))),
                           per_set_video_choose_max_num, set_name)
            for vid in vids:
                vdir = os.path.join(set_dir, vid)
                frames = sorted(n for n in os.listdir(vdir)
                                if n.endswith(".jpg"))
                if not frames:
                    continue
                obj_ids = _list_object_ids(vdir, frames) or [0]
                for obj in obj_ids[:per_video_choose_object_nums]:
                    self.entries.append(("video", vdir, frames, obj))
        for set_name in (image_set_name if image_root_dir else ()):
            set_dir = os.path.join(image_root_dir, set_name, image_set_type)
            if not os.path.isdir(set_dir):
                continue
            images = _capped(sorted(n for n in os.listdir(set_dir)
                                    if n.endswith(".jpg")),
                             image_per_set_image_choose_max_num, set_name)
            for name in images:
                stem = name.rsplit(".", 1)[0]
                masks = sorted(n for n in os.listdir(set_dir)
                               if n.startswith(stem + "_mask")
                               and n.endswith(".png"))
                for m in masks[:per_image_mask_chosse_max_num]:
                    self.entries.append(("image", os.path.join(set_dir, name),
                                         os.path.join(set_dir, m)))

    def __len__(self):
        return len(self.entries)

    @staticmethod
    def _read_mask(path, obj):
        raw = read_gray(path)
        if raw is None:
            return None
        if len(np.unique(raw)) > 2 and obj is not None:
            # an indexed multi-object mask: object k has pixel value k + 1
            return (raw == obj + 1).astype(np.float32)
        return (raw > 127).astype(np.float32)

    def __getitem__(self, idx):
        entry = self.entries[idx]
        t = self.frame_nums
        if entry[0] == "image":
            _, image_path, mask_path = entry
            images = [read_rgb(image_path)] * t
            masks = [self._read_mask(mask_path, None)] * t
        else:
            _, vdir, frames, obj = entry
            if len(frames) >= t:
                start = np.random.randint(0, len(frames) - t + 1)
                chosen = frames[start:start + t]
            else:
                chosen = list(frames) + [frames[-1]] * (t - len(frames))
            images, masks = [], []
            for name in chosen:
                img = read_rgb(os.path.join(vdir, name))
                stem = name.rsplit(".", 1)[0]
                m = None
                for cand in (f"{stem}_mask{obj}.png", f"{stem}_mask.png"):
                    path = os.path.join(vdir, cand)
                    if os.path.exists(path):
                        m = self._read_mask(path, obj)
                        break
                images.append(img)
                masks.append(np.zeros(img.shape[:2], np.float32)
                             if m is None else m)
        sample = {"images": images, "masks": masks}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample


def _clips(samples, r, t):
    """The samples' first t frames, the long side resized to r and
    zero-padded to r x r: images [B, T, 3, r, r] in [0, 1], masks [B, T, r,
    r]."""
    n = len(samples)
    images = torch.zeros((n, t, 3, r, r))
    masks = torch.zeros((n, t, r, r))
    for i, s in enumerate(samples):
        for f, (img, m) in enumerate(zip(s["images"][:t], s["masks"][:t])):
            h, w = img.shape[:2]
            factor = r / max(h, w)
            rh, rw = int(round(h * factor)), int(round(w * factor))
            images[i, f, :, :rh, :rw] = _resize(
                np.asarray(img).transpose(2, 0, 1), (rh, rw),
                "bilinear") / 255.0
            masks[i, f, :rh, :rw] = _resize(m, (rh, rw), "nearest")
    return images, masks


class SAM2VideoCollater:
    """Fixed-shape clips with 1 to ``n_points`` foreground points on frame 0
    (prompt_point [B, n_points, 3], -1 rows unused)."""

    def __init__(self, resize=1024, frame_nums=8, n_points=2):
        self.resize = resize
        self.frame_nums = frame_nums
        self.n_points = n_points

    def __call__(self, samples):
        images, masks = _clips(samples, self.resize, self.frame_nums)
        points = np.full((len(samples), self.n_points, 3), -1.0, np.float32)
        for i in range(len(samples)):
            k = np.random.randint(1, self.n_points + 1)
            points[i, :k] = load_points(masks[i, 0].numpy(), k)[:k]
        return {"image": images, "mask": masks,
                "prompt_point": torch.from_numpy(points)}


class SAM2VideoBatchCollater:
    """The condition-frame recipe (see the module docstring)."""

    def __init__(self, resize=1024, frame_nums=8, n_points=2,
                 prompt_probs=(0.5, 0.25, 0.25), extra_cond_frames=1,
                 point_iter_frame_num=2, box_noise_wh_ratio=0.1,
                 mask_noise_area_ratio=0.04, area_filter_ratio=0.0001):
        self.resize = resize
        self.frame_nums = frame_nums
        self.n_points = n_points
        self.prompt_probs = prompt_probs
        self.extra_cond_frames = extra_cond_frames
        self.point_iter_frame_num = point_iter_frame_num
        self.box_noise_wh_ratio = box_noise_wh_ratio
        self.mask_noise_area_ratio = mask_noise_area_ratio
        self.area_filter_ratio = area_filter_ratio

    def _roles(self):
        """The batch's condition frames (frame 0 and the extra ones) and
        point-iteration frames (among the others), [T] 0/1 each."""
        t = self.frame_nums
        is_cond = np.zeros((t,), np.float32)
        is_cond[0] = 1.0
        if t > 1 and self.extra_cond_frames > 0:
            extra = np.random.randint(0, self.extra_cond_frames + 1)
            if extra:
                is_cond[np.random.choice(np.arange(1, t), min(extra, t - 1),
                                         replace=False)] = 1.0
        is_iter = np.zeros((t,), np.float32)
        non_cond = np.where(is_cond == 0)[0]
        if len(non_cond) and self.point_iter_frame_num > 0:
            k = min(self.point_iter_frame_num, len(non_cond))
            is_iter[np.random.choice(non_cond, k, replace=False)] = 1.0
        return is_cond, is_iter

    def __call__(self, samples):
        n, r, t, p = len(samples), self.resize, self.frame_nums, self.n_points
        rq = r // 4
        points = np.full((n, t, p, 3), -1.0, np.float32)
        boxes = np.zeros((n, t, 4), np.float32)
        boxes_valid = np.zeros((n, t), np.float32)
        prompt_masks = torch.zeros((n, t, 1, rq, rq))
        masks_valid = np.zeros((n, t), np.float32)
        is_cond, is_iter = self._roles()
        ptype = np.random.choice(3, p=self.prompt_probs)
        images, masks = _clips(samples, r, t)
        for i in range(n):
            for f in np.where(is_cond > 0)[0]:
                gt = masks[i, f].numpy()
                if ptype == 0:
                    k = np.random.randint(1, p + 1)
                    points[i, f, :k] = load_points(gt, k)[:k]
                elif ptype == 1:
                    box, ok = mask_to_box(gt)
                    if ok:
                        boxes[i, f] = noise_box(
                            box, (r, r), noise_ratio=self.box_noise_wh_ratio,
                            area_filter_ratio=self.area_filter_ratio)
                        boxes_valid[i, f] = 1.0
                else:
                    noised = noise_mask(
                        gt, mask_noise_area_ratio=self.mask_noise_area_ratio,
                        area_filter_ratio=self.area_filter_ratio)
                    small = _resize(noised, (rq, rq), "bilinear")
                    prompt_masks[i, f, 0] = (small > 0.5).float()
                    masks_valid[i, f] = 1.0
        return {
            "image": images,
            "mask": masks,
            "prompt_point": torch.from_numpy(points),
            "prompt_box": torch.from_numpy(boxes),
            "prompt_box_valid": torch.from_numpy(boxes_valid),
            "prompt_mask": prompt_masks,
            "prompt_mask_valid": torch.from_numpy(masks_valid),
            "is_cond_frame": torch.from_numpy(np.tile(is_cond, (n, 1))),
            "is_iter_frame": torch.from_numpy(np.tile(is_iter, (n, 1))),
        }
