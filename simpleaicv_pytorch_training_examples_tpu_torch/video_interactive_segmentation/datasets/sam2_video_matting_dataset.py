"""SAM2 video matting dataset and collaters.

Counterpart of the JAX package's ``video_interactive_segmentation/
datasets/sam2_video_matting_dataset.py``:

- ``SAM2VideoMattingDataset``: clips of ``frame_nums`` frames with per-frame
  alpha mattes (a random start, the last frame repeated when a video is
  shorter), from foreground-matte video sets, each composited over a
  random background video clip with the set's ``use_background_video_prob``
  (a number, or {set: probability}), and image matting sets as static
  clips (the image repeated); ``per_set_video_choose_max_num`` caps the
  videos of a set.
- ``SAM2VideoMattingCollater``: fixed-shape clips, the trimap of each frame
  from its resized alpha (``make_trimap``: a k x k box, k = 15, eroding the
  foreground and dilating the band), 1 to ``n_points`` points on frame 0
  from its binarised alpha;
- ``SAM2ImageMattingCollater``: the same on 1-frame clips, the time axis
  dropped (image-dataset items, ``image`` and ``mask``, become 1-frame
  clips);
- ``SAM2VideoMattingBatchCollater``: the condition-frame recipe of
  ``SAM2VideoBatchCollater``: frame 0 and up to ``extra_cond_frames`` random
  frames as condition frames, one prompt kind a batch drawn with
  ``prompt_probs`` (points, noised box, noised mask downsampled 4x), each
  condition frame prompted from its own binarised alpha, all-invalid
  prompts on the other frames.

The collaters work in NCHW: image [B, T, 3, r, r] in [0, 1], alpha and
trimap [B, T, r, r], prompt_point [B, P, 3] or [B, T, P, 3], prompt_box
[B, T, 4] with prompt_box_valid [B, T], prompt_mask [B, T, 1, r/4, r/4]
with prompt_mask_valid [B, T], is_cond_frame [B, T] (the same for every
clip: the train tool reads it on the host). They resize with torch where
the JAX collaters call cv2 (bilinear ``F.interpolate`` without
antialiasing for INTER_LINEAR), erode and dilate with scipy over a box
(``mode="nearest"``, cv2's erode and dilate), and draw from the global
``np.random`` in the JAX collaters' order, so both give the same batch from
one seed. Files are read without cv2 (``data/image_files.py``).

Disk layouts: video sets ``<set>/<type>/<video_id>/00000.jpg`` with
``00000_alpha.png``; background videos ``<type>/<video_id>/00000.jpg``
under ``background_root_dir`` (or directly under it); image sets
``<set>/<type>/image.jpg`` with ``image_alpha.png`` under
``image_root_dir``.
"""

import os

import numpy as np
import torch
from scipy import ndimage

from ...data.image_files import read_gray, read_rgb
from ...interactive_segmentation.datasets.sam_segmentation_dataset import (
    _resize, load_points, mask_to_box, noise_box, noise_mask)

__all__ = ["SAM2VideoMattingDataset", "SAM2VideoMattingCollater",
           "SAM2VideoMattingBatchCollater", "SAM2ImageMattingCollater",
           "make_trimap"]


def make_trimap(alpha, kernel_size=15):
    """alpha [H, W] in [0, 1] -> trimap in {0, 128, 255}: the foreground
    (alpha > 0.95) eroded, the band (0.05 < alpha <= 0.95) and the
    erosion's rim dilated, both by a k x k box."""
    erode = lambda x: ndimage.minimum_filter(  # noqa: E731
        x, size=kernel_size, mode="nearest")
    dilate = lambda x: ndimage.maximum_filter(  # noqa: E731
        x, size=kernel_size, mode="nearest")
    fg = (alpha > 0.95).astype(np.uint8)
    unknown = ((alpha > 0.05) & (alpha <= 0.95)).astype(np.uint8)
    fg_eroded = erode(fg)
    unknown_dilated = dilate(unknown | (fg - fg_eroded))
    trimap = np.zeros_like(alpha, np.float32)
    trimap[unknown_dilated > 0] = 128.0
    trimap[fg_eroded > 0] = 255.0
    return trimap


def _resize_hwc(image, h, w):
    """[H, W, 3] float32 numpy resized bilinearly to (h, w), HWC numpy."""
    return _resize(np.asarray(image).transpose(2, 0, 1), (h, w),
                   "bilinear").numpy().transpose(1, 2, 0)


def _clip_frames(frames, t):
    """t consecutive names from a random start; the last one repeated when
    there are fewer."""
    if len(frames) >= t:
        start = np.random.randint(0, len(frames) - t + 1)
        return frames[start:start + t]
    return list(frames) + [frames[-1]] * (t - len(frames))


def _jpegs(directory):
    return sorted(n for n in os.listdir(directory) if n.endswith(".jpg"))


class SAM2VideoMattingDataset:

    def __init__(self, root_dir, set_name_list=(), set_type="train",
                 frame_nums=8, transform=None,
                 per_set_video_choose_max_num=None,
                 background_root_dir=None, background_set_type="train",
                 use_background_video_prob=None,
                 image_root_dir=None, image_set_name=(),
                 image_set_type="train"):
        self.transform = transform
        self.frame_nums = frame_nums
        self.use_background_video_prob = use_background_video_prob
        self.entries = []   # ("video", set, dir, frames) | ("image", ...)
        for set_name in set_name_list:
            set_dir = os.path.join(root_dir, set_name, set_type)
            if not os.path.isdir(set_dir):
                continue
            cap = per_set_video_choose_max_num
            if isinstance(cap, dict):
                cap = cap.get(set_name)
            vids = sorted(v for v in os.listdir(set_dir)
                          if os.path.isdir(os.path.join(set_dir, v)))
            if cap is not None:
                vids = vids[:cap]
            for vid in vids:
                vdir = os.path.join(set_dir, vid)
                frames = _jpegs(vdir)
                if frames:
                    self.entries.append(("video", set_name, vdir, frames))
        if image_root_dir:
            for set_name in image_set_name:
                set_dir = os.path.join(image_root_dir, set_name,
                                       image_set_type)
                if not os.path.isdir(set_dir):
                    continue
                for name in _jpegs(set_dir):
                    alpha_path = os.path.join(
                        set_dir, name.rsplit(".", 1)[0] + "_alpha.png")
                    if os.path.exists(alpha_path):
                        self.entries.append(
                            ("image", set_name, os.path.join(set_dir, name),
                             alpha_path))
        self.background_videos = []
        if background_root_dir:
            bdir = os.path.join(background_root_dir, background_set_type)
            if not os.path.isdir(bdir):
                bdir = background_root_dir
            if os.path.isdir(bdir):
                for vid in sorted(os.listdir(bdir)):
                    vdir = os.path.join(bdir, vid)
                    if not os.path.isdir(vdir):
                        continue
                    frames = _jpegs(vdir)
                    if frames:
                        self.background_videos.append((vdir, frames))

    def __len__(self):
        return len(self.entries)

    def _bg_prob(self, set_name):
        p = self.use_background_video_prob
        if p is None:
            return 0.0
        if isinstance(p, dict):
            return p.get(set_name, 0.0)
        return float(p)

    def _sample_background_clip(self, t, hw):
        """A random background clip of t frames, each resized to hw."""
        vdir, frames = self.background_videos[
            np.random.randint(len(self.background_videos))]
        return [_resize_hwc(read_rgb(os.path.join(vdir, name)), *hw)
                for name in _clip_frames(frames, t)]

    def __getitem__(self, idx):
        entry = self.entries[idx]
        t = self.frame_nums
        if entry[0] == "image":
            _, set_name, image_path, alpha_path = entry
            image = read_rgb(image_path)
            alpha = read_gray(alpha_path).astype(np.float32) / 255.0
            images, alphas = [image] * t, [alpha] * t
        else:
            _, set_name, vdir, frames = entry
            images, alphas = [], []
            for name in _clip_frames(frames, t):
                image = read_rgb(os.path.join(vdir, name))
                raw = read_gray(os.path.join(
                    vdir, name.rsplit(".", 1)[0] + "_alpha.png"))
                alphas.append(np.zeros(image.shape[:2], np.float32)
                              if raw is None
                              else raw.astype(np.float32) / 255.0)
                images.append(image)
            if self.background_videos and \
                    np.random.uniform() < self._bg_prob(set_name):
                bgs = self._sample_background_clip(t, images[0].shape[:2])
                images = [fg * a[..., None] + bg * (1.0 - a[..., None])
                          for fg, a, bg in zip(images, alphas, bgs)]
        sample = {"images": images, "alphas": alphas}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample


class SAM2VideoMattingCollater:
    """Fixed-shape clips with their trimaps and frame-0 points (see the
    module docstring)."""

    def __init__(self, resize=1024, frame_nums=8, n_points=2):
        self.resize = resize
        self.frame_nums = frame_nums
        self.n_points = n_points

    def __call__(self, samples):
        n, r, t = len(samples), self.resize, self.frame_nums
        images = torch.zeros((n, t, 3, r, r))
        alphas = torch.zeros((n, t, r, r))
        trimaps = torch.zeros((n, t, r, r))
        points = np.full((n, self.n_points, 3), -1.0, np.float32)
        for i, s in enumerate(samples):
            for f, (img, a) in enumerate(zip(s["images"][:t],
                                             s["alphas"][:t])):
                h, w = img.shape[:2]
                factor = r / max(h, w)
                rh, rw = int(round(h * factor)), int(round(w * factor))
                images[i, f, :, :rh, :rw] = _resize(
                    np.asarray(img).transpose(2, 0, 1), (rh, rw),
                    "bilinear") / 255.0
                alphas[i, f, :rh, :rw] = _resize(a, (rh, rw), "bilinear")
                trimaps[i, f] = torch.from_numpy(make_trimap(
                    alphas[i, f].numpy()))
            k = np.random.randint(1, self.n_points + 1)
            points[i, :k] = load_points(
                (alphas[i, 0].numpy() > 0.5).astype(np.float32), k)[:k]
        return {"image": images, "alpha": alphas, "trimap": trimaps,
                "prompt_point": torch.from_numpy(points)}


class SAM2ImageMattingCollater(SAM2VideoMattingCollater):
    """1-frame clips, the time axis dropped."""

    def __init__(self, resize=1024, n_points=9):
        super().__init__(resize=resize, frame_nums=1, n_points=n_points)

    def __call__(self, samples):
        for s in samples:
            if "image" in s and "images" not in s:   # an image-set item
                s["images"] = [s["image"]]
                s["alphas"] = [s["mask"]]
        out = super().__call__(samples)
        return {"image": out["image"][:, 0], "alpha": out["alpha"][:, 0],
                "trimap": out["trimap"][:, 0],
                "prompt_point": out["prompt_point"]}


class SAM2VideoMattingBatchCollater(SAM2VideoMattingCollater):
    """The condition-frame recipe (see the module docstring)."""

    def __init__(self, resize=1024, frame_nums=8, n_points=2,
                 prompt_probs=(0.5, 0.25, 0.25), extra_cond_frames=1):
        super().__init__(resize=resize, frame_nums=frame_nums,
                         n_points=n_points)
        self.prompt_probs = prompt_probs
        self.extra_cond_frames = extra_cond_frames

    def __call__(self, samples):
        base = super().__call__(samples)
        n, t = base["alpha"].shape[:2]
        r, p = self.resize, self.n_points
        rq = r // 4
        is_cond = np.zeros((t,), np.float32)
        is_cond[0] = 1.0
        if t > 1 and self.extra_cond_frames > 0:
            extra = np.random.randint(0, self.extra_cond_frames + 1)
            if extra:
                is_cond[np.random.choice(np.arange(1, t), min(extra, t - 1),
                                         replace=False)] = 1.0
        points = np.full((n, t, p, 3), -1.0, np.float32)
        boxes = np.zeros((n, t, 4), np.float32)
        boxes_valid = np.zeros((n, t), np.float32)
        prompt_masks = torch.zeros((n, t, 1, rq, rq))
        masks_valid = np.zeros((n, t), np.float32)
        ptype = np.random.choice(3, p=self.prompt_probs)
        for i in range(n):
            for f in np.where(is_cond > 0)[0]:
                binary = (base["alpha"][i, f].numpy() > 0.5).astype(
                    np.float32)
                if ptype == 0:
                    k = np.random.randint(1, p + 1)
                    points[i, f, :k] = load_points(binary, k)[:k]
                elif ptype == 1:
                    box, ok = mask_to_box(binary)
                    if ok:
                        boxes[i, f] = noise_box(box, (r, r))
                        boxes_valid[i, f] = 1.0
                else:
                    small = _resize(noise_mask(binary), (rq, rq), "bilinear")
                    prompt_masks[i, f, 0] = (small > 0.5).float()
                    masks_valid[i, f] = 1.0
        base.update({
            "prompt_point": torch.from_numpy(points),
            "prompt_box": torch.from_numpy(boxes),
            "prompt_box_valid": torch.from_numpy(boxes_valid),
            "prompt_mask": prompt_masks,
            "prompt_mask_valid": torch.from_numpy(masks_valid),
            "is_cond_frame": torch.from_numpy(np.tile(is_cond, (n, 1))),
        })
        return base
