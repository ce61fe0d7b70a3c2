"""Classification transforms, collater and checkpoint hook.

Counterpart of the parts of the JAX package's ``classification/common.py``
that the ViT, ResNet, CIFAR ResNet, MAE and distillation configs use: the
eval transforms, the training transforms (random resized crop, horizontal
flip, random erasing; CIFAR's pad and random crop; MAE's ``Normalize``),
``test_collater`` and ``load_state_dict``.
Transforms are host-side numpy ops over dict samples ``{'image': HWC array,
'label': int}`` that draw from the global ``np.random``; the collater hands
out torch tensors: NCHW float32 images and int64 labels.
"""

import math

import numpy as np
import torch

__all__ = ["Opencv2PIL", "PIL2Opencv", "TorchPad", "TorchRandomCrop",
           "TorchMeanStdNormalize", "Normalize", "TorchResize",
           "TorchCenterCrop", "TorchRandomResizedCrop",
           "TorchRandomHorizontalFlip", "RandomErasing",
           "ClassificationCollater", "load_state_dict"]


class Opencv2PIL:
    """No-op adapter (images stay numpy HWC throughout)."""

    def __call__(self, sample):
        return sample


class PIL2Opencv:
    """No-op adapter."""

    def __call__(self, sample):
        return sample


class TorchPad:
    """Pad H and W by ``padding`` with ``fill`` or by reflection, as
    torchvision's Pad."""

    def __init__(self, padding=4, fill=0, padding_mode="reflect"):
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def __call__(self, sample):
        p = self.padding
        pads = ((p, p), (p, p), (0, 0))
        if self.padding_mode == "reflect":
            image = np.pad(sample["image"], pads, mode="reflect")
        else:
            image = np.pad(sample["image"], pads, mode="constant",
                           constant_values=self.fill)
        sample["image"] = image
        return sample


class TorchRandomCrop:
    """A ``resize`` x ``resize`` crop at a random offset (y drawn first)."""

    def __init__(self, resize=32):
        self.resize = resize

    def __call__(self, sample):
        image = sample["image"]
        h, w = image.shape[:2]
        y = np.random.randint(0, h - self.resize + 1)
        x = np.random.randint(0, w - self.resize + 1)
        sample["image"] = image[y:y + self.resize, x:x + self.resize]
        return sample


class TorchMeanStdNormalize:
    """(x/255 - mean)/std with mean/std given in 0-1 range, as one fused
    multiply-add (x*inv - bias with inv=1/(255*std), bias=mean/std)."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)
        self._inv = (1.0 / (255.0 * self.std)).astype(np.float32)
        self._bias = (self.mean / self.std).astype(np.float32)

    def __call__(self, sample):
        image = np.multiply(sample["image"], self._inv, dtype=np.float32)
        image -= self._bias
        sample["image"] = image
        return sample


class Normalize:
    """x / 255 in float32 (MAE's pretraining input)."""

    def __call__(self, sample):
        sample["image"] = sample["image"].astype(np.float32) / 255.0
        return sample


def _resize_image(image, out_h, out_w):
    """Bilinear resize via cv2 if available, else numpy."""
    try:
        import cv2
        return cv2.resize(image, (out_w, out_h),
                          interpolation=cv2.INTER_LINEAR)
    except ImportError:
        h, w = image.shape[:2]
        ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
        xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
        y0 = np.clip(np.floor(ys).astype(np.int32), 0, h - 1)
        x0 = np.clip(np.floor(xs).astype(np.int32), 0, w - 1)
        y1 = np.clip(y0 + 1, 0, h - 1)
        x1 = np.clip(x0 + 1, 0, w - 1)
        wy = np.clip(ys - y0, 0, 1)[:, None, None]
        wx = np.clip(xs - x0, 0, 1)[None, :, None]
        img = image.astype(np.float32)
        squeeze = img.ndim == 2
        if squeeze:
            img = img[..., None]
        top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
        bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
        out = top * (1 - wy) + bot * wy
        if squeeze:
            out = out[..., 0]
        return out.astype(image.dtype)


class TorchResize:
    """torchvision Resize(int): short side -> resize, keep aspect."""

    def __init__(self, resize=224):
        self.resize = resize

    def __call__(self, sample):
        image = sample["image"]
        h, w = image.shape[:2]
        if h <= w:
            out_h, out_w = self.resize, max(1, int(round(w * self.resize / h)))
        else:
            out_h, out_w = max(1, int(round(h * self.resize / w))), self.resize
        sample["image"] = _resize_image(image, out_h, out_w)
        return sample


class TorchCenterCrop:

    def __init__(self, resize=224):
        self.resize = resize

    def __call__(self, sample):
        image = sample["image"]
        h, w = image.shape[:2]
        y = max(0, (h - self.resize) // 2)
        x = max(0, (w - self.resize) // 2)
        sample["image"] = image[y:y + self.resize, x:x + self.resize]
        return sample


class TorchRandomHorizontalFlip:

    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, sample):
        if np.random.uniform(0, 1) < self.prob:
            sample["image"] = np.ascontiguousarray(sample["image"][:, ::-1])
        return sample


class TorchRandomResizedCrop:
    """Random scale/aspect crop, then resize (torchvision semantics)."""

    def __init__(self, resize=224, scale=(0.08, 1.0),
                 ratio=(3.0 / 4.0, 4.0 / 3.0)):
        self.resize = resize
        self.scale = scale
        self.ratio = ratio

    def __call__(self, sample):
        image = sample["image"]
        h, w = image.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = area * np.random.uniform(*self.scale)
            log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
            aspect = math.exp(np.random.uniform(*log_ratio))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                y = np.random.randint(0, h - ch + 1)
                x = np.random.randint(0, w - cw + 1)
                crop = image[y:y + ch, x:x + cw]
                sample["image"] = _resize_image(crop, self.resize,
                                                self.resize)
                return sample
        # no crop fitted in ten draws: the centre crop nearest the ratios
        in_ratio = w / h
        if in_ratio < self.ratio[0]:
            cw, ch = w, int(round(w / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            cw, ch = int(round(h * self.ratio[1])), h
        else:
            cw, ch = w, h
        y, x = (h - ch) // 2, (w - cw) // 2
        crop = image[y:y + ch, x:x + cw]
        sample["image"] = _resize_image(crop, self.resize, self.resize)
        return sample


class RandomErasing:
    """timm-style random erasing on a normalised image."""

    def __init__(self, prob=0.25, area_range=(0.02, 1.0 / 3.0),
                 aspect_range=(0.3, 10 / 3.0)):
        self.prob = prob
        self.area_range = area_range
        self.aspect_range = aspect_range

    def __call__(self, sample):
        if np.random.uniform(0, 1) > self.prob:
            return sample
        image = sample["image"]
        h, w = image.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.area_range)
            aspect = np.random.uniform(*self.aspect_range)
            eh = int(round(math.sqrt(target * aspect)))
            ew = int(round(math.sqrt(target / aspect)))
            if eh < h and ew < w:
                y = np.random.randint(0, h - eh)
                x = np.random.randint(0, w - ew)
                image[y:y + eh, x:x + ew] = np.random.normal(
                    size=(eh, ew, image.shape[2])).astype(image.dtype)
                sample["image"] = image
                return sample
        return sample


class ClassificationCollater:
    """dict samples -> {'image': [B, 3, H, W] float32, 'label': [B] int64}."""

    def __call__(self, samples):
        images = np.stack([s["image"] for s in samples]).astype(np.float32)
        labels = np.asarray([s["label"] for s in samples], dtype=np.int64)
        return {"image": torch.from_numpy(images).permute(0, 3, 1, 2)
                .contiguous(),
                "label": torch.from_numpy(labels)}


def load_state_dict(trained_model_path, model, excluded_layer_name=()):
    """Record a torch checkpoint to load after init.

    The path is kept on the model and applied by the engine's
    ``apply_pretrained`` after ``init_model``, name- and shape-filtered with
    a pos-embed resize, so the config's seeded init does not overwrite it.
    """
    if trained_model_path:
        model.pretrained_path = trained_model_path
        model.pretrained_excluded = tuple(excluded_layer_name)
    return model
