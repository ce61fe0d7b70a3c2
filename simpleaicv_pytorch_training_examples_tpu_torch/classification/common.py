"""Classification eval transforms, collater and checkpoint hook.

Counterpart of the parts of the JAX package's ``classification/common.py``
that the eval configs use (``test_dataset`` transforms, ``test_collater``,
``load_state_dict``). Transforms are host-side numpy ops over dict samples
``{'image': HWC array, 'label': int}``; the collater hands out torch
tensors: NCHW float32 images and int64 labels. The training transforms come
with the training slice.
"""

import numpy as np
import torch

__all__ = ["Opencv2PIL", "TorchMeanStdNormalize", "TorchResize",
           "TorchCenterCrop", "ClassificationCollater", "load_state_dict"]


class Opencv2PIL:
    """No-op adapter (images stay numpy HWC throughout)."""

    def __call__(self, sample):
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
