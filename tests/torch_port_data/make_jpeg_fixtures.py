"""Write the seeded JPEG fixtures of the port's decode checks.

    python tests/torch_port_data/make_jpeg_fixtures.py

Twelve photo-like 500x375 RGB images (smooth colour fields, a few shapes,
texture and grain at several scales), made from seeds 0-11 with numpy and
written by Pillow at quality 90 into ``jpeg/``, about ImageNet's mean file
size each. ``jpeg/means.json`` records each file's size, the per-channel
means of its pixels as the port's ``decode_jpeg`` decodes them, the
version of the libjpeg that decoded them and of the one that Pillow wrote
them with. ``chip_smoke.py`` holds the card machine's decode to those
means (within 1.0: libjpeg builds may round the IDCT differently), and
``tests/test_torch_port_jpeg_loader.py`` holds this machine's to them.
"""

import json
import sys
from pathlib import Path

import numpy as np
from PIL import Image, features

HERE = Path(__file__).resolve().parent
OUT = HERE / "jpeg"
N_IMAGES, WIDTH, HEIGHT, QUALITY = 12, 500, 375, 90


def _upsample(grid, h, w):
    """Bilinear upsampling of a [gh, gw, c] grid to [h, w, c]."""
    gh, gw = grid.shape[:2]
    ys = np.linspace(0, gh - 1, h)
    xs = np.linspace(0, gw - 1, w)
    y0 = np.floor(ys).astype(int).clip(0, gh - 2)
    x0 = np.floor(xs).astype(int).clip(0, gw - 2)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    top = grid[y0][:, x0] * (1 - wx) + grid[y0][:, x0 + 1] * wx
    bottom = grid[y0 + 1][:, x0] * (1 - wx) + grid[y0 + 1][:, x0 + 1] * wx
    return top * (1 - wy) + bottom * wy


def photo_like(seed):
    """One seeded RGB uint8 image [HEIGHT, WIDTH, 3]."""
    rs = np.random.RandomState(seed)
    image = np.zeros((HEIGHT, WIDTH, 3))
    # colour fields and texture at scales from the frame to a few pixels
    for cells, amplitude in ((3, 70.0), (8, 35.0), (24, 18.0), (80, 14.0)):
        grid = rs.standard_normal((cells + 1, cells * 4 // 3 + 1, 3))
        image += amplitude * _upsample(grid, HEIGHT, WIDTH)
    image += 128.0 + rs.uniform(-40, 40, 3)
    yy, xx = np.mgrid[:HEIGHT, :WIDTH]
    for _ in range(rs.randint(3, 7)):   # ellipses of flat-ish colour
        cy, cx = rs.uniform(0, HEIGHT), rs.uniform(0, WIDTH)
        ry, rx = rs.uniform(20, 120), rs.uniform(20, 160)
        inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
        image[inside] = 0.6 * image[inside] + 0.4 * rs.uniform(0, 255, 3)
    image += rs.standard_normal(image.shape) * 15.0    # sensor grain
    return np.clip(image, 0, 255).astype(np.uint8)


def main():
    sys.path.insert(0, str(HERE.parents[1]))
    from simpleaicv_pytorch_training_examples_tpu_torch.data.native_jpeg import (
        decode_jpeg)
    from simpleaicv_pytorch_training_examples_tpu_torch.native import (
        linked_libjpeg)
    OUT.mkdir(exist_ok=True)
    record = {"written_by": f"Pillow {Image.__version__}, libjpeg-turbo "
                            f"{features.version_feature('libjpeg_turbo')}",
              "quality": QUALITY, "images": {}}
    for seed in range(N_IMAGES):
        path = OUT / f"photo_{seed:02d}.jpg"
        Image.fromarray(photo_like(seed)).save(path, quality=QUALITY)
        pixels = decode_jpeg(str(path))
        record["images"][path.name] = {
            "bytes": path.stat().st_size, "shape": list(pixels.shape),
            "channel_means": [round(float(m), 4)
                              for m in pixels.reshape(-1, 3).mean(axis=0)]}
    record["decoded_by"] = f"libjpeg-turbo {linked_libjpeg()[1]}"
    (OUT / "means.json").write_text(json.dumps(record, indent=1) + "\n")


if __name__ == "__main__":
    main()
