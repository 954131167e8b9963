"""ImageNet preprocessing. Counterpart of
``perceiver_io_tpu/data/vision/imagenet.py`` (a copy): resize the shorter
side -> center crop (eval) or random crop + flip (train) -> channels-last
float normalization with ImageNet statistics. Pure numpy bilinear resize
(no torchvision or PIL); inputs are uint8 HWC arrays.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def resize_bilinear(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """(h, w, c) → (H, W, c) bilinear resize (align_corners=False)."""
    h, w = img.shape[:2]
    out_h, out_w = out_hw
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]

    img = img.astype(np.float32)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


class ImageNetPreprocessor:
    """uint8 HWC image(s) → normalized (b, crop, crop, 3) float32.

    :param resize_to: shorter-side target before cropping.
    :param crop: output square size.
    """

    def __init__(self, resize_to: int = 256, crop: int = 224, *,
                 mean: np.ndarray = IMAGENET_MEAN, std: np.ndarray = IMAGENET_STD):
        self.resize_to = resize_to
        self.crop = crop
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def _one(self, img: np.ndarray, rng: np.random.Generator = None) -> np.ndarray:
        img = np.asarray(img)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        h, w = img.shape[:2]
        scale = self.resize_to / min(h, w)
        img = resize_bilinear(img, (round(h * scale), round(w * scale)))
        h, w = img.shape[:2]
        if rng is None:  # center crop
            y0 = (h - self.crop) // 2
            x0 = (w - self.crop) // 2
        else:  # random crop + horizontal flip
            y0 = int(rng.integers(0, h - self.crop + 1))
            x0 = int(rng.integers(0, w - self.crop + 1))
        img = img[y0 : y0 + self.crop, x0 : x0 + self.crop]
        if rng is not None and rng.random() < 0.5:
            img = img[:, ::-1]
        return img

    def __call__(self, images, *, rng: np.random.Generator = None) -> np.ndarray:
        if isinstance(images, np.ndarray) and images.ndim <= 3:
            images = [images]
        out = np.stack([self._one(im, rng) for im in images])
        out = out / 255.0
        return ((out - self.mean) / self.std).astype(np.float32)
