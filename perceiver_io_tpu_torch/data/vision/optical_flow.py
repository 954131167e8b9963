"""Optical-flow pre- and post-processing on the host, in NumPy. Counterpart
of ``perceiver_io_tpu/data/vision/optical_flow.py`` (the same code, kept
here so the port imports nothing of the JAX package):

- **patch grid**: stride ``patch_size - min_overlap`` in each axis, the
  last index clamped to ``dim - patch_size`` so patches tile the image with
  at least ``min_overlap`` pixels of overlap; duplicate indices are dropped.
- **preprocess**: frames normalized ``x/255*2-1``; for every pixel its 3x3
  neighborhood (SAME zero padding) is stacked into channels in
  ``(ky, kx, c)`` order, 27 channels for RGB (torch
  ``unfold(2,3).unfold(3,3).permute(0,4,5,1,2,3)`` order). Output
  ``(P, 2, 27, ph, pw)`` per pair.
- **postprocess**: per-patch flow x ``flow_scale_factor``, blended with the
  pyramid weight ``min(x+1, W-x, y+1, H-y)`` and normalized by the summed
  weights.
- **render**: flow -> HSV (hue = angle, saturation by magnitude/24, value
  255) -> RGB, as cv2 renders it, without cv2.

The model forward that :meth:`OpticalFlowProcessor.process` calls is any
callable ``(p, 2, 27, ph, pw) float32 -> (p, ph, pw, 2)``; micro-batches are
zero-padded to one shape.
"""
from __future__ import annotations

import itertools
from typing import Callable, List, Sequence, Tuple

import numpy as np


class OpticalFlowProcessor:
    def __init__(
        self,
        patch_size: Tuple[int, int] = (368, 496),
        patch_min_overlap: int = 20,
        flow_scale_factor: int = 20,
    ):
        if patch_min_overlap >= patch_size[0] or patch_min_overlap >= patch_size[1]:
            raise ValueError(
                f"patch_min_overlap={patch_min_overlap} must be smaller than "
                f"patch_size={patch_size}"
            )
        self.patch_size = patch_size
        self.patch_min_overlap = patch_min_overlap
        self.flow_scale_factor = flow_scale_factor

    # -- grid --------------------------------------------------------------
    def grid_indices(self, image_shape: Tuple[int, ...]) -> List[Tuple[int, int]]:
        ph, pw = self.patch_size
        ys = list(range(0, image_shape[0], ph - self.patch_min_overlap))
        xs = list(range(0, image_shape[1], pw - self.patch_min_overlap))
        ys[-1] = image_shape[0] - ph
        xs[-1] = image_shape[1] - pw
        # The reference keeps duplicate indices when patches fit exactly
        # (clamping the last stride onto an earlier one) and runs the model
        # on identical patches twice; dedup is an intentional deviation —
        # pre/post always use this same grid, so blending is unaffected.
        ys = sorted(set(ys))
        xs = sorted(set(xs))
        return list(itertools.product(ys, xs))

    # -- preprocess --------------------------------------------------------
    @staticmethod
    def _pixel_features(img: np.ndarray) -> np.ndarray:
        """(c, h, w) normalized frame → (9c, h, w): each pixel's 3×3
        neighborhood stacked into channels in (ky, kx, c) order."""
        c, h, w = img.shape
        padded = np.zeros((c, h + 2, w + 2), img.dtype)
        padded[:, 1:-1, 1:-1] = img
        windows = np.lib.stride_tricks.sliding_window_view(padded, (3, 3), axis=(1, 2))
        # windows: (c, h, w, 3, 3) -> (ky, kx, c, h, w) -> (9c, h, w)
        return windows.transpose(3, 4, 0, 1, 2).reshape(9 * c, h, w)

    def preprocess(self, image_pair: Sequence[np.ndarray]) -> np.ndarray:
        """One frame pair (two (h, w, c) or (h, w) uint8/float arrays) →
        ``(num_patches, 2, 9c, ph, pw)`` float32 patch features."""
        img1, img2 = (np.asarray(im) for im in image_pair)
        if img1.shape != img2.shape:
            raise ValueError(f"frame shapes differ: {img1.shape} vs {img2.shape}")
        h, w = img1.shape[:2]
        ph, pw = self.patch_size
        if h < ph or w < pw:
            raise ValueError(f"image {img1.shape} smaller than patch {self.patch_size}")

        frames = []
        for img in (img1, img2):
            x = img.astype(np.float32) / 255.0 * 2.0 - 1.0
            if x.ndim == 2:
                x = x[None]
            else:
                x = x.transpose(2, 0, 1)  # channels-first
            frames.append(self._pixel_features(x))
        features = np.stack(frames)  # (2, 9c, h, w)

        patches = [
            features[..., y : y + ph, x : x + pw] for y, x in self.grid_indices((h, w))
        ]
        return np.stack(patches)

    def preprocess_batch(self, image_pairs: Sequence[Sequence[np.ndarray]]) -> np.ndarray:
        """Batch of pairs → ``(b, num_patches, 2, 9c, ph, pw)``."""
        shapes = {np.asarray(im).shape for pair in image_pairs for im in pair}
        if len(shapes) != 1:
            raise ValueError(f"all frames must share one shape, got {shapes}")
        return np.stack([self.preprocess(pair) for pair in image_pairs])

    # -- postprocess -------------------------------------------------------
    def _patch_weights(self) -> np.ndarray:
        ph, pw = self.patch_size
        wy = np.minimum(np.arange(ph) + 1, ph - np.arange(ph))[:, None]
        wx = np.minimum(np.arange(pw) + 1, pw - np.arange(pw))[None, :]
        return np.minimum(wy, wx).astype(np.float32)[..., None]  # (ph, pw, 1)

    def postprocess(self, predictions: np.ndarray, image_shape: Tuple[int, ...]) -> np.ndarray:
        """``(p, ph, pw, 2)`` or ``(b, p, ph, pw, 2)`` patch predictions →
        ``(b, height, width, 2)`` blended flow."""
        preds = np.asarray(predictions, np.float32)
        if preds.ndim == 4:
            preds = preds[None]
        h, w = image_shape[0], image_shape[1]
        grid = self.grid_indices(image_shape)
        b, p = preds.shape[:2]
        if p != len(grid):
            raise ValueError(f"got {p} patches, grid expects {len(grid)}")

        ph, pw = self.patch_size
        weights = self._patch_weights()
        flow = np.zeros((b, h, w, 2), np.float32)
        total = np.zeros((1, h, w, 1), np.float32)
        for patch_idx, (y, x) in enumerate(grid):
            flow[:, y : y + ph, x : x + pw] += (
                preds[:, patch_idx] * self.flow_scale_factor * weights
            )
            total[:, y : y + ph, x : x + pw] += weights
        return flow / total

    # -- end to end --------------------------------------------------------
    def process(
        self,
        model_fn: Callable[[np.ndarray], np.ndarray],
        image_pairs: Sequence[Sequence[np.ndarray]],
        batch_size: int = 1,
    ) -> np.ndarray:
        """preprocess → micro-batched ``model_fn`` → blend. ``model_fn`` maps
        ``(batch_size, 2, 9c, ph, pw)`` → ``(batch_size, ph, pw, 2)``; the
        final micro batch is zero-padded to keep the compiled shape static."""
        image_shape = np.asarray(image_pairs[0][0]).shape
        features = self.preprocess_batch(image_pairs)  # (b, p, 2, 9c, ph, pw)
        b, p = features.shape[:2]
        flat = features.reshape(b * p, *features.shape[2:])

        outputs = []
        for start in range(0, len(flat), batch_size):
            chunk = flat[start : start + batch_size]
            pad = batch_size - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, np.zeros((pad, *chunk.shape[1:]), chunk.dtype)])
            out = np.asarray(model_fn(chunk))
            outputs.append(out[: batch_size - pad])
        preds = np.concatenate(outputs).reshape(b, p, *outputs[0].shape[1:])
        return self.postprocess(preds, image_shape)


def render_optical_flow(flow: np.ndarray) -> np.ndarray:
    """(h, w, 2) flow → (h, w, 3) uint8 RGB (hue = direction, saturation =
    magnitude), matching the reference's cv2 HSV rendering
    (``optical_flow.py:243-253``)."""
    fx, fy = flow[..., 0], flow[..., 1]
    mag = np.sqrt(fx * fx + fy * fy)
    ang = np.arctan2(fy, fx)  # cv2.cartToPolar: [0, 2pi)
    ang = np.where(ang < 0, ang + 2 * np.pi, ang)

    hue_deg = ang / np.pi / 2 * 180  # reference scales to [0, 180) (cv2 hue)
    sat = np.clip(mag * 255.0 / 24.0, 0, 255) / 255.0
    val = np.ones_like(sat)

    # HSV -> RGB with hue in cv2's [0, 180) half-degrees convention.
    h6 = (hue_deg * 2.0 / 60.0) % 6.0
    c = val * sat
    x = c * (1 - np.abs(h6 % 2 - 1))
    zeros = np.zeros_like(c)
    idx = h6.astype(np.int32) % 6
    r = np.select([idx == 0, idx == 1, idx == 2, idx == 3, idx == 4, idx == 5],
                  [c, x, zeros, zeros, x, c])
    g = np.select([idx == 0, idx == 1, idx == 2, idx == 3, idx == 4, idx == 5],
                  [x, c, c, x, zeros, zeros])
    b = np.select([idx == 0, idx == 1, idx == 2, idx == 3, idx == 4, idx == 5],
                  [zeros, zeros, x, c, c, x])
    m = val - c
    rgb = np.stack([r + m, g + m, b + m], axis=-1)
    return (rgb * 255.0).astype(np.uint8)
