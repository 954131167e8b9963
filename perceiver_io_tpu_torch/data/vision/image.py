"""Image preprocessing and the MNIST / synthetic image data modules.
Counterpart of ``perceiver_io_tpu/data/vision/image.py`` (a copy over the
port's loader): channels-last uint8 -> normalized float32, optional
train-time augmentation, and data modules yielding ``{"image": (b, h, w, c)
f32, "label": (b,) i32}`` numpy batches, the input contract of
:class:`perceiver_io_tpu_torch.models.vision.ImageClassifier`.

Everything is numpy on the host; batches have static shapes (drop_last).
``load_arrays()`` reads MNIST from a local HF datasets cache (``datasets``
is imported there only); ``from_arrays(...)`` injects arrays directly.
Nothing is downloaded.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from perceiver_io_tpu_torch.data.loader import DataLoader

# Reference normalization (perceiver/data/vision/mnist.py:28-31): mean/std of
# MNIST pixels in [0, 1].
MNIST_MEAN = 0.1307
MNIST_STD = 0.3081


def random_crop_and_flip(
    images: np.ndarray,
    rng: np.random.Generator,
    *,
    pad: int = 2,
    flip: bool = False,
) -> np.ndarray:
    """Batched random-shift crop (zero-pad by ``pad`` then crop back) and
    optional horizontal flip — the standard small-image augmentation
    (reference uses RandomCrop via torchvision, ``mnist.py:33-39``)."""
    b, h, w, c = images.shape
    padded = np.zeros((b, h + 2 * pad, w + 2 * pad, c), images.dtype)
    padded[:, pad : pad + h, pad : pad + w] = images
    ys = rng.integers(0, 2 * pad + 1, size=b)
    xs = rng.integers(0, 2 * pad + 1, size=b)
    out = np.empty_like(images)
    for idx in range(b):  # b is a host batch; cost is negligible vs the step
        out[idx] = padded[idx, ys[idx] : ys[idx] + h, xs[idx] : xs[idx] + w]
    if flip:
        do_flip = rng.random(b) < 0.5
        out[do_flip] = out[do_flip, :, ::-1]
    return out


class ImagePreprocessor:
    """uint8 channels-last image → normalized float32 model input
    (single-image inference entry, reference ``perceiver/data/vision/common.py``)."""

    def __init__(self, mean: float = MNIST_MEAN, std: float = MNIST_STD):
        self.mean = mean
        self.std = std

    def __call__(self, images: np.ndarray) -> np.ndarray:
        x = np.asarray(images)
        if x.ndim == 2:  # single grayscale image
            x = x[None, :, :, None]
        elif x.ndim == 3 and x.shape[-1] in (1, 3):  # single image
            x = x[None]
        elif x.ndim == 3:  # batch of grayscale
            x = x[..., None]
        x = x.astype(np.float32) / 255.0
        return (x - self.mean) / self.std


class _ImageDataset:
    def __init__(self, images: np.ndarray, labels: np.ndarray):
        assert len(images) == len(labels)
        self.images = images
        self.labels = labels

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int) -> Dict:
        return {"image": self.images[idx], "label": self.labels[idx]}


class MNISTDataModule:
    """MNIST datamodule: 28×28×1 channels-last, normalized, shuffled static
    batches (reference ``perceiver/data/vision/mnist.py:17-96``).

    :param augment: random-shift crop on the train split.
    """

    image_shape: Tuple[int, int, int] = (28, 28, 1)
    num_classes: int = 10

    def __init__(
        self,
        batch_size: int = 64,
        *,
        augment: bool = True,
        seed: int = 0,
        shard_index: Optional[int] = None,
        shard_count: Optional[int] = None,
    ):
        self.batch_size = batch_size
        self.augment = augment
        self.seed = seed
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.preprocessor = ImagePreprocessor()
        self._splits: Dict[str, _ImageDataset] = {}

    # -- sourcing ----------------------------------------------------------
    @classmethod
    def from_arrays(
        cls,
        train: Tuple[np.ndarray, np.ndarray],
        valid: Tuple[np.ndarray, np.ndarray],
        test: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        **kwargs,
    ) -> "MNISTDataModule":
        dm = cls(**kwargs)
        dm._splits = {
            "train": _ImageDataset(*train),
            "valid": _ImageDataset(*valid),
        }
        if test is not None:
            dm._splits["test"] = _ImageDataset(*test)
        return dm

    def load_arrays(self) -> None:
        """Load MNIST from the local HF datasets cache.

        MNIST publishes train + test only; following the reference, ``valid``
        is the official test set (reference ``mnist.py:60``), and the
        ``test`` split materializes that same official set for the CLI
        ``test`` subcommand — the split the reference's MNIST val_acc numbers
        are reported on."""
        import datasets

        ds = datasets.load_dataset("mnist")
        for split, name in (("train", "train"), ("valid", "test")):
            imgs = np.stack([np.asarray(im) for im in ds[name]["image"]])[..., None]
            labels = np.asarray(ds[name]["label"], np.int64)
            self._splits[split] = _ImageDataset(imgs, labels)
        self._splits["test"] = self._splits["valid"]  # same official set, one copy

    def prepare_data(self) -> None:
        """Source acquisition phase (the CLI calls this before ``setup``)."""
        if not self._splits:
            self.load_arrays()

    def setup(self) -> None:
        if not self._splits:
            self.load_arrays()

    # -- loaders -----------------------------------------------------------
    def _collate(self, train: bool):
        aug_rng = np.random.default_rng(self.seed + 1)

        def collate(examples):
            images = np.stack([e["image"] for e in examples]).astype(np.uint8)
            labels = np.asarray([e["label"] for e in examples], np.int32)
            if train and self.augment:
                images = random_crop_and_flip(images, aug_rng)
            return {"image": self.preprocessor(images), "label": labels}

        return collate

    def _loader(self, split: str, shuffle: bool) -> DataLoader:
        return DataLoader(
            self._splits[split],
            batch_size=self.batch_size,
            shuffle=shuffle,
            drop_last=True,
            collate_fn=self._collate(train=shuffle),
            seed=self.seed,
            shard_index=self.shard_index,
            shard_count=self.shard_count,
        )

    def train_dataloader(self) -> DataLoader:
        return self._loader("train", shuffle=True)

    def val_dataloader(self) -> DataLoader:
        return self._loader("valid", shuffle=False)

    def test_dataloader(self) -> DataLoader:
        if "test" not in self._splits:
            raise ValueError(
                f"{type(self).__name__} has no test split — from_arrays was "
                "called without test arrays"
            )
        return self._loader("test", shuffle=False)


class SyntheticImageDataModule(MNISTDataModule):
    """Deterministic synthetic images — offline smoke runs and config
    dry-runs (no reference counterpart; its MNIST module must download).
    The label places a bright patch on a 2×5 grid over a noise floor, so the
    10-way task is trivially learnable and accuracy visibly climbs."""

    def __init__(
        self,
        batch_size: int = 64,
        *,
        num_train: int = 512,
        num_valid: int = 128,
        num_test: int = 128,
        **kwargs,
    ):
        super().__init__(batch_size, **kwargs)
        self._sizes = {"train": num_train, "valid": num_valid, "test": num_test}

    def prepare_data(self) -> None:  # synthetic: nothing to acquire
        self.setup()

    def setup(self) -> None:
        if not self._splits:
            rng = np.random.default_rng(self.seed)
            h, w, c = self.image_shape

            def split(n):
                labels = rng.integers(0, self.num_classes, size=n)
                imgs = rng.integers(0, 48, size=(n, h, w, c), dtype=np.int64)
                rows, cols = labels // 5, labels % 5
                for i in range(n):
                    r0, c0 = 2 + int(rows[i]) * 14, 1 + int(cols[i]) * 5
                    imgs[i, r0 : r0 + 8, c0 : c0 + 4] = 220
                return imgs.astype(np.uint8), labels.astype(np.int64)

            self._splits = {
                name: _ImageDataset(*split(n))
                for name, n in self._sizes.items()
                if n > 0
            }
        super().setup()
