"""Datasets (the port's copy of mgproto_tpu/data/folder.py): class-folder
trees and the CUB evaluation set.

Reference: torchvision `ImageFolder` (used inline, main.py:96-163),
`MyImageFolder` adding file paths (utils/helpers.py:8-10), and `Cub2011Eval`
adding CUB image ids (utils/datasets.py:7-57). No import-time I/O: a dataset
scans its root at construction. PIL is imported where an image is opened,
and pandas where `Cub2011Eval` joins its tables, so the module imports
without either (spawn loader workers unpickle these datasets).
"""

from __future__ import annotations

import os
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

IMG_EXTENSIONS = (
    ".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp",
)


class Sample(NamedTuple):
    path: str
    label: int
    sample_id: int  # global dataset index (or CUB img_id for Cub2011Eval)


class ImageFolder:
    """Class-per-subdirectory dataset, torchvision-compatible layout.

    Classes are the sorted subdirectory names (torchvision's convention, so
    label ids match checkpoints trained by the reference); file lists are
    sorted for a deterministic id <-> path mapping."""

    def __init__(
        self,
        root: str,
        transform: Optional[Callable] = None,
        extensions: Sequence[str] = IMG_EXTENSIONS,
    ):
        self.root = os.path.expanduser(root)
        self.transform = transform
        classes = sorted(e.name for e in os.scandir(self.root) if e.is_dir())
        if not classes:
            raise FileNotFoundError(f"no class directories under {self.root}")
        self.classes: List[str] = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Sample] = []
        exts = tuple(e.lower() for e in extensions)
        for c in classes:
            cdir = os.path.join(self.root, c)
            for dirpath, _, filenames in sorted(os.walk(cdir)):
                for fname in sorted(filenames):
                    if fname.lower().endswith(exts):
                        self.samples.append(Sample(
                            os.path.join(dirpath, fname), self.class_to_idx[c],
                            len(self.samples),
                        ))
        if not self.samples:
            raise FileNotFoundError(f"no images under {self.root}")

    def __len__(self) -> int:
        return len(self.samples)

    def load(
        self, index: int, rng: Optional[np.random.Generator] = None
    ) -> Tuple[np.ndarray, int, int]:
        return _load(self.samples[index], self.transform, rng)

    def path_of(self, sample_id: int) -> str:
        return self.samples[sample_id].path


def _load(s: Sample, transform: Optional[Callable], rng) -> Tuple[np.ndarray, int, int]:
    """(image array, label, id) of one sample: the transform's output, or
    the RGB pixels as f32 in [0, 1] without one."""
    from PIL import Image

    with Image.open(s.path) as img:
        img = img.convert("RGB")
        arr = (
            transform(img, rng) if transform is not None
            else np.asarray(img, np.float32) / 255.0
        )
    return arr, s.label, s.sample_id


class Cub2011Eval:
    """CUB-200-2011 with official ids, for part-annotation metrics.

    Reference utils/datasets.py:7-57: joins images.txt +
    image_class_labels.txt + train_test_split.txt; yields (img, target,
    img_id) with the OFFICIAL 1-based CUB img_id (needed to index the part
    annotation tables)."""

    base_folder = "images"

    def __init__(
        self, root: str, train: bool = True, transform: Optional[Callable] = None
    ):
        import pandas as pd

        self.root = os.path.expanduser(root)
        self.transform = transform
        images = pd.read_csv(
            os.path.join(self.root, "images.txt"),
            sep=" ", names=["img_id", "filepath"],
        )
        labels = pd.read_csv(
            os.path.join(self.root, "image_class_labels.txt"),
            sep=" ", names=["img_id", "target"],
        )
        split = pd.read_csv(
            os.path.join(self.root, "train_test_split.txt"),
            sep=" ", names=["img_id", "is_training_img"],
        )
        data = images.merge(labels, on="img_id").merge(split, on="img_id")
        data = data[data.is_training_img == (1 if train else 0)]
        self.samples = [
            Sample(
                os.path.join(self.root, self.base_folder, row.filepath),
                int(row.target) - 1,  # 1-based -> 0-based
                int(row.img_id),
            )
            for row in data.itertuples()
        ]

    def __len__(self) -> int:
        return len(self.samples)

    def load(
        self, index: int, rng: Optional[np.random.Generator] = None
    ) -> Tuple[np.ndarray, int, int]:
        return _load(self.samples[index], self.transform, rng)
