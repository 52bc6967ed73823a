"""Class-folder datasets (the port's copy of `Sample` and `ImageFolder` from
mgproto_tpu/data/folder.py).

Reference: torchvision `ImageFolder` (used inline, main.py:96-163) and
`MyImageFolder` adding file paths (utils/helpers.py:8-10). No import-time
I/O: a dataset scans its root at construction. PIL is imported where an
image is opened, so the module imports without Pillow (spawn loader
workers unpickle these datasets).
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
    sample_id: int  # global dataset index


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
        from PIL import Image

        s = self.samples[index]
        with Image.open(s.path) as img:
            img = img.convert("RGB")
            arr = (
                self.transform(img, rng) if self.transform is not None
                else np.asarray(img, np.float32) / 255.0
            )
        return arr, s.label, s.sample_id

    def path_of(self, sample_id: int) -> str:
        return self.samples[sample_id].path
