"""CUB-200-2011 part/bbox annotation tables (the port's copy of
mgproto_tpu/data/cub_parts.py; no torch, and PIL only where an image's size
is read).

Reference: utils/local_parts.py — which parses all tables at IMPORT time from
a hard-coded path (local_parts.py:14-81). Here the same tables are a class
constructed from a root directory (SURVEY.md §5.6: no import-time I/O).

Table semantics preserved exactly:
  * id_to_path: img_id -> (class_folder, file_name)
  * id_to_bbox: img_id -> (x1, y1, x2, y2), truncated-int pixel coords
  * id_to_part_loc: img_id -> [[part_id(1-based), x, y], ...] VISIBLE parts only
  * cls_to_id: 0-based class -> [img_id...]
  * id_to_train: img_id -> 1 (train) | 0 (test)
  * part_num: number of distinct part classes (15 for CUB)
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple


def read_images_txt(root: str) -> List[Tuple[int, str]]:
    """Raw images.txt rows: (img_id, 'class_folder/file.jpg')."""
    out: List[Tuple[int, str]] = []
    with open(os.path.join(root, "images.txt")) as f:
        for line in f:
            if line.strip():
                sid, path = line.split(" ", 1)
                out.append((int(sid), path.strip()))
    return out


def read_bounding_boxes(root: str) -> Dict[int, Tuple[float, float, float, float]]:
    """Raw bounding_boxes.txt: img_id -> (x, y, w, h) FLOATS as stored on
    disk. Consumers apply their own rounding (CubParts truncates to int per
    reference local_parts.py:33-40; crops keep floats)."""
    out: Dict[int, Tuple[float, float, float, float]] = {}
    with open(os.path.join(root, "bounding_boxes.txt")) as f:
        for line in f:
            if line.strip():
                sid, x, y, w, h = line.split()
                out[int(sid)] = (float(x), float(y), float(w), float(h))
    return out


def read_train_test_split(root: str) -> Dict[int, int]:
    """train_test_split.txt: img_id -> 1 (train) | 0 (test)."""
    out: Dict[int, int] = {}
    with open(os.path.join(root, "train_test_split.txt")) as f:
        for line in f:
            if line.strip():
                sid, is_train = line.split()
                out[int(sid)] = int(is_train)
    return out


def in_bbox(loc_yx: Tuple[int, int], bbox_yyxx: Tuple[int, int, int, int]) -> bool:
    """Is (y, x) inside (y1, y2, x1, x2)? (reference local_parts.py:10-11)."""
    y, x = loc_yx
    y1, y2, x1, x2 = bbox_yyxx
    return y1 <= y <= y2 and x1 <= x <= x2


class CubParts:
    """Parse the CUB metadata/part tables under `root` (the directory holding
    images.txt, bounding_boxes.txt, image_class_labels.txt,
    train_test_split.txt and parts/)."""

    def __init__(self, root: str):
        self.root = os.path.expanduser(root)

        self.id_to_path: Dict[int, Tuple[str, str]] = {}
        for sid, path in read_images_txt(self.root):
            folder, name = path.split("/", 1)
            self.id_to_path[sid] = (folder, name)

        # bbox floats truncated to int, x2/y2 = x+w, y+h
        # (reference local_parts.py:33-40)
        self.id_to_bbox: Dict[int, Tuple[int, int, int, int]] = {}
        for sid, (x, y, w, h) in read_bounding_boxes(self.root).items():
            x, y, w, h = int(x), int(y), int(w), int(h)
            self.id_to_bbox[sid] = (x, y, x + w, y + h)

        self.cls_to_id: Dict[int, List[int]] = {}
        with open(os.path.join(self.root, "image_class_labels.txt")) as f:
            for line in f:
                sid, cls = line.split()
                self.cls_to_id.setdefault(int(cls) - 1, []).append(int(sid))

        self.id_to_train: Dict[int, int] = read_train_test_split(self.root)

        self.part_id_to_part: Dict[int, str] = {}
        with open(os.path.join(self.root, "parts", "parts.txt")) as f:
            for line in f:
                pid, name = line.split(" ", 1)
                self.part_id_to_part[int(pid)] = name.strip()
        self.part_num: int = len(self.part_id_to_part)

        # visible parts only (reference local_parts.py:71-81)
        self.id_to_part_loc: Dict[int, List[List[int]]] = {}
        with open(os.path.join(self.root, "parts", "part_locs.txt")) as f:
            for line in f:
                sid, pid, x, y, visible = line.split()
                self.id_to_part_loc.setdefault(int(sid), [])
                if int(visible) == 1:
                    self.id_to_part_loc[int(sid)].append(
                        [int(pid), int(float(x)), int(float(y))]
                    )

    def image_path(self, img_id: int) -> str:
        folder, name = self.id_to_path[img_id]
        return os.path.join(self.root, "images", folder, name)

    def orig_wh(self, img_id: int) -> Tuple[int, int]:
        """Original (width, height), cached — reading the header once per
        image instead of re-opening it for every metric pass."""
        cache = getattr(self, "_wh_cache", None)
        if cache is None:
            cache = self._wh_cache = {}
        if img_id not in cache:
            from PIL import Image

            with Image.open(self.image_path(img_id)) as im:
                cache[img_id] = im.size
        return cache[img_id]

    def scaled_part_labels(
        self, img_id: int, orig_wh: Tuple[int, int], img_size: int
    ) -> Tuple[List[List[int]], "list"]:
        """Part labels rescaled from the ORIGINAL full-image pixel grid to a
        (img_size, img_size) resize, plus the part-presence mask.

        Reference interpretability.py:95-105: ratio against the original
        image size, int truncation; 1-based part ids become 0-based."""
        import numpy as np

        w, h = orig_wh
        part_mask = np.zeros((self.part_num,))
        out: List[List[int]] = []
        for pid, x, y in self.id_to_part_loc.get(img_id, []):
            part_mask[pid - 1] = 1
            out.append(
                [pid - 1, int(img_size * x / w), int(img_size * y / h)]
            )
        return out, part_mask
