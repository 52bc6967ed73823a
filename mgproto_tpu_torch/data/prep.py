"""Offline dataset preparation (a copy of mgproto_tpu/data/prep.py).

Reference: preprocess_data/{cropimages,cropimages_cars,cropmasks,
preprocess_mask,img_aug,img_aug_cars,img_pets}.py — seven hard-coded-path
scripts. Here each is a parameterized function behind `mgproto_tpu_torch.cli.prep`.

Differences by design: crops are written to NEW trees (the reference
OVERWRITES its source images in place, cropimages.py:24-27 — destructive and
unrepeatable); offline augmentation reimplements the reference's four
Augmentor pipelines (img_aug.py:23-50: rotate/skew/shear/grid-distortion,
each x10 with 50% h-flip) in PIL+numpy, seeded and deterministic.
"""

from __future__ import annotations

import os
import shutil
import zlib
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image

BICUBIC = Image.Resampling.BICUBIC
BILINEAR = Image.Resampling.BILINEAR


# ------------------------------------------------------------------ CUB crop
def _load_cub_index(cub_root: str):
    """([(img_id, rel_path)...], img_id -> float bbox, img_id -> is_train)
    from the CUB txts — one shared parser with the parts tables
    (data/cub_parts.py)."""
    from mgproto_tpu_torch.data.cub_parts import (
        read_bounding_boxes,
        read_images_txt,
        read_train_test_split,
    )

    return (
        read_images_txt(cub_root),
        read_bounding_boxes(cub_root),
        read_train_test_split(cub_root),
    )


def crop_cub(
    cub_root: str, out_root: str, quality: int = 95, limit: Optional[int] = None
) -> Tuple[int, int]:
    """Bbox-crop every CUB image into out_root/{train,test}_cropped/<class>/
    (reference cropimages.py semantics, non-destructive). Returns
    (n_train, n_test)."""
    names, boxes, split = _load_cub_index(cub_root)
    counts = [0, 0]
    for img_id, rel in names[: limit if limit else len(names)]:
        x, y, w, h = boxes[img_id]
        dest = "train_cropped" if split[img_id] == 1 else "test_cropped"
        out_path = os.path.join(out_root, dest, rel)
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with Image.open(os.path.join(cub_root, "images", rel)) as im:
            im.crop((x, y, x + w, y + h)).save(out_path, quality=quality)
        counts[0 if split[img_id] == 1 else 1] += 1
    return counts[0], counts[1]


def crop_cub_masks(
    cub_root: str, seg_root: str, out_root: str, limit: Optional[int] = None
) -> int:
    """Bbox-crop the CUB segmentation PNGs into out_root/mask_{train,test}/
    class trees (reference cropmasks.py, non-destructive)."""
    names, boxes, split = _load_cub_index(cub_root)
    n = 0
    for img_id, rel in names[: limit if limit else len(names)]:
        mask_rel = rel.rsplit(".", 1)[0] + ".png"
        x, y, w, h = boxes[img_id]
        dest = "mask_train" if split[img_id] == 1 else "mask_test"
        out_path = os.path.join(out_root, dest, mask_rel)
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with Image.open(os.path.join(seg_root, mask_rel)) as im:
            im.crop((x, y, x + w, y + h)).save(out_path)
        n += 1
    return n


def binarize_masks(src_root: str, dst_root: str) -> int:
    """Foreground extraction (reference preprocess_mask.py:24-40): the two
    lowest gray levels (background + border) become 0, everything else 255."""
    n = 0
    for dirpath, _dirs, files in os.walk(src_root):
        for fname in sorted(files):
            if not fname.lower().endswith(".png"):
                continue
            src = os.path.join(dirpath, fname)
            with Image.open(src) as im:
                mask = np.asarray(im.convert("L"))
            levels = np.sort(np.unique(mask))
            # the two lowest levels are background + border (reference
            # preprocess_mask.py:28 "0 and 51") — but a clean binary mask
            # has only {bg, fg}, where only the lowest is background
            n_bg = 2 if len(levels) > 2 else 1
            fg = ~np.isin(mask, levels[:n_bg])
            out = os.path.join(dst_root, os.path.relpath(src, src_root))
            os.makedirs(os.path.dirname(out), exist_ok=True)
            Image.fromarray((fg * 255).astype(np.uint8)).save(out)
            n += 1
    return n


# ---------------------------------------------------------------- Cars crop
def crop_cars(
    annos_mat: str, images_root: str, out_root: str, quality: int = 95
) -> int:
    """Stanford Cars bbox crop into 3-digit class folders, train/test split
    from the annotation table (reference cropimages_cars.py: indicator 0 =
    train, 1 = test)."""
    import scipy.io

    mat = scipy.io.loadmat(annos_mat)["annotations"][0]
    n = 0
    for info in mat:
        name = str(info[0][0])
        x1, y1, x2, y2 = (int(info[i]) for i in range(1, 5))
        cls = int(info[-2])
        is_test = int(info[-1]) == 1
        dest = "test_cropped" if is_test else "train_cropped"
        out_path = os.path.join(
            out_root, dest, f"{cls:03d}", os.path.basename(name)
        )
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with Image.open(os.path.join(images_root, name)) as im:
            im.crop((x1, y1, x2, y2)).save(out_path, quality=quality)
        n += 1
    return n


# --------------------------------------------------------------------- Pets
def build_pets(img_dir: str, label_file: str, out_dir: str) -> int:
    """Class-folder tree from an Oxford-IIIT Pets annotation list
    (reference img_pets.py: `<name> <class_id> ...` lines; images copied to
    out_dir/<class_id>/<name>.jpg)."""
    n = 0
    for line in open(label_file):
        info = line.strip().split(" ")
        if not info[0] or info[0].startswith("#"):
            continue
        src = os.path.join(img_dir, info[0] + ".jpg")
        dst = os.path.join(out_dir, info[1], info[0] + ".jpg")
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copyfile(src, dst)
        n += 1
    return n


# ------------------------------------------------------- offline augmentation
def _rotate_crop(img: Image.Image, rng: np.random.Generator, max_deg: float = 15.0):
    """Rotate then crop the largest inscribed axis-aligned rectangle and
    resize back (Augmentor rotate semantics — no black corners)."""
    deg = float(rng.uniform(-max_deg, max_deg))
    w, h = img.size
    out = img.rotate(deg, resample=BICUBIC, expand=True)
    # largest inscribed rectangle of a rotated rectangle
    a = abs(np.deg2rad(deg))
    if w <= 0 or h <= 0:
        return img
    long_side, short_side = max(w, h), min(w, h)
    sin_a, cos_a = np.sin(a), np.cos(a)
    if short_side <= 2.0 * sin_a * cos_a * long_side or abs(sin_a - cos_a) < 1e-10:
        x = 0.5 * short_side
        wr, hr = (x / sin_a, x / cos_a) if w >= h else (x / cos_a, x / sin_a)
    else:
        cos_2a = cos_a * cos_a - sin_a * sin_a
        wr = (w * cos_a - h * sin_a) / cos_2a
        hr = (h * cos_a - w * sin_a) / cos_2a
    ow, oh = out.size
    left, top = (ow - wr) / 2.0, (oh - hr) / 2.0
    return out.crop((left, top, left + wr, top + hr)).resize((w, h), BICUBIC)


def _skew(img: Image.Image, rng: np.random.Generator, magnitude: float = 0.2):
    """Random corner-perspective tilt (Augmentor skew magnitude 0.2)."""
    w, h = img.size
    dx, dy = magnitude * w, magnitude * h
    src = [(0, 0), (w, 0), (w, h), (0, h)]
    dst = [
        (
            float(x + rng.uniform(0, dx) * (1 if x == 0 else -1)),
            float(y + rng.uniform(0, dy) * (1 if y == 0 else -1)),
        )
        for x, y in src
    ]
    # solve the 8-dof projective map dst -> src for Image.transform
    mat = []
    for (x, y), (u, v) in zip(dst, src):
        mat.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        mat.append([0, 0, 0, x, y, 1, -v * x, -v * y])
    a = np.asarray(mat, np.float64)
    b = np.asarray([c for uv in src for c in uv], np.float64)
    coeffs = np.linalg.solve(a, b)
    return img.transform((w, h), Image.Transform.PERSPECTIVE, coeffs, BICUBIC)


def _shear(img: Image.Image, rng: np.random.Generator, max_deg: float = 10.0):
    """Horizontal or vertical shear up to +-max_deg (Augmentor shear)."""
    w, h = img.size
    deg = float(rng.uniform(-max_deg, max_deg))
    t = np.tan(np.deg2rad(deg))
    if rng.uniform() < 0.5:
        coeffs = (1, t, -t * h / 2, 0, 1, 0)  # x-shear about center
    else:
        coeffs = (1, 0, 0, t, 1, -t * w / 2)  # y-shear
    return img.transform((w, h), Image.Transform.AFFINE, coeffs, BICUBIC)


def _grid_distortion(
    img: Image.Image,
    rng: np.random.Generator,
    grid: int = 10,
    magnitude: float = 5.0,
):
    """Elastic grid distortion (Augmentor random_distortion grid 10x10,
    magnitude 5): jitter interior grid nodes, map each cell as a quad mesh."""
    w, h = img.size
    gx = np.linspace(0, w, grid + 1)
    gy = np.linspace(0, h, grid + 1)
    disp = rng.uniform(-magnitude, magnitude, size=(grid + 1, grid + 1, 2))
    disp[0, :] = disp[-1, :] = 0  # pin the borders
    disp[:, 0] = disp[:, -1] = 0
    mesh = []
    for j in range(grid):
        for i in range(grid):
            box = (int(gx[i]), int(gy[j]), int(gx[i + 1]), int(gy[j + 1]))
            quad = []
            for jj, ii in ((j, i), (j + 1, i), (j + 1, i + 1), (j, i + 1)):
                quad.extend(
                    [gx[ii] + disp[jj, ii, 0], gy[jj] + disp[jj, ii, 1]]
                )
            mesh.append((box, tuple(quad)))
    return img.transform((w, h), Image.Transform.MESH, mesh, BICUBIC)


_AUG_OPS = {
    "rotate": _rotate_crop,
    "skew": _skew,
    "shear": _shear,
    "distortion": _grid_distortion,
}


def augment_offline(
    src_dir: str,
    dst_dir: str,
    copies_per_op: int = 10,
    seed: int = 0,
    ops: Optional[List[str]] = None,
) -> int:
    """Offline augmentation of a class-folder tree (reference img_aug.py):
    for each image, `copies_per_op` variants of each op, each with a 50%
    horizontal flip — 4 ops x 10 copies = the reference's 40x expansion.
    Deterministic per (seed, class, file, op, copy). Returns files written."""
    op_names = ops if ops is not None else list(_AUG_OPS)
    if not op_names:
        raise ValueError("ops must name at least one augmentation")
    n = 0
    classes = sorted(
        e.name for e in os.scandir(src_dir) if e.is_dir()
    )
    for cls in classes:
        out_cls = os.path.join(dst_dir, cls)
        os.makedirs(out_cls, exist_ok=True)
        files = sorted(
            f for f in os.listdir(os.path.join(src_dir, cls))
            if f.lower().endswith((".jpg", ".jpeg", ".png"))
        )
        for fname in files:
            with Image.open(os.path.join(src_dir, cls, fname)) as im:
                img = im.convert("RGB")
                # keep the source extension in the stem so a.jpg and a.png
                # don't collide on identical output names
                base, ext = os.path.splitext(fname)
                stem = f"{base}_{ext.lstrip('.').lower()}"
                for op_name in op_names:
                    op = _AUG_OPS[op_name]
                    for c in range(copies_per_op):
                        # crc32, not hash(): python str hashing is salted
                        # per process and would break run-to-run determinism
                        key = f"{seed}/{cls}/{fname}/{op_name}/{c}"
                        rng = np.random.default_rng(
                            zlib.crc32(key.encode())
                        )
                        out = op(img, rng)
                        if rng.uniform() < 0.5:
                            out = out.transpose(
                                Image.Transpose.FLIP_LEFT_RIGHT
                            )
                        out.save(
                            os.path.join(
                                out_cls, f"{stem}_{op_name}{c}.jpg"
                            ),
                            quality=95,
                        )
                        n += 1
    return n
