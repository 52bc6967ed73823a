"""The port's offline data preparation (mgproto_tpu_torch/data/prep.py and
the `prep` subcommands of mgproto_tpu_torch/cli/prep.py) against the JAX
package's, on the CPU, on the seeded trees of tests/test_prep.py.

Every output file is byte-equal to the JAX package's (the same PIL and
numpy calls on the same inputs), and the counts returned are equal: the
CUB crops and mask crops, the binarized masks (three-level and two-level),
the Pets class tree, the Stanford Cars crop (a `cars_annos.mat` written
with scipy), and the seeded 4-op offline augmentation (each op alone, and
all four).
"""

import os

import numpy as np
import pytest
from PIL import Image

from mgproto_tpu.data import prep as jprep
from mgproto_tpu_torch.cli import prep as cli_prep
from mgproto_tpu_torch.data import prep as tprep


def _files(root):
    """{relative path: bytes} of every file under `root`."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _same_outputs(fn_name, tmp_path, *args, **kw):
    """Run `fn_name` of both packages into two output roots (the last
    positional argument); assert equal returns and byte-equal trees."""
    outs = []
    for pkg, tag in ((jprep, "jax"), (tprep, "port")):
        out = str(tmp_path / f"out_{tag}")
        outs.append((getattr(pkg, fn_name)(*args, out, **kw), _files(out)))
    (ret_j, files_j), (ret_p, files_p) = outs
    assert ret_p == ret_j
    assert files_p.keys() == files_j.keys() and files_p
    for k in files_j:
        assert files_p[k] == files_j[k], k
    return ret_p


@pytest.fixture()
def cub_tree(tmp_path):
    """CUB-layout root: 2 classes x 2 images + segmentations (tests/test_prep.py)."""
    root = tmp_path / "CUB"
    seg = tmp_path / "segs"
    rng = np.random.RandomState(0)
    images, boxes, split = [], [], []
    iid = 0
    for c in range(2):
        folder = f"{c + 1:03d}.C{c}"
        os.makedirs(root / "images" / folder)
        os.makedirs(seg / folder)
        for i in range(2):
            iid += 1
            rel = f"{folder}/im{i}.jpg"
            Image.fromarray(rng.randint(0, 255, (40, 60, 3), dtype=np.uint8)).save(
                root / "images" / rel)
            m = np.zeros((40, 60), np.uint8)  # 0 bg, 128 border, 255 fg
            m[10:30, 20:50] = 255
            m[10:12] = 128
            Image.fromarray(m).save(seg / f"{folder}/im{i}.png")
            images.append(f"{iid} {rel}")
            boxes.append(f"{iid} {10.0 + iid} 5.0 30.0 {20.0 - iid}")
            split.append(f"{iid} {1 if i == 0 else 0}")
    (root / "images.txt").write_text("\n".join(images) + "\n")
    (root / "bounding_boxes.txt").write_text("\n".join(boxes) + "\n")
    (root / "train_test_split.txt").write_text("\n".join(split) + "\n")
    return str(root), str(seg)


def test_crop_cub_matches_jax(cub_tree, tmp_path):
    root, _ = cub_tree
    assert _same_outputs("crop_cub", tmp_path, root) == (2, 2)


def test_crop_and_binarize_masks_match_jax(cub_tree, tmp_path):
    root, seg = cub_tree
    assert _same_outputs("crop_cub_masks", tmp_path / "crop", root, seg) == 4
    masks = os.path.join(tmp_path / "crop", "out_jax", "mask_train")
    assert _same_outputs("binarize_masks", tmp_path / "fg", masks) == 2


def test_binarize_a_two_level_mask_matches_jax(tmp_path):
    src = tmp_path / "m" / "c"
    os.makedirs(src)
    m = np.zeros((10, 10), np.uint8)
    m[3:7, 3:7] = 255
    Image.fromarray(m).save(src / "a.png")
    assert _same_outputs("binarize_masks", tmp_path, str(tmp_path / "m")) == 1
    arr = np.asarray(Image.open(tmp_path / "out_port" / "c" / "a.png"))
    assert (arr == 255).sum() == 16


def test_build_pets_matches_jax(tmp_path):
    img_dir = tmp_path / "imgs"
    os.makedirs(img_dir)
    rng = np.random.RandomState(2)
    for name in ["Abyssinian_1", "beagle_2", "beagle_3"]:
        Image.fromarray(rng.randint(0, 255, (8, 8, 3), dtype=np.uint8)).save(
            img_dir / f"{name}.jpg")
    label_file = tmp_path / "trainval.txt"
    label_file.write_text("# comment line\nAbyssinian_1 1 1 1\nbeagle_2 2 2 1\nbeagle_3 2 2 1\n")
    assert _same_outputs("build_pets", tmp_path, str(img_dir), str(label_file)) == 3


def test_crop_cars_matches_jax(tmp_path):
    import scipy.io

    images = tmp_path / "car_ims"
    os.makedirs(images)
    rng = np.random.RandomState(3)
    rows = []
    for i in range(4):
        name = f"car_ims/{i:06d}.jpg"
        Image.fromarray(rng.randint(0, 255, (30, 50, 3), dtype=np.uint8)).save(tmp_path / name)
        # (relative_im_path, bbox_x1, bbox_y1, bbox_x2, bbox_y2, class, test)
        rows.append((name, 2 + i, 3, 40 - i, 25, 1 + i % 2, i % 2))
    dtype = [("relative_im_path", "O"), ("bbox_x1", "O"), ("bbox_y1", "O"), ("bbox_x2", "O"),
             ("bbox_y2", "O"), ("class", "O"), ("test", "O")]
    annos = np.array([tuple(np.array([[v]]) if not isinstance(v, str) else np.array([v])
                            for v in r) for r in rows], dtype=dtype)[None, :]
    scipy.io.savemat(tmp_path / "cars_annos.mat", {"annotations": annos})
    assert _same_outputs("crop_cars", tmp_path, str(tmp_path / "cars_annos.mat"),
                         str(tmp_path)) == 4


@pytest.fixture()
def aug_src(tmp_path):
    src = tmp_path / "src"
    rng = np.random.RandomState(1)
    for cls in ("clsA", "clsB"):
        os.makedirs(src / cls)
        for i in range(2):
            Image.fromarray(rng.randint(0, 255, (32, 48, 3), dtype=np.uint8)).save(
                src / cls / f"im{i}.jpg")
    Image.fromarray(rng.randint(0, 255, (32, 48, 3), dtype=np.uint8)).save(
        src / "clsA" / "im0.png")  # the same stem as im0.jpg
    return str(src)


@pytest.mark.parametrize("ops", [["rotate"], ["skew"], ["shear"], ["distortion"], None])
def test_augment_offline_matches_jax(aug_src, tmp_path, ops):
    n = _same_outputs("augment_offline", tmp_path, aug_src, copies_per_op=2, seed=3, ops=ops)
    assert n == 5 * 2 * (4 if ops is None else 1)


def test_prep_cli_writes_what_the_function_writes(cub_tree, tmp_path, capsys):
    root, _ = cub_tree
    cli_prep.main(["cub-crop", "--cub_root", root, "--out_root", str(tmp_path / "cli")])
    assert "cropped 2 train / 2 test images" in capsys.readouterr().out
    tprep.crop_cub(root, str(tmp_path / "fn"))
    assert _files(str(tmp_path / "cli")) == _files(str(tmp_path / "fn"))
    cli_prep.main(["augment", "--src_dir", os.path.join(str(tmp_path / "fn"), "train_cropped"),
                   "--dst_dir", str(tmp_path / "aug"), "--copies_per_op", "1", "--ops", "shear"])
    assert "wrote 2 augmented images" in capsys.readouterr().out
