"""Offline data-preparation CLI (counterpart of mgproto_tpu/cli/prep.py; the
reference's preprocess_data/* scripts).

    python -m mgproto_tpu_torch.cli.prep <subcommand> ...

Subcommands:
  cub-crop   — bbox-crop CUB into train_cropped/test_cropped trees
  cub-masks  — bbox-crop CUB segmentation masks
  mask-fg    — binarize masks to foreground/background
  cars-crop  — bbox-crop Stanford Cars from cars_annos.mat
  pets       — build Oxford-IIIT Pets class folders
  augment    — 40x offline augmentation (rotate/skew/shear/distortion)
"""

from __future__ import annotations

import argparse
from typing import Optional

from mgproto_tpu_torch.data import prep


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(description="MGProto dataset preparation")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("cub-crop")
    s.add_argument("--cub_root", required=True)
    s.add_argument("--out_root", required=True)

    s = sub.add_parser("cub-masks")
    s.add_argument("--cub_root", required=True)
    s.add_argument("--seg_root", required=True)
    s.add_argument("--out_root", required=True)

    s = sub.add_parser("mask-fg")
    s.add_argument("--src_root", required=True)
    s.add_argument("--dst_root", required=True)

    s = sub.add_parser("cars-crop")
    s.add_argument("--annos_mat", required=True)
    s.add_argument("--images_root", required=True)
    s.add_argument("--out_root", required=True)

    s = sub.add_parser("pets")
    s.add_argument("--img_dir", required=True)
    s.add_argument("--label_file", required=True)
    s.add_argument("--out_dir", required=True)

    s = sub.add_parser("augment")
    s.add_argument("--src_dir", required=True)
    s.add_argument("--dst_dir", required=True)
    s.add_argument("--copies_per_op", type=int, default=10)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--ops", nargs="+", default=None,
                   choices=["rotate", "skew", "shear", "distortion"])

    args = p.parse_args(argv)
    if args.cmd == "cub-crop":
        n_train, n_test = prep.crop_cub(args.cub_root, args.out_root)
        print(f"cropped {n_train} train / {n_test} test images")
    elif args.cmd == "cub-masks":
        n = prep.crop_cub_masks(args.cub_root, args.seg_root, args.out_root)
        print(f"cropped {n} masks")
    elif args.cmd == "mask-fg":
        n = prep.binarize_masks(args.src_root, args.dst_root)
        print(f"binarized {n} masks")
    elif args.cmd == "cars-crop":
        n = prep.crop_cars(args.annos_mat, args.images_root, args.out_root)
        print(f"cropped {n} car images")
    elif args.cmd == "pets":
        n = prep.build_pets(args.img_dir, args.label_file, args.out_dir)
        print(f"copied {n} pet images")
    elif args.cmd == "augment":
        n = prep.augment_offline(
            args.src_dir, args.dst_dir,
            copies_per_op=args.copies_per_op, seed=args.seed, ops=args.ops,
        )
        print(f"wrote {n} augmented images")


if __name__ == "__main__":
    main()
