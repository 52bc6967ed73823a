"""Data layer of the port: datasets, transforms, loaders and the CUB part
annotations (the port's copy of mgproto_tpu/data, without data/prep.py).

`data.loader`, `data.folder`, `data.transforms`, `data.cub_parts` and this
package import neither torch nor PIL: spawn loader workers unpickle the
datasets and transforms and import only what they need."""

from mgproto_tpu_torch.data.folder import Cub2011Eval, ImageFolder, Sample
from mgproto_tpu_torch.data.loader import DataLoader
from mgproto_tpu_torch.data.transforms import (
    ood_transform,
    push_transform,
    test_transform,
    train_transform,
)

__all__ = [
    "Cub2011Eval",
    "ImageFolder",
    "Sample",
    "DataLoader",
    "build_pipelines",
    "ood_transform",
    "push_transform",
    "test_transform",
    "train_transform",
]


def build_pipelines(cfg, device=None):
    """The reference's four loaders from one Config (main.py:96-163):
    (train, push, test, [ood...]); the ood list may be empty. With the uint8
    wire on (`DataConfig.device_augment`; None = on for a CUDA `device`) the
    train loader yields (u8 images, labels, ids, augment seeds) 4-tuples;
    the others yield f32 (images, labels, ids). `device` is the trainer's:
    None means CUDA, or raise. One process: shard 0 of 1."""
    from mgproto_tpu_torch.config import Config
    from mgproto_tpu_torch.numerics import resolve_device
    from mgproto_tpu_torch.ops.augment import resolve_device_augment

    if not isinstance(cfg, Config):
        raise TypeError(f"build_pipelines needs a mgproto_tpu_torch Config, got {type(cfg)}")
    shard = dict(shard_index=0, shard_count=1)
    d, img = cfg.data, cfg.model.img_size
    device_augment = resolve_device_augment(d.device_augment, resolve_device(device))
    wire_dtype = "uint8" if device_augment else "float32"
    # worker_backend applies to the TRAIN loader only: push/test/ood are
    # resize-only, and a persistent spawn pool per loader would sit idle
    train = DataLoader(
        ImageFolder(d.train_dir, train_transform(img, device_augment)),
        d.train_batch_size,
        shuffle=True,
        drop_last=True,
        num_workers=d.num_workers,
        worker_backend=d.worker_backend,
        seed=cfg.seed,
        with_seeds=device_augment,
        sample_spec=((img, img, 3), wire_dtype),
        **shard,
    )
    push = DataLoader(
        ImageFolder(d.train_push_dir, push_transform(img)),
        d.train_push_batch_size,
        num_workers=d.num_workers,
        **shard,
    )
    test = DataLoader(
        ImageFolder(d.test_dir, test_transform(img)),
        d.test_batch_size,
        num_workers=d.num_workers,
        **shard,
    )
    oods = [
        DataLoader(
            ImageFolder(o, ood_transform(img)),
            d.test_batch_size,
            num_workers=d.num_workers,
            **shard,
        )
        for o in d.ood_dirs
    ]
    return train, push, test, oods
