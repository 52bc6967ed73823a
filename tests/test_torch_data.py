"""The port's data layer (mgproto_tpu_torch/data) against the JAX package's
(mgproto_tpu/data), on a seeded tree of JPEGs, on the CPU.

Tolerance: none. Decode, geometry and the host jitter are the same PIL and
numpy calls on both sides, the u8 -> f32 conversion is the same native
arithmetic, and the loaders derive every random stream from (seed, epoch,
index): transforms, batches (images, labels, ids, seeds), sentinel rows and
`build_pipelines`' first batches are held equal bit for bit, across the
sync, thread and process backends and the pickle and shared-memory
transports, for two epochs.
"""

import dataclasses

import numpy as np
import pytest
from PIL import Image

from mgproto_tpu.config import Config as JaxConfig
from mgproto_tpu.config import DataConfig as JaxDataConfig
from mgproto_tpu.config import tiny_test_config as jax_tiny_config
from mgproto_tpu.data import DataLoader as JaxDataLoader
from mgproto_tpu.data import ImageFolder as JaxImageFolder
from mgproto_tpu.data import build_pipelines as jax_build_pipelines
from mgproto_tpu.data import transforms as JT
from mgproto_tpu.data.loader import augment_seeds as jax_augment_seeds
from mgproto_tpu_torch.config import DataConfig, tiny_test_config
from mgproto_tpu_torch.data import DataLoader, ImageFolder, build_pipelines
from mgproto_tpu_torch.data import transforms as T
from mgproto_tpu_torch.data.loader import augment_seeds
from mgproto_tpu_torch.serving import metrics

SIZE = 32


def _smooth_image(rng, h, w):
    """Seeded smooth content: a bilinear upsample of a coarse random grid."""
    coarse = rng.integers(0, 256, size=(4, 5, 3), dtype=np.uint8)
    return np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR))


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    """4 classes x 5 JPEGs of seeded smooth content at varying sizes."""
    root = tmp_path_factory.mktemp("port_imgs")
    rng = np.random.default_rng(0)
    for c in range(4):
        cdir = root / f"class_{c:03d}"
        cdir.mkdir()
        for i in range(5):
            h, w = int(rng.integers(40, 90)), int(rng.integers(40, 90))
            Image.fromarray(_smooth_image(rng, h, w)).save(cdir / f"img_{i}.jpg", quality=90)
    return str(root)


def _pil(seed, h=70, w=55):
    return Image.fromarray(_smooth_image(np.random.default_rng(seed), h, w))


@pytest.mark.parametrize("device_augment", [False, True], ids=["f32", "u8"])
def test_train_transform_matches_jax(device_augment):
    port, ref = T.TrainTransform(SIZE, device_augment), JT.TrainTransform(SIZE, device_augment)
    for seed in range(6):
        img = _pil(seed)
        got = port(img, np.random.default_rng([seed, 1]))
        want = ref(img, np.random.default_rng([seed, 1]))
        assert got.dtype == want.dtype == (np.uint8 if device_augment else np.float32)
        assert got.shape == (SIZE, SIZE, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["TestTransform", "PushTransform", "OodTransform"])
def test_eval_transforms_match_jax(name):
    port, ref = getattr(T, name)(SIZE), getattr(JT, name)(SIZE)
    for seed in range(3):
        img = _pil(seed, 61 + seed, 90 - seed)
        got, want = port(img), ref(img)
        assert got.dtype == np.float32 and got.shape == (SIZE, SIZE, 3)
        np.testing.assert_array_equal(got, want)


def test_color_jitter_matches_its_pil_oracle():
    """The vectorized jitter (native ops) against PIL's ImageEnhance chain."""
    for seed in range(8):
        img = _pil(seed)
        got = T.color_jitter(img, np.random.default_rng(seed))
        want = T._color_jitter_pil(img, np.random.default_rng(seed), (0.6, 1.4), (0.6, 1.4),
                                   (0.6, 1.4), (-0.02, 0.02))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_augment_seeds_match_jax():
    idx = np.array([0, 1, 2, 5, 99, -1])
    for seed, epoch in ((0, 0), (3, 1), (2 ** 40 + 5, 7)):
        got = augment_seeds(seed, epoch, idx)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, jax_augment_seeds(seed, epoch, idx))


def test_image_folder_matches_jax(image_tree):
    port, ref = ImageFolder(image_tree), JaxImageFolder(image_tree)
    assert port.classes == ref.classes and len(port) == len(ref) == 20
    assert [tuple(s) for s in port.samples] == [tuple(s) for s in ref.samples]


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_u8_wire_batches_match_jax_across_backends_and_transports(image_tree):
    """(u8 images, labels, ids, seeds) from the JAX sync loader and the
    port's sync, thread, process-shm and process-pickle loaders, two
    epochs."""
    kw = dict(shuffle=True, drop_last=True, seed=7, with_seeds=True)
    ref = JaxDataLoader(JaxImageFolder(image_tree, JT.TrainTransform(SIZE, True)), 8,
                        num_workers=0, **kw)
    ds = ImageFolder(image_tree, T.TrainTransform(SIZE, True))
    loaders = [
        DataLoader(ds, 8, num_workers=0, **kw),
        DataLoader(ds, 8, num_workers=2, **kw),
        DataLoader(ds, 8, num_workers=2, worker_backend="process", **kw),
        DataLoader(ds, 8, num_workers=2, worker_backend="process", use_shm=False, **kw),
    ]
    try:
        for _ in range(2):
            want = list(ref)
            assert want[0][0].dtype == np.uint8 and want[0][3].dtype == np.uint32
            for dl in loaders:
                _assert_batches_equal(list(dl), want)
    finally:
        for dl in loaders:
            dl.close()


def test_f32_batches_match_jax_with_padding(image_tree):
    """The classic f32 wire, unshuffled, with the padded last batch."""
    ref = JaxDataLoader(JaxImageFolder(image_tree, JT.TestTransform(SIZE)), 8, num_workers=0)
    dl = DataLoader(ImageFolder(image_tree, T.TestTransform(SIZE)), 8, num_workers=2,
                    worker_backend="process")
    try:
        got = list(dl)
        _assert_batches_equal(got, list(ref))
        assert (got[-1][1] == -1).sum() == 4
    finally:
        dl.close()


def test_sentinel_row_for_an_unreadable_file_matches_jax(tmp_path):
    root = tmp_path / "tree"
    rng = np.random.default_rng(1)
    for c in range(2):
        (root / f"c{c}").mkdir(parents=True)
        for i in range(2):
            Image.fromarray(_smooth_image(rng, 50, 60)).save(root / f"c{c}" / f"{i}.jpg")
    (root / "c1" / "1.jpg").write_bytes(b"not a jpeg")
    spec = dict(sample_spec=((SIZE, SIZE, 3), "float32"))
    ref = JaxDataLoader(JaxImageFolder(str(root), JT.OodTransform(SIZE)), 4, num_workers=0,
                        **spec)
    prev = metrics.set_current_registry(None)
    try:
        dl = DataLoader(ImageFolder(str(root), T.OodTransform(SIZE)), 4, num_workers=0, **spec)
        got = list(dl)
        sentinels = metrics.counter(metrics.LOADER_SENTINEL_ROWS).value()
        retries = metrics.counter(metrics.LOADER_RETRIES).value(scope="loader")
    finally:
        metrics.set_current_registry(prev)
    _assert_batches_equal(got, list(ref))
    images, labels, ids = got[0]
    assert labels[3] == -1 and ids[3] == -1 and not images[3].any()
    assert sentinels == 1 and retries == 3


@pytest.mark.parametrize("device_augment", [False, True], ids=["f32", "u8"])
def test_build_pipelines_matches_jax(image_tree, device_augment):
    data = dict(train_dir=image_tree, test_dir=image_tree, train_push_dir=image_tree,
                ood_dirs=(image_tree,), train_batch_size=8, test_batch_size=8,
                train_push_batch_size=8, num_workers=2, device_augment=device_augment)
    jcfg = jax_tiny_config()
    jcfg = JaxConfig(model=jcfg.model, data=JaxDataConfig(**data), seed=3)
    cfg = tiny_test_config().replace(data=DataConfig(**data), seed=3)
    assert dataclasses.asdict(cfg.data) == {
        k: v for k, v in dataclasses.asdict(jcfg.data).items() if k in dataclasses.asdict(cfg.data)}
    jloaders = jax_build_pipelines(jcfg)
    ploaders = build_pipelines(cfg, device="cpu")
    try:
        jflat = [*jloaders[:3], *jloaders[3]]
        pflat = [*ploaders[:3], *ploaders[3]]
        assert len(jflat) == len(pflat) == 4
        for jl, pl in zip(jflat, pflat):
            want, got = next(iter(jl)), next(iter(pl))
            _assert_batches_equal([got], [want])
        assert len(next(iter(ploaders[0]))) == (4 if device_augment else 3)
    finally:
        for dl in [*jloaders[:3], *jloaders[3], *ploaders[:3], *ploaders[3]]:
            dl.close()


def test_build_pipelines_needs_a_device_or_cuda(image_tree):
    cfg = tiny_test_config().replace(data=DataConfig(train_dir=image_tree, test_dir=image_tree,
                                                     train_push_dir=image_tree))
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_pipelines(cfg)


@pytest.mark.parametrize("use_shm", [True, False], ids=["shm", "pickle"])
def test_a_dead_worker_restarts_the_pool_once_and_loses_nothing(tmp_path, monkeypatch, use_shm):
    """A process worker that dies mid-task: the pool is restarted once, the
    lost rows are loaded in the parent, and the batches equal a sync
    loader's."""
    from _torch_loader_datasets import DyingDataset

    from mgproto_tpu_torch.data import loader as port_loader

    monkeypatch.setattr(port_loader, "_RESULT_TIMEOUT_S", 5.0)
    ds = DyingDataset(str(tmp_path / "died"))
    prev = metrics.set_current_registry(None)
    dl = DataLoader(ds, 4, num_workers=2, worker_backend="process", use_shm=use_shm, seed=1)
    try:
        got = list(dl)
        restarts = metrics.counter(metrics.LOADER_WORKER_RESTARTS).value()
    finally:
        dl.close()
        metrics.set_current_registry(prev)
    assert (tmp_path / "died").exists() and restarts == 1
    _assert_batches_equal(got, list(DataLoader(ds, 4, num_workers=0, seed=1)))
