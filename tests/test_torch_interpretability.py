"""The port's interpretability plane (mgproto_tpu_torch/engine/interpretability.py,
data/cub_parts.py, data/folder.py::Cub2011Eval, cli/interpret.py) against
the JAX package's, on the CPU.

Two CUB-layout trees: the one tests/test_interpretability.py builds (2
classes x 3 test images of 64x48, 3 parts, part 3 never visible) and a
wider one (4 classes x 8 images of three sizes, half of them in the train
split, CUB's 15 parts at seeded places, each visible with probability 0.8).
A tiny JAX state trained three steps (tests/_torch_jax_states.py) is
carried into the port; both packages score the same squash-resized test
split.

Tolerances:
  * `CubParts` tables, `Cub2011Eval` samples and the eval loader's batches
    (pad rows included): equal;
  * the stability noise: bit-equal, batch by batch, pad rows included;
  * collected maps: within 1e-5 of each map's maximum (XLA's and ATen's CPU
    convolutions sum in different orders); targets and
    ids equal;
  * peaks (the argmax of the upsampled map): equal, or one pixel off in
    each axis on at most 1 % of maps (torch's and cv2's bicubic differ by
    ~1e-7 of the map, which can move a near-tie argmax; held on 4000
    seeded maps and on the collected ones; the port's batched and scalar
    peaks are equal);
  * consistency, stability and purity: equal to JAX's. A map whose peak
    differs, or a prototype whose top-K image order differs (peak values
    within 1e-5 of each other), is named, and each may move a metric by one
    prototype's weight (100 / prototypes scored);
  * CSV rows: equal under the same rule; `purity_from_csv` on the port's
    CSV: `evaluate_purity`'s mean and std within 1e-9, as in the JAX test.
"""

import functools
import importlib
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_jax_states import port_state, trained_jax_state
from mgproto_tpu.data import Cub2011Eval as JaxCub2011Eval
from mgproto_tpu.data import DataLoader as JaxDataLoader
from mgproto_tpu.data import ood_transform as jax_ood_transform
from mgproto_tpu_torch.cli import interpret as tcli
from mgproto_tpu_torch.config import DataConfig
from mgproto_tpu_torch.data import Cub2011Eval
from mgproto_tpu_torch.data import cub_parts as tparts
from mgproto_tpu_torch.engine import interpretability as ti
from mgproto_tpu_torch.utils import checkpoint as tck

ji = importlib.import_module("mgproto_tpu.engine.interpretability")
jparts = importlib.import_module("mgproto_tpu.data.cub_parts")

IMG = 32
BATCH = 5  # both trees end in a padded batch
C = 4  # the carried state's classes
MAP_ATOL_OF_MAX = 1e-5
HALF, PURITY_HALF, TOP_K = 12, 8, 2


def _write_layout(root, classes, per_class, part_names, seed, sizes, train_every=0):
    """A CUB_200_2011 tree. `train_every` > 0 puts every such image in the
    train split; part places are seeded (fixed ones for the 3-part tree)."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "parts"), exist_ok=True)
    images, labels, split, bboxes, part_locs = [], [], [], [], []
    img_id = 0
    for c in range(classes):
        folder = f"{c + 1:03d}.Class_{c}"
        os.makedirs(os.path.join(root, "images", folder), exist_ok=True)
        for i in range(per_class):
            img_id += 1
            w, h = sizes[img_id % len(sizes)]
            Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8)).save(
                os.path.join(root, "images", folder, f"img_{i}.jpg"))
            images.append(f"{img_id} {folder}/img_{i}.jpg")
            labels.append(f"{img_id} {c + 1}")
            split.append(f"{img_id} {int(train_every > 0 and i % train_every == 0)}")
            if len(part_names) == 3:  # tests/test_interpretability.py:32's tree
                bboxes.append(f"{img_id} 4.0 4.0 40.0 32.0")
                part_locs += [f"{img_id} 1 {w // 4}.0 {h // 4}.0 1",
                              f"{img_id} 2 {3 * w // 4}.0 {3 * h // 4}.0 1",
                              f"{img_id} 3 0.0 0.0 0"]
                continue
            x0, y0 = rng.uniform(0, w / 3), rng.uniform(0, h / 3)
            bw, bh = rng.uniform(w / 3, w - x0), rng.uniform(h / 3, h - y0)
            bboxes.append(f"{img_id} {x0:.1f} {y0:.1f} {bw:.1f} {bh:.1f}")
            for p in range(len(part_names)):
                visible = int(rng.uniform() < 0.8)
                x, y = (rng.uniform(x0, x0 + bw), rng.uniform(y0, y0 + bh)) if visible else (0, 0)
                part_locs.append(f"{img_id} {p + 1} {x:.1f} {y:.1f} {visible}")
    for name, rows in (("images", images), ("image_class_labels", labels),
                       ("train_test_split", split), ("bounding_boxes", bboxes)):
        with open(os.path.join(root, f"{name}.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
    with open(os.path.join(root, "parts", "parts.txt"), "w") as f:
        f.write("".join(f"{p + 1} {n}\n" for p, n in enumerate(part_names)))
    with open(os.path.join(root, "parts", "part_locs.txt"), "w") as f:
        f.write("\n".join(part_locs) + "\n")
    return root


CUB_PARTS = ("back", "beak", "belly", "breast", "crown", "forehead", "left eye", "left leg",
             "left wing", "nape", "right eye", "right leg", "right wing", "tail", "throat")


@pytest.fixture(scope="module", params=["small", "wide"])
def cub_root(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp(f"cub_{request.param}"))
    if request.param == "small":
        return _write_layout(root, 2, 3, ("beak", "tail", "crown"), 0, [(64, 48)])
    return _write_layout(root, C, 8, CUB_PARTS, 1, [(64, 48), (50, 70), (90, 60)], train_every=2)


@functools.lru_cache(maxsize=None)
def _states():
    jtrainer, jstate = trained_jax_state()
    ptrainer, pstate = port_state(jstate)
    cfg = ptrainer.cfg.replace(data=DataConfig(test_batch_size=BATCH, num_workers=0))
    return jtrainer, jstate, ptrainer.__class__(cfg, 4, device="cpu"), pstate


def _jax_loader(root):
    return JaxDataLoader(JaxCub2011Eval(root, train=False, transform=jax_ood_transform(IMG)),
                         BATCH, num_workers=0)


@functools.lru_cache(maxsize=None)
def _activations(root):
    """(JAX clean, JAX noisy, port clean, port noisy) collections."""
    jtrainer, jstate, ptrainer, pstate = _states()
    out = [ji.collect_gt_activations(jtrainer, jstate, iter(_jax_loader(root)), use_noise=n)
           for n in (False, True)]
    loader = tcli.build_eval_loader(ptrainer.cfg, root)
    try:
        out += [ti.collect_gt_activations(ptrainer, pstate, iter(loader), use_noise=n)
                for n in (False, True)]
    finally:
        loader.close()
    return tuple(out)


def test_cub_parts_tables_match_jax(cub_root):
    j, t = jparts.CubParts(cub_root), tparts.CubParts(cub_root)
    for name in ("id_to_path", "id_to_bbox", "cls_to_id", "id_to_train", "part_id_to_part",
                 "part_num", "id_to_part_loc"):
        assert getattr(t, name) == getattr(j, name), name
    for img_id in t.id_to_path:
        assert t.image_path(img_id) == j.image_path(img_id)
        assert t.orig_wh(img_id) == j.orig_wh(img_id)
        tl, tm = t.scaled_part_labels(img_id, t.orig_wh(img_id), IMG)
        jl, jm = j.scaled_part_labels(img_id, j.orig_wh(img_id), IMG)
        assert tl == jl
        np.testing.assert_array_equal(tm, jm)
    assert tparts.read_images_txt(cub_root) == jparts.read_images_txt(cub_root)
    assert tparts.read_bounding_boxes(cub_root) == jparts.read_bounding_boxes(cub_root)
    assert tparts.read_train_test_split(cub_root) == jparts.read_train_test_split(cub_root)
    box = (0, 10, 0, 10)
    for loc in ((5, 5), (11, 5), (10, 0)):
        assert tparts.in_bbox(loc, box) == jparts.in_bbox(loc, box)


@pytest.mark.parametrize("train", [False, True])
def test_cub2011eval_samples_match_jax(cub_root, train):
    t = Cub2011Eval(cub_root, train=train, transform=tcli.ood_transform(IMG))
    j = JaxCub2011Eval(cub_root, train=train, transform=jax_ood_transform(IMG))
    assert [tuple(s) for s in t.samples] == [tuple(s) for s in j.samples]
    assert len(t) == len(j) and (len(t) > 0 or train)
    for i in range(len(t)):
        (ta, tl, tid), (ja, jl, jid) = t.load(i), j.load(i)
        assert (tl, tid) == (jl, jid)
        np.testing.assert_array_equal(ta, ja)
    # no transform: the RGB pixels in [0, 1]
    if len(t):
        np.testing.assert_array_equal(Cub2011Eval(cub_root, train=train).load(0)[0],
                                      JaxCub2011Eval(cub_root, train=train).load(0)[0])


def test_eval_loader_batches_match_jax(cub_root):
    _, _, ptrainer, _ = _states()
    loader = tcli.build_eval_loader(ptrainer.cfg, cub_root)
    try:
        got = list(loader)
    finally:
        loader.close()
    want = list(_jax_loader(cub_root))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w) == 3
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert (np.asarray(got[-1][1]) == -1).any()  # a padded tail in both trees


def test_perturbation_noise_is_bit_equal(cub_root, monkeypatch):
    rng_t, rng_j = np.random.default_rng(7), np.random.default_rng(7)
    imgs = np.random.default_rng(8).normal(size=(3, IMG, IMG, 3)).astype(np.float32)
    for _ in range(2):
        np.testing.assert_array_equal(ti.perturb_images(imgs, rng_t),
                                      ji.perturb_images(imgs, rng_j))

    # the images each package feeds its forward in the noisy pass
    jtrainer, jstate, ptrainer, pstate = _states()
    fed_t, fed_j = [], []
    real_t = ti.gt_class_log_densities

    def record_t(model, gmm, images, labels):
        fed_t.append(images.numpy().copy())
        return real_t(model, gmm, images, labels)

    monkeypatch.setattr(ti, "gt_class_log_densities", record_t)
    real_j = ji.make_gt_act_fn(jtrainer.model)

    def record_j(params, stats, gmm, images, labels):
        fed_j.append(np.asarray(images))
        return real_j(params, stats, gmm, images, labels)

    ji.collect_gt_activations(jtrainer, jstate, iter(_jax_loader(cub_root)), use_noise=True,
                              noise_seed=3, act_fn=record_j)
    loader = tcli.build_eval_loader(ptrainer.cfg, cub_root)
    try:
        ti.collect_gt_activations(ptrainer, pstate, iter(loader), use_noise=True, noise_seed=3)
    finally:
        loader.close()
    assert len(fed_t) == len(fed_j) > 0
    for a, b in zip(fed_t, fed_j):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("noisy", [False, True])
def test_collected_maps_match_jax(cub_root, noisy):
    acts = _activations(cub_root)
    (jm, jt, jid), (tm, tt, tid) = acts[int(noisy)], acts[2 + int(noisy)]
    jm, tm = np.asarray(jax.device_get(jm)), tm.numpy()
    assert tm.shape == jm.shape and tm.shape[1:] == (3, 8, 8)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tid, jid)
    assert (tt >= 0).all() and len(tt) == len(Cub2011Eval(cub_root, train=False))
    scale = jm.max(axis=(2, 3), keepdims=True)
    assert (np.abs(tm - jm) <= MAP_ATOL_OF_MAX * scale).all(), np.abs(tm - jm).max()


def _peak_moves(want, got):
    """(maps whose peak differs, the largest move in one axis)."""
    diff = np.abs(np.asarray(want) - np.asarray(got))
    return int(diff.any(-1).sum()), int(diff.max(initial=0))


def test_peaks_match_jax_on_seeded_maps():
    maps = np.random.default_rng(11).lognormal(size=(4000, 14, 14)).astype(np.float32)
    got = ti.peak_positions(torch.from_numpy(maps), 224)
    want = np.array([ji.peak_box(m, 224, 0)[::2] for m in maps])
    moved, step = _peak_moves(want, got)
    assert moved <= 0.01 * len(maps) and step <= 1, (moved, step)
    # the scalar form, on the host, gives the batched form's peaks
    for m, p in zip(maps[:200], got[:200]):
        assert ti.peak_box(m, 224, 0)[::2] == tuple(p)
    assert ti.peak_positions(maps[:3, None], 224).shape == (3, 1, 2)


def test_peaks_match_jax_on_collected_maps(cub_root):
    jm = np.asarray(jax.device_get(_activations(cub_root)[0][0]))
    got = ti.peak_positions(torch.from_numpy(jm), IMG)
    want = np.array([[ji.peak_box(m, IMG, 0)[::2] for m in row] for row in jm])
    moved, step = _peak_moves(want, got)
    assert moved <= 0.01 * jm.shape[0] * jm.shape[1] and step <= 1, (moved, step)
    for half in (0, 5, IMG):
        assert ti.peak_box(jm[0, 1], IMG, half) == ji.peak_box(jm[0, 1], IMG, half)


def test_hit_matrix_golden():
    """The JAX test's golden case: one image, one prototype, the latent
    peak at the centre; a part there is hit, one in the far corner not."""
    act = np.zeros((1, 1, 4, 4), np.float32)
    act[0, 0, 2, 2] = 1.0
    part_labels = [[[0, 20, 20], [1, 0, 0]]]
    for fn in (ti.hit_matrix, ji.hit_matrix):
        hits = fn(act, part_labels, 2, img_size=32, half_size=6)
        assert hits.shape == (1, 1, 2) and hits[0, 0].tolist() == [1.0, 0.0]
        assert fn(act, part_labels, 2, img_size=32, half_size=6, rows=[0, 0]).shape == (1, 2, 2)
    np.testing.assert_array_equal(ti.hit_matrix(torch.from_numpy(act), part_labels, 2, 32, 6),
                                  ji.hit_matrix(act, part_labels, 2, 32, 6))


def _named_flips(root):
    """Maps (row, k) whose peaks differ between the packages, and
    prototypes (class, k) whose top-K image order differs; the number of
    prototypes scored."""
    jc, jn, tc, tn = _activations(root)
    flips = set()
    for j, t in ((jc, tc), (jn, tn)):
        jm = np.asarray(jax.device_get(j[0]))
        want = np.array([[ji.peak_box(m, IMG, 0)[::2] for m in row] for row in jm])
        got = ti.peak_positions(t[0], IMG)
        flips |= {("map", int(r), int(k)) for r, k in np.argwhere((want != got).any(-1))}
    jm = np.asarray(jax.device_get(jc[0]))
    classes = sorted(set(jc[1].tolist()))
    for c in classes:
        idx = np.nonzero(jc[1] == c)[0]
        jo, to = ji._topk_rows(jm[idx], TOP_K), ti._topk_rows(tc[0][idx], TOP_K)
        flips |= {("topk", c, int(k)) for k in np.nonzero((jo != to).any(0))[0]}
    return flips, len(classes) * jm.shape[1]


def _assert_metric(got, want, root, what):
    flips, n_protos = _named_flips(root)
    assert abs(got - want) <= 100.0 * len(flips) / n_protos + 1e-9, (what, got, want, flips)
    if not flips:
        assert got == pytest.approx(want, abs=1e-9), (what, got, want)


def test_metrics_match_jax(cub_root):
    jtrainer, jstate, ptrainer, pstate = _states()
    jc, jn, tc, tn = _activations(cub_root)
    jp, tp = jparts.CubParts(cub_root), tparts.CubParts(cub_root)
    _assert_metric(
        ti.evaluate_consistency(ptrainer, pstate, None, tp, C, half_size=HALF, activations=tc),
        ji.evaluate_consistency(jtrainer, jstate, None, jp, C, half_size=HALF, activations=jc),
        cub_root, "consistency")
    _assert_metric(
        ti.evaluate_stability(ptrainer, pstate, None, tp, C, half_size=HALF, activations=tc,
                              noisy_activations=tn),
        ji.evaluate_stability(jtrainer, jstate, lambda: iter(_jax_loader(cub_root)), jp, C,
                              half_size=HALF, activations=jc),
        cub_root, "stability")
    t_pur = ti.evaluate_purity(ptrainer, pstate, None, tp, C, half_size=PURITY_HALF, top_k=TOP_K,
                               activations=tc)
    j_pur = ji.evaluate_purity(jtrainer, jstate, None, jp, C, half_size=PURITY_HALF, top_k=TOP_K,
                               activations=jc)
    for g, w, what in zip(t_pur, j_pur, ("purity", "purity_std")):
        _assert_metric(g, w, cub_root, what)
    # the whole image as the box: every visible part is hit
    assert ti.evaluate_consistency(ptrainer, pstate, None, tp, C, half_size=IMG,
                                   activations=tc) == pytest.approx(100.0)
    assert ti.evaluate_purity(ptrainer, pstate, None, tp, C, half_size=IMG, top_k=TOP_K,
                              activations=tc)[0] == pytest.approx(
        ji.evaluate_purity(jtrainer, jstate, None, jp, C, half_size=IMG, top_k=TOP_K,
                           activations=jc)[0])


def test_stability_collects_its_own_passes(cub_root):
    """Without precomputed activations, the port's stability reads the
    batches twice itself and gives the shared-pass number."""
    _, _, ptrainer, pstate = _states()
    _, _, tc, tn = _activations(cub_root)
    tp = tparts.CubParts(cub_root)
    loader = tcli.build_eval_loader(ptrainer.cfg, cub_root)
    try:
        alone = ti.evaluate_stability(ptrainer, pstate, lambda: iter(loader), tp, C,
                                      half_size=HALF)
    finally:
        loader.close()
    assert alone == ti.evaluate_stability(ptrainer, pstate, None, tp, C, half_size=HALF,
                                          activations=tc, noisy_activations=tn)


def _csv_rows(path):
    with open(path) as f:
        return [line.strip().split(",") for line in f]


def test_csv_matches_jax_and_purity_from_csv(cub_root, tmp_path):
    jtrainer, jstate, ptrainer, pstate = _states()
    jc, _, tc, _ = _activations(cub_root)
    tp = tparts.CubParts(cub_root)
    n_t = ti.export_prototype_patches_csv(str(tmp_path / "t.csv"), ptrainer, pstate, None, C,
                                          half_size=PURITY_HALF, top_k=TOP_K, activations=tc)
    n_j = ji.export_prototype_patches_csv(str(tmp_path / "j.csv"), jtrainer, jstate, None, C,
                                          half_size=PURITY_HALF, top_k=TOP_K, activations=jc)
    assert n_t == n_j > 0
    rows_t, rows_j = _csv_rows(tmp_path / "t.csv"), _csv_rows(tmp_path / "j.csv")
    flips, _ = _named_flips(cub_root)
    differ = [(a, b) for a, b in zip(rows_t, rows_j) if a != b]
    assert len(differ) <= TOP_K * len(flips), (differ, flips)
    direct = ti.evaluate_purity(ptrainer, pstate, None, tp, C, half_size=PURITY_HALF,
                                top_k=TOP_K, activations=tc)
    via_csv = ti.purity_from_csv(str(tmp_path / "t.csv"), tp, IMG)
    assert via_csv == pytest.approx(direct, abs=1e-9)
    assert via_csv == ji.purity_from_csv(str(tmp_path / "t.csv"), jparts.CubParts(cub_root), IMG)


def test_run_interpret_matches_the_jax_cli_body(cub_root, tmp_path):
    jtrainer, jstate, ptrainer, pstate = _states()
    cfg = ptrainer.cfg.replace(model_dir=str(tmp_path / "run"))
    tck.save_checkpoint(cfg.model_dir, pstate, "1push0.5000")
    csv_path = str(tmp_path / "patches.csv")
    got = tcli.run_interpret(cfg, cub_root, export_csv=csv_path, half_size=HALF,
                             purity_half_size=PURITY_HALF, purity_top_k=TOP_K, device="cpu")
    assert got["checkpoint"] == os.path.join(cfg.model_dir, "1push0.5000")
    assert got["images"] == len(Cub2011Eval(cub_root, train=False))
    assert set(got["seconds"]) == {"clean_pass", "noisy_pass", "consistency", "stability",
                                   "purity", "csv"}

    # the JAX CLI's body on the JAX state: one clean pass for every metric
    jp = jparts.CubParts(cub_root)
    jc = ji.collect_gt_activations(jtrainer, jstate, iter(_jax_loader(cub_root)))
    want = {
        "consistency": ji.evaluate_consistency(jtrainer, jstate, None, jp, C, half_size=HALF,
                                               activations=jc),
        "stability": ji.evaluate_stability(jtrainer, jstate, lambda: iter(_jax_loader(cub_root)),
                                           jp, C, half_size=HALF, activations=jc),
    }
    want["purity"], want["purity_std"] = ji.evaluate_purity(
        jtrainer, jstate, None, jp, C, half_size=PURITY_HALF, top_k=TOP_K, activations=jc)
    want["csv_rows"] = ji.export_prototype_patches_csv(
        str(tmp_path / "j.csv"), jtrainer, jstate, None, C, half_size=PURITY_HALF, top_k=TOP_K,
        activations=jc)
    for key in ("consistency", "stability", "purity", "purity_std"):
        _assert_metric(got[key], want[key], cub_root, key)
    assert got["csv_rows"] == want["csv_rows"] and got["csv"] == csv_path

    only = tcli.run_interpret(cfg, cub_root, checkpoint=got["checkpoint"], metric="purity",
                              purity_half_size=PURITY_HALF, purity_top_k=TOP_K, device="cpu")
    assert {k for k in only if k not in ("checkpoint", "images", "seconds")} == {
        "purity", "purity_std"}
    assert (only["purity"], only["purity_std"]) == (got["purity"], got["purity_std"])
    with pytest.raises(ValueError, match="metric"):
        tcli.run_interpret(cfg, cub_root, metric="speed", device="cpu")
    with pytest.raises(FileNotFoundError):
        tcli.run_interpret(cfg.replace(model_dir=str(tmp_path / "none")), cub_root, device="cpu")
