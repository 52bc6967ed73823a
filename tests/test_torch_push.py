"""The port's prototype projection (mgproto_tpu_torch/engine/push.py)
against the JAX package's, on the CPU.

A tiny JAX state trained three steps (tests/_torch_jax_states.py) is carried
into the port; both push it over the same host batches of [0, 1] images:
classes with 4, 3, 3 and 2 images (so class 3 cannot fill its K = 3
prototypes), one image that is also a candidate of a second class under the
same id (the greedy's image dedup across classes), and label -1 pad rows
(zero image, id -1) at the end.

Rendering (`save_dir`): the same file names as the JAX package's `_render`
and the same decoded pixels (every box and crop equal).

Tolerances: `pushed`, `image_id` and `spatial_idx` equal; `log_prob` atol
1e-4; the new means atol 1e-5 (XLA's and ATen's CPU convolutions sum in
different orders); the means of unpushed prototypes unchanged bit for bit;
`provenance_dict` equal in its ids and indices. A prototype whose choice
rests on a near-tie, two patch densities of one candidate or two
candidates' densities within 1e-4 of each other on the port's side, may
differ: the test counts such prototypes and allows one difference for
each.
"""

import functools
import importlib
import json
import os

import jax
import numpy as np
import pytest
import torch

from _torch_jax_states import B, IMG, NEAR, port_state, trained_jax_state
from mgproto_tpu_torch.core.mgproto import l2_normalize
from mgproto_tpu_torch.engine import push as tpush
from mgproto_tpu_torch.ops.gaussian import diag_gaussian_log_prob
from mgproto_tpu_torch.utils.images import preprocess_input

jpush = importlib.import_module("mgproto_tpu.engine.push")

CLASS_SIZES = (4, 3, 3, 2)
SHARED = (1, 2)  # image id 1 (class 0) is also a candidate of class 2


def _push_batches():
    rng = np.random.default_rng(20)
    rows = []
    img_id = 0
    pixels = {}
    for c, n in enumerate(CLASS_SIZES):
        for _ in range(n):
            pixels[img_id] = rng.uniform(size=(IMG, IMG, 3)).astype(np.float32)
            rows.append((pixels[img_id], c, img_id))
            img_id += 1
    rows.append((pixels[SHARED[0]], SHARED[1], SHARED[0]))
    while len(rows) % B:
        rows.append((np.zeros((IMG, IMG, 3), np.float32), -1, -1))
    return [(np.stack([r[0] for r in rows[i:i + B]]),
             np.array([r[1] for r in rows[i:i + B]], np.int32),
             np.array([r[2] for r in rows[i:i + B]], np.int64))
            for i in range(0, len(rows), B)]


@functools.lru_cache(maxsize=None)
def _jax_push():
    jtrainer, jstate = trained_jax_state()
    new, result = jpush.push_prototypes(jtrainer, jstate, _push_batches())
    return jstate, jax.device_get(new.gmm.means), result


def _near_tie_prototypes(pstate):
    """Prototypes (c, k) whose choice on the port's side rests on a
    near-tie: a candidate row of class c whose best two patch densities
    under (c, k) lie within NEAR, or two candidates whose best densities do."""
    near = set()
    model = pstate.model.eval()
    with torch.inference_mode():
        vals = {}
        for images, labels, _ in _push_batches():
            x = torch.from_numpy(preprocess_input(images))
            proto_map, _ = model(x)
            b, h, w, d = proto_map.shape
            feat = l2_normalize(proto_map, dim=-1).reshape(-1, d)
            lp = diag_gaussian_log_prob(feat, pstate.gmm.means, pstate.gmm.sigmas)
            lp = lp.reshape(b, h * w, *pstate.gmm.means.shape[:2])
            for r, c in enumerate(labels):
                if c < 0:
                    continue
                top2 = torch.topk(lp[r, :, c], 2, dim=0).values  # [2, K]
                for k in np.nonzero((top2[0] - top2[1]).numpy() <= NEAR)[0]:
                    near.add((int(c), int(k)))
                vals.setdefault(int(c), []).append(top2[0].numpy())
        for c, v in vals.items():
            v = np.stack(v)  # [rows, K]
            for k in range(v.shape[1]):
                gaps = np.abs(v[:, None, k] - v[None, :, k])[np.triu_indices(len(v), 1)]
                if (gaps <= NEAR).any():
                    near.add((c, k))
    pstate.model.train()
    return near


def test_push_matches_jax():
    jstate, jmeans, jres = _jax_push()
    ptrainer, pstate = port_state(jstate)
    before = pstate.gmm.means.detach().clone()
    means_obj = pstate.gmm.means
    pstate, pres = tpush.push_prototypes(ptrainer, pstate, _push_batches())

    assert pstate.gmm.means is means_obj and pstate.gmm.means.requires_grad
    assert pstate.model.training
    allowed = len(_near_tie_prototypes(pstate))
    differ = ((pres.pushed != jres.pushed) | (pres.image_id != jres.image_id)
              | (pres.spatial_idx != jres.spatial_idx))
    assert differ.sum() <= allowed, (np.argwhere(differ), allowed)
    same = ~differ & pres.pushed
    np.testing.assert_allclose(pres.log_prob[same], jres.log_prob[same], atol=1e-4)
    got = pstate.gmm.means.detach().numpy()
    np.testing.assert_allclose(got[same], jmeans[same], atol=1e-5)

    # the schedule of this push set: class 3 has 2 images for 3 prototypes,
    # the shared image is taken once, pad rows never
    assert pres.pushed.sum() == 11 and not pres.pushed[3, 2]
    assert -1 not in set(pres.image_id[pres.pushed].tolist())
    assert len(set(pres.image_id[pres.pushed].tolist())) == pres.pushed.sum()
    np.testing.assert_array_equal(got[~pres.pushed], before.numpy()[~pres.pushed])
    np.testing.assert_array_equal(jmeans[~jres.pushed], np.asarray(jstate.gmm.means)[~jres.pushed])
    # a pushed mean is a unit feature vector
    np.testing.assert_allclose(np.linalg.norm(got[pres.pushed], axis=-1), 1.0, atol=1e-5)

    tprov, jprov = tpush.provenance_dict(pres), jpush.provenance_dict(jres)
    assert tprov.keys() == jprov.keys()
    if not allowed:
        assert tprov["image_id"] == jprov["image_id"]
        assert tprov["spatial_idx"] == jprov["spatial_idx"]
    np.testing.assert_allclose(np.array(tprov["log_prob"])[same.reshape(-1)],
                               np.array(jprov["log_prob"])[same.reshape(-1)], atol=1e-4)


def test_greedy_assign_is_the_jax_packages():
    """Identical candidates give identical assignments, ties included."""
    rng = np.random.default_rng(3)
    n, k, d, c = 12, 3, 4, 4
    labels = np.array([0, 0, 1, 1, 1, 2, 2, 2, 0, -1, 3, 2], np.int32)
    ids = np.array([0, 1, 2, 3, 4, 5, 6, 1, 7, -1, 8, 9])
    vals = np.round(rng.normal(size=(n, k)), 1).astype(np.float32)
    idxs = rng.integers(0, 16, size=(n, k))
    fvecs = rng.normal(size=(n, k, d)).astype(np.float32)
    t_means, t_res = tpush._greedy_assign(labels, ids, vals, idxs, fvecs, c)
    j_means, j_res = jpush._greedy_assign(labels, ids, vals, idxs, fvecs, c)
    np.testing.assert_array_equal(t_means, j_means)
    for a, b in zip(t_res, j_res):
        np.testing.assert_array_equal(a, b)


def _load_image(batches):
    """image_id -> its [0, 1] image in the push batches (the push loader's
    `dataset.load(i)[0]`)."""
    pixels = {int(i): img for images, _, ids in batches for img, i in zip(images, ids) if i >= 0}
    return lambda i: pixels[int(i)]


def _decoded(directory):
    from PIL import Image

    out = {}
    for name in sorted(os.listdir(directory)):
        with Image.open(os.path.join(directory, name)) as im:
            out[name] = np.asarray(im)
    return out


def test_provenance_file_and_rendering(tmp_path):
    """Push with `save_dir` renders what the JAX package's `_render` does:
    3 JPEGs per pushed prototype under `epoch-{epoch}`, the same names,
    and decoded pixels equal to the JAX files' (each prototype pushed to
    the same image and patch in both; every box and crop matched here, so
    no one-pixel allowance is needed)."""
    jtrainer, jstate = trained_jax_state()
    batches = _push_batches()
    _, jres = jpush.push_prototypes(jtrainer, jstate, batches, save_dir=str(tmp_path / "jax"),
                                    epoch=2, load_image=_load_image(batches))
    ptrainer, pstate = port_state(jstate)
    assert tpush.load_push_provenance(str(tmp_path)) is None
    with pytest.raises(ValueError, match="load_image"):
        tpush.push_prototypes(ptrainer, pstate, batches, save_dir=str(tmp_path / "port"))
    with pytest.raises(ValueError, match="empty"):
        tpush.push_prototypes(ptrainer, pstate, [])
    _, res = tpush.push_prototypes(ptrainer, pstate, batches, save_dir=str(tmp_path / "port"),
                                   epoch=2, load_image=_load_image(batches))
    assert pstate.model.training
    got, want = _decoded(tmp_path / "port" / "epoch-2"), _decoded(tmp_path / "jax" / "epoch-2")
    assert len(got) == 3 * int(res.pushed.sum())
    same = (res.pushed & jres.pushed & (res.image_id == jres.image_id)
            & (res.spatial_idx == jres.spatial_idx))
    assert same.sum() >= res.pushed.sum() - len(_near_tie_prototypes(pstate))
    names = set()
    for c, k in np.argwhere(res.pushed):
        j = c * res.pushed.shape[1] + k
        trio = {f"{j}prototype-img-original.jpg", f"{j}prototype-img-original_with_self_act.jpg",
                f"{j}prototype-img.jpg"}
        assert trio <= set(got), j
        names |= trio
        if same[c, k]:
            for name in trio:
                assert got[name].shape == want[name].shape, name
                np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert names == set(got)
    if not len(_near_tie_prototypes(pstate)):
        assert set(got) == set(want)
    assert got[f"{j}prototype-img-original.jpg"].shape == (IMG, IMG, 3)

    # the provenance table beside the pictures
    with open(tmp_path / "push_provenance.json", "w") as f:
        json.dump({"epoch": 3, **tpush.provenance_dict(res)}, f)
    loaded = tpush.load_push_provenance(str(tmp_path))
    assert loaded == jpush.load_push_provenance(str(tmp_path))
    assert loaded["epoch"] == 3 and len(loaded["image_id"]) == res.pushed.size

    # without an epoch the files go into save_dir itself
    _, res2 = tpush.push_prototypes(ptrainer, pstate, batches, save_dir=str(tmp_path / "flat"),
                                    load_image=_load_image(batches))
    assert len(os.listdir(tmp_path / "flat")) == 3 * int(res2.pushed.sum())
