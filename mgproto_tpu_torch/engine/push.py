"""Prototype projection ("push", counterpart of mgproto_tpu/engine/push.py):
snap each Gaussian prototype mean to its nearest real training patch.

Two passes, as in the JAX package:
  1. the scan (`scan_batch`, on the state's device): for each image of the
     push set, the best patch of each of its ground-truth class's K
     prototypes: its log-density, its flat spatial index and the
     L2-normalized feature there. Only that class's K prototypes are
     scored (`core/mgproto.py::gt_class_log_densities`, plain torch; the
     JAX package computes the push density outside any Pallas kernel too);
  2. the greedy assignment (`_greedy_assign`, on the host): prototypes in
     order c*K + k take their best candidate from an image no earlier
     prototype has taken.
The chosen features are written into `gmm.means` in place (the mean
optimizer's leaf), under `torch.no_grad()`; prototypes whose class has no
image in the push set keep their mean bit for bit.

With a `save_dir`, `render_prototypes` then draws each pushed prototype
(the JAX package's `_render`): its source image forwarded once per class,
the map upsampled on the state's device, the crop, overlay and JPEGs on the
host through utils/vis.py.

The push loader yields resize-only images in [0, 1]; they are normalized
here with `preprocess_input`.

Under several ranks (parallel/) each scans its loader shard against every
class's prototypes (`Trainer.full_gmm`, the slabs gathered), the
candidates are gathered in rank order, every rank runs the same greedy
assignment and writes its own class slab's means, and rank 0 alone
renders.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mgproto_tpu_torch.core.mgproto import GMMState, MGProtoFeatures, gt_class_log_densities
from mgproto_tpu_torch.core.state import TrainState
from mgproto_tpu_torch.engine.eval import eval_mode, to_device_images
from mgproto_tpu_torch.parallel.multihost import allgather_rows, is_primary_host
from mgproto_tpu_torch.utils import vis
from mgproto_tpu_torch.utils.images import preprocess_input


class PushResult(NamedTuple):
    """Per-prototype projection record, [C, K] numpy arrays.

    pushed:      bool, a patch was found (a class with no image in the push
                 set keeps its mean);
    image_id:    int, the dataset index of the source image (-1 if not
                 pushed), the dedup key;
    spatial_idx: int, the flat latent index h * W + w of the chosen patch;
    log_prob:    float, the patch's log-density under the prototype.
    """

    pushed: np.ndarray
    image_id: np.ndarray
    spatial_idx: np.ndarray
    log_prob: np.ndarray


class PushCandidates(NamedTuple):
    """The scan's output over the push set, on the host: labels [N],
    image_ids [N], vals [N, K], idxs [N, K], fvecs [N, K, d]."""

    labels: np.ndarray
    image_ids: np.ndarray
    vals: np.ndarray
    idxs: np.ndarray
    fvecs: np.ndarray


def provenance_dict(result: PushResult) -> Dict[str, list]:
    """A PushResult as the JSON-able nearest-training-patch table
    (push_provenance.json): flat [C*K] image id, latent spatial index and
    patch log-density per prototype; -1 ids where nothing was pushed."""
    return {
        "image_id": [int(v) for v in result.image_id.reshape(-1)],
        "spatial_idx": [int(v) for v in result.spatial_idx.reshape(-1)],
        "log_prob": [float(v) for v in result.log_prob.reshape(-1)],
    }


def load_push_provenance(model_dir: str) -> Optional[Dict]:
    """The run's push_provenance.json as a dict, or None when the run never
    pushed."""
    path = os.path.join(model_dir, "push_provenance.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def scan_batch(model: MGProtoFeatures, gmm: GMMState, images: torch.Tensor,
               labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pass 1 on one normalized batch: (val [B, K], idx [B, K], fvec
    [B, K, d]), each image's best patch per prototype of its ground-truth
    class. The caller puts the model in eval mode. A label outside [0, C)
    (a pad row) is clamped for the gather; the greedy never picks its row."""
    lp, feat = gt_class_log_densities(model, gmm, images, labels)
    b, k, h, w = lp.shape
    d = feat.shape[-1]
    lp, feat = lp.reshape(b, k, h * w), feat.reshape(b, h * w, d)
    idx = lp.argmax(-1)  # the first index of the maximum, as jnp.argmax
    val = lp.gather(-1, idx[..., None])[..., 0]
    fvec = feat.gather(1, idx[..., None].expand(-1, -1, d))
    return val, idx, fvec


def scan_candidates(trainer, state: TrainState, batches: Iterable,
                    gmm: Optional[GMMState] = None) -> PushCandidates:
    """Pass 1 over (images in [0, 1], labels, image_ids[, ...]) host batches,
    the push loader's, with the state's model in eval mode, against `gmm`
    (every class; the state's own by default). Under several ranks the
    candidates of every rank's shard, gathered in rank order."""
    gmm = state.gmm if gmm is None else gmm
    out: Dict[str, List[np.ndarray]] = {k: [] for k in PushCandidates._fields}
    with trainer.full_params(state), eval_mode(state.model) as model:
        for batch in batches:
            images, labels, image_ids = batch[0], batch[1], batch[2]
            x = to_device_images(preprocess_input(np.asarray(images, np.float32)), trainer.device)
            lbl = torch.from_numpy(np.asarray(labels, np.int64)).to(trainer.device)
            val, idx, fvec = scan_batch(model, gmm, x, lbl)
            out["labels"].append(np.asarray(labels))
            out["image_ids"].append(np.asarray(image_ids))
            out["vals"].append(val.cpu().numpy())
            out["idxs"].append(idx.cpu().numpy())
            out["fvecs"].append(fvec.cpu().numpy())
    if not out["labels"]:
        raise ValueError("push set is empty")
    return PushCandidates(**{k: allgather_rows(np.concatenate(v)) for k, v in out.items()})


def _greedy_assign(
    labels: np.ndarray,  # [N]
    image_ids: np.ndarray,  # [N]
    vals: np.ndarray,  # [N, K]
    idxs: np.ndarray,  # [N, K]
    fvecs: np.ndarray,  # [N, K, d]
    num_classes: int,
) -> Tuple[np.ndarray, PushResult]:
    """Pass 2: prototypes claim images greedily in prototype order
    (c * K + k), best candidate first, one distinct image per prototype
    across the whole prototype set. Rows are grouped by `labels == c`, so a
    label -1 row is never picked."""
    k_per_class = vals.shape[1]
    d = fvecs.shape[-1]
    new_means = np.zeros((num_classes, k_per_class, d), np.float32)
    pushed = np.zeros((num_classes, k_per_class), bool)
    out_img = np.full((num_classes, k_per_class), -1, np.int64)
    out_idx = np.full((num_classes, k_per_class), -1, np.int64)
    out_lp = np.full((num_classes, k_per_class), -np.inf, np.float64)

    used: set = set()
    for c in range(num_classes):
        rows = np.where(labels == c)[0]
        if rows.size == 0:
            continue
        for k in range(k_per_class):
            order = rows[np.argsort(-vals[rows, k])]  # best density first
            for r in order:
                img = int(image_ids[r])
                if img in used:
                    continue
                used.add(img)
                new_means[c, k] = fvecs[r, k]
                pushed[c, k] = True
                out_img[c, k] = img
                out_idx[c, k] = int(idxs[r, k])
                out_lp[c, k] = float(vals[r, k])
                break
    return new_means, PushResult(pushed, out_img, out_idx, out_lp)


def write_back(gmm: GMMState, new_means: np.ndarray, pushed: np.ndarray) -> None:
    """Copy the pushed prototypes' new means into `gmm.means` in place (the
    tensor the mean optimizer holds); the others keep theirs bit for bit."""
    dev = gmm.means.device
    nm = torch.from_numpy(new_means).to(dev)
    pm = torch.from_numpy(pushed).to(dev)
    with torch.no_grad():
        gmm.means.copy_(torch.where(pm[:, :, None], nm, gmm.means))


def push_prototypes(
    trainer,
    state: TrainState,
    batches: Iterable,
    save_dir: Optional[str] = None,
    epoch: Optional[int] = None,
    load_image: Optional[Callable[[int], np.ndarray]] = None,
) -> Tuple[TrainState, PushResult]:
    """Project every prototype mean onto its nearest training patch.

    `batches`: (images [B, H, W, 3] in [0, 1], unnormalized; labels [B];
    image_ids [B]) host batches, the push loader's. Updates `state.gmm.means`
    in place and returns (state, PushResult). With `save_dir`, renders 3
    files per pushed prototype into `save_dir/epoch-{epoch}` (`save_dir`
    itself when `epoch` is None); that needs `load_image`: image_id ->
    [H, W, 3] float in [0, 1], the push transform's image."""
    if save_dir is not None and load_image is None:
        raise ValueError("save_dir requires load_image")
    gmm = trainer.full_gmm(state)
    # the whole parameters for the scan and rank 0's render, every rank alike
    with trainer.full_params(state):
        cand = scan_candidates(trainer, state, batches, gmm)
        new_means, result = _greedy_assign(*cand, gmm.num_classes)
        if gmm is state.gmm:
            write_back(gmm, new_means, result.pushed)
        else:  # a mesh's class slabs: this rank's, and the gathered copy the render reads
            c0, c1 = trainer.class_slab()
            write_back(state.gmm, new_means[c0:c1], result.pushed[c0:c1])
            write_back(gmm, new_means, result.pushed)
        if save_dir is not None and is_primary_host():
            render_prototypes(trainer, state, result, load_image, save_dir, epoch, gmm=gmm)
    return state, result


def render_prototypes(
    trainer,
    state: TrainState,
    result: PushResult,
    load_image: Callable[[int], np.ndarray],
    save_dir: str,
    epoch: Optional[int] = None,
    gmm: Optional[GMMState] = None,
) -> str:
    """Per pushed prototype j = c*K + k, three JPEGs (reference
    push.py:202-226): `{j}prototype-img-original.jpg` (the source image
    with the high-activation box), `{j}prototype-img-original_with_self_act.jpg`
    (the activation overlay with the box) and `{j}prototype-img.jpg` (the
    crop). Activations are exp(log-density) of the class's prototypes on
    the image (the reference's `-proto_dist`); each chosen image is
    forwarded once per class and its [K, H, W] map upsampled on the state's
    device, under `gmm` (every class; the state's own by default). Under a
    mesh that cuts the parameters the caller holds `trainer.full_params(
    state)` on every rank (a collective), as `push_prototypes` does. Returns
    the directory written."""
    gmm = state.gmm if gmm is None else gmm
    out = os.path.join(save_dir, f"epoch-{epoch}") if epoch is not None else save_dir
    vis.makedir(out)
    dev = trainer.device
    c_total, k_per_class = result.pushed.shape
    with eval_mode(state.model) as model:
        for c in range(c_total):
            if not result.pushed[c].any():
                continue
            img_cache: Dict[int, Tuple[np.ndarray, torch.Tensor]] = {}
            for k in range(k_per_class):
                if not result.pushed[c, k]:
                    continue
                img_id = int(result.image_id[c, k])
                if img_id not in img_cache:
                    raw = np.asarray(load_image(img_id), np.float32)
                    x = to_device_images(preprocess_input(raw)[None], dev)
                    lp, _ = gt_class_log_densities(
                        model, gmm, x, torch.full((1,), c, dtype=torch.long, device=dev))
                    img_cache[img_id] = (raw, torch.exp(lp[0]))  # [K, H, W]
                raw, acts = img_cache[img_id]
                j = c * k_per_class + k  # the reference's flat prototype index
                up = vis.upsample_activation(acts[k], raw.shape[:2]).cpu().numpy()
                y0, y1, x0, x1 = vis.find_high_activation_crop(up)
                vis.imsave_with_bbox(
                    os.path.join(out, f"{j}prototype-img-original.jpg"),
                    raw, y0, y1, x0, x1)
                vis.imsave_with_bbox(
                    os.path.join(out, f"{j}prototype-img-original_with_self_act.jpg"),
                    vis.heatmap_overlay(raw, up), y0, y1, x0, x1)
                vis.imsave(os.path.join(out, f"{j}prototype-img.jpg"), raw[y0:y1, x0:x1])
    return out
