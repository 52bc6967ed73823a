"""Interpretability metrics: consistency, stability, purity (counterpart of
mgproto_tpu/engine/interpretability.py).

Reference: utils/interpretability.py. All three metrics share one primitive:
for each prototype of an image's ground-truth class, upsample its activation
map to pixel space, take a box of `half_size` around the argmax, and mark
which annotated bird parts fall inside (the "hit matrix").

  * consistency (interpretability.py:134-160): a prototype is consistent if
    some part is hit in >= `part_thresh` of the class's images (normalized by
    that part's visibility count). Score = % consistent prototypes.
  * stability (interpretability.py:163-178): % of images whose hit vector is
    unchanged when imperceptible Gaussian noise perturbs the input.
  * purity (interpretability.py:183-315): over each prototype's top-K most
    activated images, the best per-part mean hit rate; score = mean/std over
    prototypes (x100).

The collection runs on the trainer's device: the trunk in eval mode feeds
`gt_class_log_densities` (the class's K prototypes only) and `exp`, so the
maps are exp(log-density), the reference's `-proto_dist` (model.py:437),
and stay on the device. The peaks are batched there too (`peak_positions`:
a class's maps upsampled in bounded chunks, argmax, only [n, K] positions
come back); the scalar host form `peak_box` is kept as their reference.
The hit matrices and the metric arithmetic are numpy on the host, in the
JAX package's order. One process: nothing is gathered across hosts.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mgproto_tpu_torch.core.mgproto import gt_class_log_densities
from mgproto_tpu_torch.data.cub_parts import CubParts, in_bbox
from mgproto_tpu_torch.engine.eval import eval_mode, to_device_images
from mgproto_tpu_torch.utils.vis import upsample_activation

# maps upsampled at once by `peak_positions`: 256 x 224 x 224 f32 = 51 MB
PEAK_CHUNK = 256

Activations = Tuple[torch.Tensor, np.ndarray, np.ndarray]


def perturb_images(
    images: np.ndarray, rng: np.random.Generator, std: float = 0.2,
    eps: float = 0.25,
) -> np.ndarray:
    """Clipped Gaussian noise on NORMALIZED images (reference
    interpretability.py:14-18)."""
    noise = np.clip(
        rng.normal(0.0, std, size=images.shape), -eps, eps
    ).astype(images.dtype)
    return images + noise


def gt_act(model, gmm, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """[B, K, h, w] exp-density maps of each image's ground-truth class's
    prototypes (the JAX `make_gt_act_fn`'s function)."""
    lp, _ = gt_class_log_densities(model, gmm, images, labels)
    return torch.exp(lp)


def collect_gt_activations(
    trainer,
    state,
    batches,
    use_noise: bool = False,
    noise_seed: int = 0,
    act_fn=None,
) -> Activations:
    """Run the test set; returns (acts [N, K, h, w] on the trainer's device,
    targets [N], img_ids [N] numpy). `batches` yields (normalized images,
    labels, img_ids) host batches; the noise is drawn on the host over each
    whole batch, pad rows included, in loader order (as the JAX package
    draws it); padded rows (label -1) are dropped after collection.
    `act_fn(model, gmm, images, labels)` computes a batch's maps (default
    `gt_act`; trust/interp_sharded.py passes the class-sharded one)."""
    act_fn = gt_act if act_fn is None else act_fn
    rng = np.random.default_rng(noise_seed)
    accs, targets, ids = [], [], []
    with trainer.full_params(state), eval_mode(state.model) as model:
        for batch in batches:
            images, labels, img_ids = batch[0], np.asarray(batch[1]), np.asarray(batch[2])
            images = np.asarray(images, np.float32)
            if use_noise:
                images = perturb_images(images, rng)
            x = to_device_images(images, trainer.device)
            lbl = torch.from_numpy(np.maximum(labels, 0).astype(np.int64)).to(trainer.device)
            accs.append(act_fn(model, state.gmm, x, lbl))
            targets.append(labels)
            ids.append(img_ids)
    target, img_id = np.concatenate(targets), np.concatenate(ids)
    valid = target >= 0
    acc = torch.cat(accs)[torch.from_numpy(np.nonzero(valid)[0]).to(trainer.device)]
    return acc, target[valid], img_id[valid]


def _box(my: int, mx: int, img_size: int, half_size: int) -> Tuple[int, int, int, int]:
    return (
        max(0, int(my) - half_size),
        min(img_size, int(my) + half_size),
        max(0, int(mx) - half_size),
        min(img_size, int(mx) + half_size),
    )


def peak_box(
    act_map: np.ndarray, img_size: int, half_size: int
) -> Tuple[int, int, int, int]:
    """(y1, y2, x1, x2) box of side 2*half_size around the upsampled
    activation argmax, clipped to the image (reference
    interpretability.py:108-120 region arithmetic). One [h, w] map,
    upsampled on the host: the reference form of `peak_positions`."""
    up = upsample_activation(np.asarray(act_map, np.float32), (img_size, img_size))
    my, mx = np.unravel_index(np.argmax(up), up.shape)
    return _box(my, mx, img_size, half_size)


def peak_positions(act_maps, img_size: int) -> np.ndarray:
    """[..., h, w] maps -> [..., 2] (y, x) of each map's upsampled argmax,
    the first maximum in row-major order (as numpy's). A tensor is upsampled
    on its device, PEAK_CHUNK maps at a time; only the positions come back."""
    maps = act_maps if isinstance(act_maps, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(act_maps, np.float32))
    lead = maps.shape[:-2]
    flat = maps.reshape(-1, *maps.shape[-2:])
    size = (img_size, img_size)
    idx = [upsample_activation(flat[i:i + PEAK_CHUNK], size).flatten(1).argmax(-1)
           for i in range(0, flat.shape[0], PEAK_CHUNK)]
    idx = torch.cat(idx).cpu().numpy() if idx else np.zeros(0, np.int64)
    return np.stack(np.divmod(idx, img_size), -1).reshape(*lead, 2)


def hit_matrix(
    act_maps,  # [N, K, h, w] one class's images
    part_labels: Sequence[Sequence[Sequence[int]]],  # per image [(pid, x, y)]
    part_num: int,
    img_size: int,
    half_size: int,
    rows: Optional[Sequence[int]] = None,  # image row of each output row
) -> np.ndarray:
    """The shared geometric core (reference interpretability.py:108-131):
    for image i and prototype k, mark parts within `half_size` of the
    upsampled activation argmax. Returns [K, R, part_num] where R = number of
    rows (= N, or len(rows) when a top-K subset is scored)."""
    n, k_per_class = act_maps.shape[:2]
    sel = list(range(n)) if rows is None else [int(r) for r in rows]
    out = np.zeros((k_per_class, len(sel), part_num))
    peaks = peak_positions(act_maps[sel], img_size)  # [R, K, 2]
    for k in range(k_per_class):
        for out_row, img_idx in enumerate(sel):
            region = _box(*peaks[out_row, k], img_size, half_size)
            for pid, x, y in part_labels[img_idx]:
                if in_bbox((y, x), region):
                    out[k, out_row, pid] = 1
    return out


def _per_class_annotations(
    parts: CubParts, img_ids: np.ndarray, img_size: int
) -> Tuple[List[List[List[int]]], np.ndarray]:
    """Part labels + visibility masks for a class's images, rescaled to the
    model's input size using each image's ORIGINAL dimensions."""
    labels, masks = [], []
    for img_id in img_ids:
        pl, mask = parts.scaled_part_labels(
            int(img_id), parts.orig_wh(int(img_id)), img_size
        )
        labels.append(pl)
        masks.append(mask)
    return labels, np.stack(masks)


def _topk_rows(class_acts, top_k: int) -> np.ndarray:
    """[kk, K] image rows of each prototype's top-K peak activations —
    the ONE selection rule shared by evaluate_purity and the CSV export
    (stable sort: ties break toward the earlier image)."""
    peak = torch.as_tensor(class_acts).amax(dim=(2, 3)).cpu().numpy()  # [N, K]
    order = np.argsort(-peak, axis=0, kind="stable")
    return order[: min(top_k, class_acts.shape[0])]


def _iter_class_hits(
    acts,
    targets: np.ndarray,
    img_ids: np.ndarray,
    parts: CubParts,
    img_size: int,
    half_size: int,
    num_classes: int,
    top_k: Optional[int] = None,
):
    """Yields (class, hits [K,R,P], masks [N,P]) per class, in class order.
    With top_k, R indexes each prototype's top-K most-activated images
    (reference interpretability.py:222-224)."""
    for c in range(num_classes):
        idx = np.nonzero(targets == c)[0]
        if idx.size == 0:
            continue
        class_acts = acts[idx]
        labels, masks = _per_class_annotations(parts, img_ids[idx], img_size)
        if top_k is None:
            yield c, hit_matrix(
                class_acts, labels, parts.part_num, img_size, half_size
            ), masks
        else:
            order = _topk_rows(class_acts, top_k)
            # one single-prototype hit_matrix per k: scoring only that
            # prototype's top-K images (not K x K work)
            hits = np.stack(
                [
                    hit_matrix(
                        class_acts[:, k : k + 1],
                        labels,
                        parts.part_num,
                        img_size,
                        half_size,
                        rows=list(order[:, k]),
                    )[0]
                    for k in range(class_acts.shape[1])
                ]
            )
            yield c, hits, masks


def evaluate_consistency(
    trainer,
    state,
    batches,
    parts: CubParts,
    num_classes: int,
    half_size: int = 36,
    part_thresh: float = 0.8,
    activations: Optional[Activations] = None,
) -> float:
    """% of prototypes hitting the same visible part in >= part_thresh of
    their class's images (reference interpretability.py:134-160).
    `activations` = a precomputed collect_gt_activations triple (shared
    across metrics so the test set forwards once)."""
    img_size = trainer.cfg.model.img_size
    acts, targets, img_ids = (
        activations
        if activations is not None
        else collect_gt_activations(trainer, state, batches)
    )
    consis = []
    for _c, hits, masks in _iter_class_hits(
        acts, targets, img_ids, parts, img_size, half_size, num_classes
    ):
        vis_count = np.maximum(masks.sum(axis=0), 1.0)  # [P]
        for k in range(hits.shape[0]):
            mean_part = hits[k].sum(axis=0) / vis_count
            consis.append(1 if (mean_part >= part_thresh).any() else 0)
    return float(np.mean(consis) * 100.0)


def evaluate_stability(
    trainer,
    state,
    batches_factory,
    parts: CubParts,
    num_classes: int,
    half_size: int = 36,
    noise_seed: int = 0,
    activations: Optional[Activations] = None,
    noisy_activations: Optional[Activations] = None,
) -> float:
    """% of (prototype, image) hit vectors unchanged under input noise
    (reference interpretability.py:163-178). `batches_factory()` returns a
    fresh batch iterator; the clean pass reuses `activations` and the noisy
    pass `noisy_activations` when given (a caller that times the noisy pass
    by itself collects it with `use_noise=True, noise_seed=noise_seed`)."""
    img_size = trainer.cfg.model.img_size
    acts, targets, img_ids = (
        activations
        if activations is not None
        else collect_gt_activations(trainer, state, batches_factory())
    )
    acts_n, _, _ = (
        noisy_activations
        if noisy_activations is not None
        else collect_gt_activations(
            trainer, state, batches_factory(), use_noise=True, noise_seed=noise_seed)
    )
    stab = []
    clean = _iter_class_hits(
        acts, targets, img_ids, parts, img_size, half_size, num_classes
    )
    noisy = _iter_class_hits(
        acts_n, targets, img_ids, parts, img_size, half_size, num_classes
    )
    for (_c, h0, _m0), (_c2, h1, _m1) in zip(clean, noisy):
        for k in range(h0.shape[0]):
            unchanged = (np.abs(h0[k] - h1[k]).sum(axis=-1) == 0)
            stab.append(unchanged.mean())
    return float(np.mean(stab) * 100.0)


def evaluate_purity(
    trainer,
    state,
    batches,
    parts: CubParts,
    num_classes: int,
    half_size: int = 16,
    top_k: int = 10,
    activations: Optional[Activations] = None,
) -> Tuple[float, float]:
    """Mean/std over prototypes of the best per-part hit rate across each
    prototype's top-K activated images (reference interpretability.py:298-315)."""
    img_size = trainer.cfg.model.img_size
    acts, targets, img_ids = (
        activations
        if activations is not None
        else collect_gt_activations(trainer, state, batches)
    )
    purity = []
    for _c, hits, _masks in _iter_class_hits(
        acts, targets, img_ids, parts, img_size, half_size, num_classes,
        top_k=top_k,
    ):
        for k in range(hits.shape[0]):
            purity.append(hits[k].mean(axis=0).max())
    arr = np.asarray(purity)
    return float(arr.mean() * 100.0), float(arr.std() * 100.0)


# ------------------------------------------------------- CSV export (parity)
def export_prototype_patches_csv(
    path: str,
    trainer,
    state,
    batches,
    num_classes: int,
    half_size: int = 16,
    top_k: int = 10,
    activations: Optional[Activations] = None,
) -> int:
    """Write each prototype's top-K activated patches as CSV rows
    `class,k,rank,img_id,ymin,ymax,xmin,xmax` (coordinates on the model's
    input grid) — the reference's method-agnostic purity interchange format
    (reference cub_csv.py:225-266 `get_proto_patches_cub` /
    eval_prototypes_cub_parts_csv input). Returns the number of rows. The
    boxes come from the peaks `evaluate_purity` scores (`peak_positions`),
    so `purity_from_csv` on this file gives its numbers."""
    import csv as _csv

    img_size = trainer.cfg.model.img_size
    acts, targets, img_ids = (
        activations
        if activations is not None
        else collect_gt_activations(trainer, state, batches)
    )
    rows = 0
    with open(path, "w", newline="") as f:
        w = _csv.writer(f)
        w.writerow(
            ["class", "k", "rank", "img_id", "ymin", "ymax", "xmin", "xmax"]
        )
        for c in range(num_classes):
            idx = np.nonzero(targets == c)[0]
            if idx.size == 0:
                continue
            class_acts = acts[idx]
            class_ids = img_ids[idx]
            order = _topk_rows(class_acts, top_k)
            for k in range(class_acts.shape[1]):
                peaks = peak_positions(class_acts[list(order[:, k]), k], img_size)
                for rank, n in enumerate(order[:, k]):
                    y1, y2, x1, x2 = _box(*peaks[rank], img_size, half_size)
                    w.writerow(
                        [c, k, rank, int(class_ids[n]), y1, y2, x1, x2]
                    )
                    rows += 1
    return rows


def purity_from_csv(
    csvfile: str, parts: CubParts, img_size: int
) -> Tuple[float, float]:
    """Recompute purity from an exported patch CSV — works for ANY
    part-prototype method that emits the same rows (reference
    cub_csv.py:55-222 `eval_prototypes_cub_parts_csv` capability). Must agree
    with `evaluate_purity` when fed this framework's own export."""
    import csv as _csv
    from collections import defaultdict

    by_proto = defaultdict(list)
    with open(csvfile, newline="") as f:
        reader = _csv.DictReader(f)
        for row in reader:
            by_proto[(int(row["class"]), int(row["k"]))].append(
                (
                    int(row["img_id"]),
                    (
                        int(row["ymin"]),
                        int(row["ymax"]),
                        int(row["xmin"]),
                        int(row["xmax"]),
                    ),
                )
            )
    purity = []
    for (_c, _k), entries in sorted(by_proto.items()):
        hits = np.zeros((len(entries), parts.part_num))
        for r, (img_id, box) in enumerate(entries):
            labels, _ = parts.scaled_part_labels(
                img_id, parts.orig_wh(img_id), img_size
            )
            for pid, x, y in labels:
                if in_bbox((y, x), box):
                    hits[r, pid] = 1
        purity.append(hits.mean(axis=0).max())
    arr = np.asarray(purity)
    return float(arr.mean() * 100.0), float(arr.std() * 100.0)
