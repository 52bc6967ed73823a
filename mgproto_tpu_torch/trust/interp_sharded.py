"""Interpretability metrics with the device half sharded over the rank
mesh (counterpart of mgproto_tpu/trust/interp_sharded.py).

`engine/interpretability.py` scores consistency, stability and purity from
one activation pass (`collect_gt_activations`) and a host post-pass. Here
the activation pass runs over the ranks of a `ShardedTrainer`'s mesh:

  * every rank reads the same global batches and forwards its own rows
    (rank r takes rows [r*b, (r+1)*b), as `parallel/sharding.py::put_batch`
    cuts a batch);
  * when the model axis splits the classes, the feature maps of a data
    row's ranks are gathered over its model group, each rank scores every
    gathered row against its [C/nm, K, d] slab only, keeps the rows whose
    ground-truth class it owns (zeros elsewhere), and one sum over the
    model group assembles the rows' [K, h, w] log-density maps, as the JAX
    shard_map's psum does; without a split each rank scores its rows
    against the whole mixture;
  * the maps are exponentiated and gathered over every rank in rank
    order, so each rank holds the batch's [B, K, h, w] maps, and the host
    post-pass is the one-process one, unchanged.

A batch that does not split over the ranks, or a class count the model
axis does not divide, falls back to the one-process maps for that call on
every rank alike (no collective), as JAX falls back. The collectives are
the trainer's mesh's groups: every rank calls these functions together.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mgproto_tpu_torch.core.mgproto import l2_normalize, row_class_log_densities
from mgproto_tpu_torch.engine.interpretability import (
    collect_gt_activations,
    evaluate_consistency,
    evaluate_purity,
    evaluate_stability,
    gt_act,
)
from mgproto_tpu_torch.parallel.collectives import all_gather, all_reduce_sum


def make_gt_act_fn_sharded(mesh, num_classes: int):
    """(model, gmm, images [B, ...], labels [B]) -> this batch's [B, K, h,
    w] maps, the device half sharded over `mesh` (see the module's
    docstring). `gmm` is the rank's slab when the model axis splits the
    classes, else the whole mixture. B must split over the ranks."""
    split = mesh.shards_classes(num_classes)

    def fn(model, gmm, images, labels):
        b = images.shape[0] // mesh.size
        rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
        x, lbl = images[rows], labels[rows]
        if not split:
            maps = gt_act(model, gmm, x, lbl)
        else:
            proto_map, _ = model(x)
            _, h, w, d = proto_map.shape
            feat = all_gather(l2_normalize(proto_map, dim=-1).reshape(b, h * w, d), 0,
                              mesh.model_group)
            lab = all_gather(lbl.long(), 0, mesh.model_group)
            c_loc = gmm.num_classes
            rel = lab - mesh.model_index * c_loc
            own = (rel >= 0) & (rel < c_loc)
            lp = row_class_log_densities(feat, gmm, rel.clamp(0, c_loc - 1))  # [n, K, HW]
            lp = all_reduce_sum(torch.where(own[:, None, None], lp, 0.0), mesh.model_group)
            mi = mesh.model_index
            maps = torch.exp(lp[mi * b:(mi + 1) * b]).reshape(b, gmm.k_per_class, h, w)
        return all_gather(maps, 0, mesh.world_group)

    return fn


def sharded_act_fn(trainer, state):
    """The activation function `collect_gt_activations` should use for
    `trainer` and its (slab) `state`: the sharded one on a mesh of several
    ranks, the one-process `gt_act` otherwise (a plain Trainer, one rank,
    or a class count the model axis does not divide). A batch that does
    not split over the ranks takes `gt_act` on the whole mixture, gathered
    once here (a collective: every rank calls this together)."""
    mesh = getattr(trainer, "mesh", None)
    c = trainer.cfg.model.num_classes
    if mesh is None or mesh.size == 1 or (mesh.model > 1 and c % mesh.model):
        return gt_act
    shard_fn = make_gt_act_fn_sharded(mesh, c)
    full = trainer.full_gmm(state)

    def fn(model, gmm, images, labels):
        if images.shape[0] % mesh.size == 0:
            return shard_fn(model, gmm, images, labels)
        return gt_act(model, full, images, labels)

    return fn


def collect_gt_activations_sharded(trainer, state, batches, use_noise: bool = False,
                                   noise_seed: int = 0):
    """The sharded drop-in for `collect_gt_activations`: the same triple,
    the device half sharded."""
    return collect_gt_activations(trainer, state, batches, use_noise=use_noise,
                                  noise_seed=noise_seed, act_fn=sharded_act_fn(trainer, state))


def evaluate_consistency_sharded(trainer, state, batches, parts, num_classes: int,
                                 half_size: int = 36, part_thresh: float = 0.8,
                                 activations: Optional[Tuple] = None) -> float:
    acts = (activations if activations is not None
            else collect_gt_activations_sharded(trainer, state, batches))
    return evaluate_consistency(trainer, state, None, parts, num_classes, half_size=half_size,
                                part_thresh=part_thresh, activations=acts)


def evaluate_stability_sharded(trainer, state, batches_factory, parts, num_classes: int,
                               half_size: int = 36, noise_seed: int = 0,
                               activations: Optional[Tuple] = None) -> float:
    acts = (activations if activations is not None
            else collect_gt_activations_sharded(trainer, state, batches_factory()))
    noisy = collect_gt_activations_sharded(trainer, state, batches_factory(), use_noise=True,
                                           noise_seed=noise_seed)
    return evaluate_stability(trainer, state, None, parts, num_classes, half_size=half_size,
                              activations=acts, noisy_activations=noisy)


def evaluate_purity_sharded(trainer, state, batches, parts, num_classes: int,
                            half_size: int = 16, top_k: int = 10,
                            activations: Optional[Tuple] = None) -> Tuple[float, float]:
    acts = (activations if activations is not None
            else collect_gt_activations_sharded(trainer, state, batches))
    return evaluate_purity(trainer, state, None, parts, num_classes, half_size=half_size,
                           top_k=top_k, activations=acts)


def interp_metrics_sharded(trainer, state, batches_factory, parts, num_classes: int,
                           consistency_half_size: int = 36, purity_half_size: int = 16,
                           part_thresh: float = 0.8, top_k: int = 10,
                           noise_seed: int = 0) -> Dict[str, float]:
    """All three metrics from one sharded activation pass over the test set
    (and the noisy pass stability needs): the `cli.trust interp` payload.
    `batches_factory()` returns a fresh (images, labels, img_ids) iterator
    of global batches, the same on every rank."""
    acts = collect_gt_activations_sharded(trainer, state, batches_factory())
    consistency = evaluate_consistency(trainer, state, None, parts, num_classes,
                                       half_size=consistency_half_size,
                                       part_thresh=part_thresh, activations=acts)
    stability = evaluate_stability_sharded(trainer, state, batches_factory, parts, num_classes,
                                           half_size=consistency_half_size,
                                           noise_seed=noise_seed, activations=acts)
    purity, purity_std = evaluate_purity(trainer, state, None, parts, num_classes,
                                         half_size=purity_half_size, top_k=top_k,
                                         activations=acts)
    mesh = getattr(trainer, "mesh", None)
    return {"consistency": float(consistency), "stability": float(stability),
            "purity": float(purity), "purity_std": float(purity_std),
            "num_images": int(np.asarray(acts[1]).shape[0]),
            "sharded": mesh is not None and mesh.size > 1}
