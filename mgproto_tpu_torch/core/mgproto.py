"""The MGProto model: feature extractor + functional GMM head
(counterpart of mgproto_tpu/core/mgproto.py).

  * `MGProtoFeatures` (nn.Module): backbone trunk + add-on 1x1 convs +
    auxiliary embedding. Takes images [B, H, W, 3] and returns the proto map
    [B, H', W', d] and the embedding [B, E], the JAX package's layouts, both
    f32. Inside, the trunk runs NCHW tensors in channels_last memory, in
    `ModelConfig.compute_dtype` (perf/precision.py).
  * `GMMState`: prototype means/sigmas/priors + pruning mask.
  * `head_forward`: density -> top-T mining pool -> mine masking ->
    per-class mixture log-likelihoods, plus deduped enqueue candidates.
    `fused=True` routes density + top-T through `score_pool`, whose
    backward gives the feature gradient in training. The GMM is a constant
    of the classification loss (EM trains it): callers pass detached means.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from mgproto_tpu_torch.config import ModelConfig
from mgproto_tpu_torch.models.common import Conv2d
from mgproto_tpu_torch.models.registry import build_backbone, family, init_random_weights
from mgproto_tpu_torch.numerics import apply_numerics_policy, resolve_device, use_kernel
from mgproto_tpu_torch.perf.precision import resolve_policy
from mgproto_tpu_torch.ops.fused_scoring import score_pool
from mgproto_tpu_torch.ops.gaussian import (
    DEFAULT_SIGMA_EPS,
    diag_gaussian_log_prob,
    precompute_diag_gaussian,
)
from mgproto_tpu_torch.ops.pooling import (
    PooledActivations,
    dedup_first_occurrence,
    mine_mask_activations,
    top_t_pool,
)
from mgproto_tpu_torch.parallel.collectives import all_gather, all_reduce_sum


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) (F.normalize parity)."""
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=dim, keepdim=True), eps)


class GMMState(NamedTuple):
    """means/sigmas [C, K, d] (sigma is a std), priors [C, K], keep [C, K] bool."""

    means: torch.Tensor
    sigmas: torch.Tensor
    priors: torch.Tensor
    keep: torch.Tensor

    @property
    def num_classes(self) -> int:
        return self.means.shape[0]

    @property
    def k_per_class(self) -> int:
        return self.means.shape[1]

    def to(self, device) -> "GMMState":
        return GMMState(*(t.to(device) for t in self))


def init_gmm(cfg: ModelConfig, generator: torch.Generator,
             device: Union[str, torch.device, None] = None) -> GMMState:
    """L2-normalized uniform-random means, sigma = cfg.init_sigma, priors
    1/K, all kept. Drawn on the CPU from `generator`, then moved."""
    dev = resolve_device(device)
    c, k, d = cfg.num_classes, cfg.prototypes_per_class, cfg.proto_dim
    means = l2_normalize(torch.rand(c, k, d, generator=generator))
    return GMMState(
        means=means,
        sigmas=torch.full((c, k, d), cfg.init_sigma),
        priors=torch.full((c, k), 1.0 / k),
        keep=torch.ones(c, k, dtype=torch.bool),
    ).to(dev)


class AddOnLayers(nn.Module):
    """1x1 conv adapter into prototype space. 'regular': two 1x1 convs, no
    activation. 'bottleneck': channel-halving conv/ReLU pairs ending in a
    sigmoid."""

    def __init__(self, proto_dim: int, add_on_type: str, in_channels: int):
        super().__init__()
        self.add_on_type = add_on_type
        self.names = []
        if add_on_type == "regular":
            self.conv0 = Conv2d(in_channels, proto_dim, 1)
            self.conv1 = Conv2d(proto_dim, proto_dim, 1)
        elif add_on_type == "bottleneck":
            current_in, i = in_channels, 0
            while True:
                current_out = max(proto_dim, current_in // 2)
                self.add_module(f"conv{i}_a", Conv2d(current_in, current_out, 1))
                self.add_module(f"conv{i}_b", Conv2d(current_out, current_out, 1))
                self.names.append(i)
                if current_out <= proto_dim:
                    break
                current_in, i = current_in // 2, i + 1
        else:
            raise ValueError(f"unknown add_on_type {add_on_type!r}")

    def forward(self, x):
        if self.add_on_type == "regular":
            return self.conv1(self.conv0(x))
        last = self.names[-1]
        for i in self.names:
            x = torch.relu(getattr(self, f"conv{i}_a")(x))
            x = getattr(self, f"conv{i}_b")(x)
            x = torch.sigmoid(x) if i == last else torch.relu(x)
        return x


class MGProtoFeatures(nn.Module):
    """Backbone + add-on + aux embedding. forward(images [B, H, W, 3]) ->
    (proto_map [B, H', W', d] float32, embed [B, E] L2-normalized float32).

    Mixed precision (JAX `MGProtoFeatures.__call__`): the images are cast to
    `cfg.compute_dtype` at the trunk's entry; the trunk and the add-on convs
    run in it on f32 master weights (models/common.py); the proto map is
    cast to f32 at the exit, the global average pool is taken in f32 and
    the embedding Linear stays f32, so everything downstream (density,
    log p(x), losses, the bank) is f32. `cfg.remat` / `remat_stages`
    checkpoint the resnet blocks or the dense layers (models/registry.py)."""

    def __init__(self, cfg: ModelConfig, fused_epilogue: bool = False):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = resolve_policy(cfg).torch_dtype
        self.features = build_backbone(
            cfg.arch, fused_epilogue=fused_epilogue, remat=cfg.remat,
            remat_stages=() if cfg.remat else tuple(cfg.remat_stages))
        c = self.features.out_channels
        self.add_on = AddOnLayers(cfg.proto_dim, cfg.add_on_type, c)
        self.embedding = nn.Linear(c, cfg.sz_embedding)

    def forward(self, images: torch.Tensor):
        # [B, H, W, 3] storage read as NCHW: channels_last memory, no copy
        x = self.features(images.to(self.compute_dtype).permute(0, 3, 1, 2))
        proto_map = self.add_on(x).permute(0, 2, 3, 1).float()
        embed = l2_normalize(self.embedding(x.float().mean(dim=(2, 3))), dim=-1)
        return proto_map, embed


def make_features(cfg: ModelConfig, device: torch.device) -> MGProtoFeatures:
    """MGProtoFeatures (on the CPU) with the block-tail route `cfg`
    resolves to on `device`: `fused_epilogue=None` is the kernel on CUDA for
    a resnet and off for the other families; True on those raises
    (models/registry.py `build_backbone`)."""
    if family(cfg.arch) == "resnet":
        fused = use_kernel(cfg.fused_epilogue, device)
    else:
        fused = cfg.fused_epilogue is True
    return MGProtoFeatures(cfg, fused_epilogue=fused)


def build_mgproto(
    cfg: ModelConfig, device: Union[str, torch.device, None] = None,
    seed: Optional[int] = None,
) -> Tuple[MGProtoFeatures, GMMState]:
    """The serving model in eval mode on `device` (CUDA unless the caller
    passes another), channels_last, with the kernels `cfg` resolves to.
    `seed` draws random weights (models/registry.init_random_weights) and a
    random GMM from one `torch.Generator`; without it the GMM is drawn from
    seed 0 and the weights are torch's defaults, to be replaced by
    `load_state_dict` (e.g. from models/convert.from_jax_variables)."""
    dev = resolve_device(device)
    apply_numerics_policy()
    model = make_features(cfg, dev)
    gen = torch.Generator().manual_seed(0 if seed is None else int(seed))
    if seed is not None:
        init_random_weights(model, gen)
    gmm = init_gmm(cfg, gen, dev)
    model = model.to(device=dev, memory_format=torch.channels_last).eval()
    return model, gmm


def patch_log_densities(
    proto_map: torch.Tensor, gmm: GMMState
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log_prob [B, C, K, H, W], normalized feature map [B, H, W, d])."""
    b, h, w, d = proto_map.shape
    feat = l2_normalize(proto_map, dim=-1)
    lp = diag_gaussian_log_prob(feat.reshape(-1, d), gmm.means, gmm.sigmas)
    lp = lp.reshape(b, h, w, gmm.num_classes, gmm.k_per_class)
    return lp.permute(0, 3, 4, 1, 2), feat


def gt_class_log_densities(
    model: "MGProtoFeatures", gmm: GMMState, images: torch.Tensor, labels: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward of `model` as it is (the caller sets eval mode) and each
    image's log-density maps under its own class's K prototypes: (lp [B, K,
    H, W], normalized feature map [B, H, W, d]). Only the class's slab is
    scored, a [B, K, HW] product of plain torch ops; the JAX package
    computes the [B, C, K, H, W] `patch_log_densities` and gathers the class.
    A label outside [0, C) (a pad row) is clamped for the gather. Shared by
    the push scan, the push render and the interpretability collector."""
    proto_map, _ = model(images)
    b, h, w, d = proto_map.shape
    feat = l2_normalize(proto_map, dim=-1)
    cls = labels.long().clamp(0, gmm.num_classes - 1)
    lp = row_class_log_densities(feat.reshape(b, h * w, d), gmm, cls)
    return lp.reshape(b, gmm.k_per_class, h, w), feat


def row_class_log_densities(f: torch.Tensor, gmm: GMMState, cls: torch.Tensor) -> torch.Tensor:
    """[B, K, HW] log-densities of each row's patches `f` [B, HW, d] under
    the K prototypes of its class `cls` [B] (an index into `gmm`)."""
    b, _, d = f.shape
    k = gmm.k_per_class
    m_scaled, inv_var, const = precompute_diag_gaussian(
        gmm.means[cls], gmm.sigmas[cls], DEFAULT_SIGMA_EPS)
    m_scaled, inv_var = m_scaled.reshape(b, k, d), inv_var.reshape(b, k, d)
    return (const.reshape(b, k, 1) + m_scaled @ f.transpose(1, 2)
            - 0.5 * (inv_var @ (f * f).transpose(1, 2)))


def _fused_pool(
    proto_map: torch.Tensor, gmm: GMMState, mine_T: int
) -> Tuple[PooledActivations, torch.Tensor]:
    """score_pool-backed equivalent of patch_log_densities + top_t_pool."""
    b, h, w, d = proto_map.shape
    feat = l2_normalize(proto_map, dim=-1).reshape(b, h * w, d).contiguous()
    vals, idx = score_pool(feat, gmm.means, gmm.sigmas, mine_T, DEFAULT_SIGMA_EPS)
    c, k = gmm.num_classes, gmm.k_per_class
    top1 = idx[..., 0]
    top1_feat = torch.gather(feat, 1, top1[..., None].expand(-1, -1, d))
    pooled = PooledActivations(
        log_act=vals.reshape(b, c, k, mine_T),
        top1_idx=top1.reshape(b, c, k),
        top1_feat=top1_feat.reshape(b, c, k, d),
    )
    return pooled, feat.reshape(b, h, w, d)


def head_forward(
    proto_map: torch.Tensor,
    gmm: GMMState,
    labels: Optional[torch.Tensor],
    mine_T: int,
    prior_eps: float = 1e-10,
    fused: bool = False,
    mesh=None,
):
    """GMM head on an add-on feature map [B, H, W, d]: returns (logits
    [B, C, T], pooled activations, enqueue candidates (feats [B*K, d],
    classes [B*K], valid [B*K])). The candidates are detached: the bank
    holds no autograd history.

    `mesh` (parallel/mesh.py `Mesh`, given only when its model axis splits
    the classes) makes this the class-sharded head: `gmm` is this rank's
    class slab, and `_class_sharded_head` scores it for the rows of every
    rank of its model group; the logits and candidates returned are this
    rank's rows, over every class."""
    if mesh is not None:
        return _class_sharded_head(proto_map, gmm, labels, mine_T, prior_eps, fused, mesh)
    pooled = _pool(proto_map, gmm, mine_T, fused)
    logits = _mixture_logits(mine_mask_activations(pooled.log_act, labels), gmm, prior_eps)
    b, _, k = pooled.top1_idx.shape
    if labels is None:
        return logits, pooled, _no_candidates(proto_map, b, k)
    sel = labels.long()
    idx, feats = _gt_top1(pooled, sel)  # a label -1 reads class C-1 (indexing wraps)
    valid = dedup_first_occurrence(idx)
    d = feats.shape[-1]
    enq = (feats.detach().reshape(b * k, d), sel.repeat_interleave(k), valid.reshape(b * k))
    return logits, pooled, enq


def _pool(proto_map, gmm, mine_T, fused) -> PooledActivations:
    if fused:
        return _fused_pool(proto_map, gmm, mine_T)[0]
    log_prob, feat = patch_log_densities(proto_map, gmm)
    return top_t_pool(log_prob, feat, mine_T)


def _mixture_logits(act: torch.Tensor, gmm: GMMState, prior_eps: float) -> torch.Tensor:
    """[B, C, T]: logsumexp over K of act [B, C, K, T] + log priors."""
    # exactly-zero priors (pruned slots) contribute exp(-inf) = 0, not eps
    log_priors = torch.where(
        gmm.priors > 0, torch.log(gmm.priors + prior_eps),
        torch.full_like(gmm.priors, float("-inf")),
    )
    return torch.logsumexp(act + log_priors[None, :, :, None], dim=2)


def _gt_top1(pooled: PooledActivations, cls: torch.Tensor):
    """Each row's top-1 patch indices [B, K] and features [B, K, d] under
    the K prototypes of its class `cls` [B] (an index into the pool)."""
    rows = torch.arange(cls.shape[0], device=cls.device)
    return pooled.top1_idx[rows, cls], pooled.top1_feat[rows, cls]


def _no_candidates(proto_map: torch.Tensor, b: int, k: int):
    d, dev = proto_map.shape[-1], proto_map.device
    return (
        torch.zeros(b * k, d, dtype=proto_map.dtype, device=dev),
        torch.full((b * k,), -1, dtype=torch.long, device=dev),
        torch.zeros(b * k, dtype=torch.bool, device=dev),
    )


def _class_sharded_head(proto_map, gmm, labels, mine_T, prior_eps, fused, mesh):
    """The head with the class axis split over the mesh's model group (the
    JAX `_fused_pool` under shard_map, in_specs (data, model, model)):

      * the feature maps of the group's ranks are gathered in rank order
        (the rows of this data index), and the slab of C/nm classes scores
        them (the score_pool kernel on CUDA when `fused`); the gather's
        backward sums the slabs' feature gradients over the group and hands
        each rank its rows (the psum of shard_map's transpose);
      * the mining mask reads the labels shifted by the slab's first class
        c0: a label of another slab is out of range there, so its row keeps
        the top-1 at every level, as a non-ground-truth class does;
      * the slab's [rows, C/nm, T] logits are gathered along the class axis
        and each rank keeps its own rows;
      * an enqueue candidate exists only on the rank holding its label's
        class: it is selected there (a label -1 reads class C-1, as
        indexing wraps in the one-process head) and summed over the group,
        where every other rank adds zeros."""
    group, nm, mi = mesh.model_group, mesh.model, mesh.model_index
    b, c_loc, k = proto_map.shape[0], gmm.num_classes, gmm.k_per_class
    c0 = mi * c_loc
    rows = all_gather(proto_map, 0, group)
    lab = None if labels is None else all_gather(labels.long(), 0, group)
    pooled = _pool(rows, gmm, mine_T, fused)
    act = mine_mask_activations(pooled.log_act, None if lab is None else lab - c0)
    logits = all_gather(_mixture_logits(act, gmm, prior_eps), 1, group)[mi * b:(mi + 1) * b]
    if lab is None:
        return logits, pooled, _no_candidates(proto_map, b, k)
    sel = torch.where(lab < 0, lab + c_loc * nm, lab)
    own = ((sel >= c0) & (sel < c0 + c_loc))[:, None]
    idx, feats = _gt_top1(pooled, (sel - c0).clamp(0, c_loc - 1))
    valid = dedup_first_occurrence(idx) & own
    d = feats.shape[-1]
    packed = torch.cat([torch.where(own[..., None], feats.detach(), 0.0),
                        valid[..., None].to(feats.dtype)], -1)  # [rows, K, d + 1]
    packed = all_reduce_sum(packed, group)[mi * b:(mi + 1) * b]
    enq = (packed[..., :d].reshape(b * k, d), labels.long().repeat_interleave(k),
           (packed[..., d] > 0.5).reshape(b * k))
    return logits, pooled, enq


def log_px(logits_level0: torch.Tensor) -> torch.Tensor:
    """OoD score log p(x) = logsumexp over classes of log p(x|c)."""
    return torch.logsumexp(logits_level0, dim=-1)


def prune_top_m(gmm: GMMState, top_m: int, renormalize: bool = False) -> GMMState:
    """Keep each class's top-M prototypes by prior; zero the others' priors.

    The keep set is `prior >= the M-th largest prior` of the class, so ties
    at the threshold keep more than M slots (the reference's `>=`). Pruned
    slots keep their means and sigmas; their zero prior removes them from
    the mixture (`head_forward`). Priors are not renormalized unless
    `renormalize` (opt-in): then the kept priors of a class sum to 1.
    Returns a new GMMState; the means tensor is shared, not copied."""
    if not 1 <= top_m <= gmm.k_per_class:
        raise ValueError(f"top_m {top_m} not in [1, {gmm.k_per_class}]")
    thresh = torch.topk(gmm.priors, top_m, dim=-1).values[:, -1]  # [C]
    keep = gmm.priors >= thresh[:, None]
    priors = torch.where(keep, gmm.priors, torch.zeros_like(gmm.priors))
    if renormalize:
        # summed left to right over K, the order XLA's reduction takes, so
        # the renormalized priors are bit-equal to the JAX package's
        total = priors[:, 0]
        for j in range(1, priors.shape[1]):
            total = total + priors[:, j]
        priors = priors / torch.clamp_min(total, 1e-12)[:, None]
    return gmm._replace(priors=priors, keep=keep)
