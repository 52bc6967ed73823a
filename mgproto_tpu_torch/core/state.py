"""The train state of the port (counterpart of mgproto_tpu/core/state.py).

The JAX package threads one immutable pytree through a jitted step; here a
`TrainState` holds the model (parameters and BatchNorm buffers), the
proxies (only for a proxy-based aux loss, `losses.PROXY_BASED`; None
otherwise, as the JAX state has no `proxies` leaf then), the GMM, the memory
bank, the three optimizers and the step counter, and `engine/train.py`
updates it in place.

Optimizers: torch's `Adam(weight_decay=wd)` adds the L2 term to the gradient
before the moments, which is exactly the JAX package's `torch_adam`. Param
groups follow its `_param_labels`: `features` (the trunk), `add_on`, `aux`
(the proxies, absent without them). The embedding Linear is in no group:
frozen, while gradients flow through it into the trunk. The joint
optimizer's learning rates follow the staircase schedule of its own update count; the warm optimizer has no
`features` group and constant rates; the mean optimizer is a separate Adam
on the GMM means.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from mgproto_tpu_torch.config import Config
from mgproto_tpu_torch.core.em import make_mean_optimizer
from mgproto_tpu_torch.core.losses import AUX_LOSSES, PROXY_BASED, init_proxies
from mgproto_tpu_torch.core.memory import Memory, init_memory
from mgproto_tpu_torch.core.mgproto import GMMState, MGProtoFeatures, init_gmm, make_features
from mgproto_tpu_torch.models.registry import init_random_weights
from mgproto_tpu_torch.numerics import resolve_device

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@dataclasses.dataclass
class TrainState:
    step: int  # train-step attempts (a skipped step counts)
    model: MGProtoFeatures
    proxies: Optional[torch.Tensor]  # [C, E] leaf of a proxy-based aux loss, else None
    gmm: GMMState  # gmm.means is the mean optimizer's leaf
    memory: Memory
    opt: torch.optim.Adam  # joint
    warm_opt: torch.optim.Adam
    mean_opt: torch.optim.Adam
    joint_updates: int = 0  # applied joint updates: the schedule's count


def staircase_lr(base_lr: float, count: int, steps_per_epoch: int,
                 decay_epochs: Tuple[int, ...], gamma: float, epoch_offset: int = 0) -> float:
    """StepLR at fixed ABSOLUTE epochs: the rate of the joint optimizer's
    update number `count` (0-based); `epoch_offset` (= num_warm_epochs) maps
    its counter back to absolute epochs."""
    epoch = count // steps_per_epoch + epoch_offset
    return base_lr * gamma ** sum(e <= epoch for e in decay_epochs)


def param_groups(model: MGProtoFeatures, proxies: Optional[torch.Tensor]):
    """{group: [params]} for 'features', 'add_on' and, with proxies, 'aux'."""
    groups = {"features": list(model.features.parameters()),
              "add_on": list(model.add_on.parameters())}
    if proxies is not None:
        groups["aux"] = [proxies]
    return groups


def make_joint_optimizer(cfg: Config, model, proxies) -> torch.optim.Adam:
    o = cfg.optim
    lrs = {"features": o.features_lr, "add_on": o.add_on_lr, "aux": o.aux_proxies_lr}
    return torch.optim.Adam(
        [{"params": ps, "lr": lrs[g], "base_lr": lrs[g]}
         for g, ps in param_groups(model, proxies).items()],
        betas=ADAM_BETAS, eps=ADAM_EPS, weight_decay=o.weight_decay,
    )


def make_warm_optimizer(cfg: Config, model, proxies) -> torch.optim.Adam:
    """The warm phase: the trunk frozen, constant rates."""
    o = cfg.optim
    groups = param_groups(model, proxies)
    lrs = {"add_on": o.add_on_lr, "aux": o.aux_proxies_lr}
    return torch.optim.Adam(
        [{"params": groups[g], "lr": lr} for g, lr in lrs.items() if g in groups],
        betas=ADAM_BETAS, eps=ADAM_EPS, weight_decay=o.weight_decay,
    )


def set_joint_lrs(cfg: Config, state: TrainState, steps_per_epoch: int) -> None:
    """Staircase rates for the joint optimizer's next update."""
    o = cfg.optim
    for group in state.opt.param_groups:
        group["lr"] = staircase_lr(
            group["base_lr"], state.joint_updates, steps_per_epoch,
            o.lr_decay_epochs, o.lr_decay_gamma, cfg.schedule.num_warm_epochs,
        )


def create_train_state(
    cfg: Config, generator: torch.Generator,
    device: Union[str, torch.device, None] = None,
) -> TrainState:
    """A fresh state on `device` (CUDA unless the caller passes another):
    seeded trunk weights, GMM and proxies (a proxy-based aux loss only),
    all drawn on the CPU from `generator` in that order; an empty bank;
    fresh optimizers. The modules keep f32 parameters whatever the compute
    dtype (perf/precision.py)."""
    dev = resolve_device(device)
    m = cfg.model
    if cfg.loss.aux_loss not in AUX_LOSSES:
        raise ValueError(f"unknown aux_loss {cfg.loss.aux_loss!r}; options: {sorted(AUX_LOSSES)}")
    model = make_features(m, dev)
    init_random_weights(model, generator)
    gmm = init_gmm(m, generator, dev)
    proxies = None
    if cfg.loss.aux_loss in PROXY_BASED:
        proxies = init_proxies(generator, m.num_classes, m.sz_embedding)
        proxies = proxies.to(dev).requires_grad_(True)
    model = model.to(device=dev, memory_format=torch.channels_last).train()
    return TrainState(
        step=0, model=model, proxies=proxies, gmm=gmm,
        memory=init_memory(m.num_classes, m.mem_capacity, m.proto_dim, dev),
        opt=make_joint_optimizer(cfg, model, proxies),
        warm_opt=make_warm_optimizer(cfg, model, proxies),
        mean_opt=make_mean_optimizer(gmm.means, cfg.em),
    )
