"""The memory planner: pick (batch, remat, prefetch, augment, async_bank,
compute_dtype) from measured peaks instead of by trial and error
(counterpart of mgproto_tpu/perf/planner.py).

For each candidate plan the planner measures the peak device memory of the
exact training step and selects the largest plan that fits the device
budget less a margin. The JAX package compiles each candidate's program
and reads XLA's compiled-module memory analysis; PyTorch has no such
analysis, so the port's default measure RUNS the candidate on the card:

    peak = program peak: `torch.cuda.max_memory_allocated()` over one
           training step at the per-rank batch (an async candidate runs the
           fill step and one steady step, so the trunk and the bank stream
           are resident together), less what was allocated before the
           candidate's state was cloned: the state, its gradients, its Adam
           moments and the step's activations and workspaces
         + prefetch headroom: prefetch_depth x batch_bytes (each batch in
           flight is device memory the step never sees), arithmetic.

The state is one seeded throwaway state with a full bank (every queue
full and marked updated, so EM runs over every class: the widest step),
built on the card without the host's random initialization, once per base
config (`make_cached_measure`); each candidate steps a clone of it built
for its own config (remat and the compute dtype live in the modules).
Between candidates the allocator's cache is emptied and its peak reset;
`candidate_plans` orders them by ascending batch. An out-of-memory error
is a rejection carrying its message, as a failed compile is in JAX, and
the cache is emptied after it. Without a CUDA device the default measure
raises: tests inject `measure=`.

Budget resolution: an explicit argument > MGPROTO_HBM_BUDGET_BYTES > the
CUDA device's total (`torch.cuda.mem_get_info`); with none of them the
planner raises. Under several ranks each rank measures on its own card
and the ranks agree before choosing (`HBMPlanner.plan`): the smallest
budget, each candidate's largest peak, a failure anywhere a rejection, so
every rank runs the same plan; the measure varies from run to run, and
ranks that share a card see each other's memory. The margin defaults to 8% (MGPROTO_HBM_MARGIN). The
dtype axis is opt-in (MGPROTO_AUTOTUNE_DTYPES, e.g. "bfloat16").

`state_bytes_per_chip` is shape math on meta tensors: the bytes one rank
holds of the bank, the optimizer moments and the master parameters under
parallel/sharding.py's layout, quantized parameters included
(`quant_mode`). `plan_serve_buckets` sizes `cli.serve --auto_tune`'s
buckets: one dispatch at each bucket on the engine's own model, its peak
less the loaded model, plus the artifact's resident weight bytes.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mgproto_tpu_torch.core.em import make_mean_optimizer
from mgproto_tpu_torch.core.losses import PROXY_BASED, init_proxies
from mgproto_tpu_torch.core.memory import Memory
from mgproto_tpu_torch.core.mgproto import GMMState, init_gmm, make_features
from mgproto_tpu_torch.core.state import TrainState, make_joint_optimizer, make_warm_optimizer
from mgproto_tpu_torch.engine.train import DeviceBatch, Trainer
from mgproto_tpu_torch.ops.augment import augment_draws, resolve_device_augment
from mgproto_tpu_torch.parallel.mesh import world
from mgproto_tpu_torch.parallel.multihost import max_across_hosts
from mgproto_tpu_torch.parallel.sharding import (
    full_shape,
    spec_shard_factor,
    state_partition_specs,
    tree_bytes_per_chip,
)
from mgproto_tpu_torch.perf.quant import quantized_param_bytes

BUDGET_ENV = "MGPROTO_HBM_BUDGET_BYTES"
MARGIN_ENV = "MGPROTO_HBM_MARGIN"
DTYPES_ENV = "MGPROTO_AUTOTUNE_DTYPES"
DEFAULT_MARGIN = 0.08

# backbone families whose stages accept selective remat
_REMAT_ARCH_PREFIXES = ("resnet", "densenet")

# the int32 step counters the JAX package's optax state keeps, replicated:
# adam's count and the staircase schedule's in each of the joint
# optimizer's three groups (features, add_on, aux; the aux group exists
# without proxies too), adam's in the warm optimizer's two and in the
# means'. `state_bytes_per_chip` counts them so its figures equal JAX's;
# torch's Adam keeps a step per parameter instead.
_JAX_COUNTER_BYTES = 4 * (3 * 2 + 2 * 1 + 1)


@dataclasses.dataclass(frozen=True)
class PlanCandidate:
    """One (batch, remat, prefetch, augment, async_bank, dtype) tuple.
    `batch` is the global train batch; `compute_dtype` "" keeps the base
    config's."""

    batch: int
    remat_stages: Tuple[str, ...] = ()
    prefetch_depth: int = 2
    device_augment: bool = False
    async_bank: bool = False
    compute_dtype: str = ""

    @property
    def name(self) -> str:
        parts = [f"b{self.batch}"]
        if self.remat_stages:
            parts.append("remat_" + "+".join(self.remat_stages))
        parts.append(f"pf{self.prefetch_depth}")
        if self.device_augment:
            parts.append("u8")
        if self.async_bank:
            parts.append("async")
        if self.compute_dtype:
            parts.append("bf16" if self.compute_dtype == "bfloat16" else self.compute_dtype)
        return "_".join(parts)


@dataclasses.dataclass(frozen=True)
class PlanReport:
    """One measured candidate: its peak against the effective budget, with
    the measure's breakdown."""

    candidate: PlanCandidate
    peak_bytes: int
    fits: bool
    detail: Dict[str, int]
    error: str = ""

    def to_meta(self) -> Dict:
        return {
            "name": self.candidate.name,
            "batch": self.candidate.batch,
            "remat_stages": list(self.candidate.remat_stages),
            "prefetch_depth": self.candidate.prefetch_depth,
            "device_augment": self.candidate.device_augment,
            "async_bank": self.candidate.async_bank,
            "compute_dtype": self.candidate.compute_dtype,
            "peak_bytes": int(self.peak_bytes),
            "fits": bool(self.fits),
            **{k: int(self.detail[k])
               for k in ("bank_bytes_per_chip", "opt_bytes_per_chip", "param_bytes_per_chip")
               if k in self.detail},
            **({"error": self.error} if self.error else {}),
        }


@dataclasses.dataclass(frozen=True)
class PlanOutcome:
    chosen: Optional[PlanReport]
    reports: Tuple[PlanReport, ...]
    budget_bytes: int
    margin: float

    @property
    def rejected(self) -> int:
        return sum(1 for r in self.reports if not r.fits)

    def to_meta(self) -> Dict:
        """meta.json's "autotune" record: the chosen plan and every
        candidate's peak."""
        return {
            "plan": self.chosen.to_meta() if self.chosen else None,
            "budget_bytes": int(self.budget_bytes),
            "margin": self.margin,
            "rejected": self.rejected,
            "candidates": [r.to_meta() for r in self.reports],
        }


def default_budget_bytes(device=None) -> Tuple[int, str]:
    """(budget bytes, source): MGPROTO_HBM_BUDGET_BYTES, else the CUDA
    device's total memory. Raises when there is neither."""
    raw = os.environ.get(BUDGET_ENV)
    if raw:
        return int(raw), "env"
    dev = torch.device(device) if device is not None else None
    if (dev is None or dev.type == "cuda") and torch.cuda.is_available():
        return int(torch.cuda.mem_get_info(dev)[1]), "device"
    raise RuntimeError(f"no CUDA device to take the memory budget from: pass budget_bytes or "
                       f"set {BUDGET_ENV}")


def resolve_margin(margin: Optional[float] = None) -> float:
    if margin is not None:
        return float(margin)
    raw = os.environ.get(MARGIN_ENV)
    if raw:
        return float(raw)
    return DEFAULT_MARGIN


def batch_bytes(batch: int, img_size: int, device_augment: bool) -> int:
    """Host-to-device bytes of one train batch: images (the uint8 wire
    under device augmentation, f32 otherwise), int32 labels and uint32
    augmentation seeds, as the JAX package counts them."""
    px = batch * img_size * img_size * 3
    images = px if device_augment else px * 4
    return images + batch * 4 + batch * 4


def plan_config(base_cfg, cand: PlanCandidate):
    """`base_cfg` with the candidate's knobs applied (the one projection the
    measure and `apply_plan` share)."""
    data = dataclasses.replace(base_cfg.data, train_batch_size=cand.batch,
                               prefetch_depth=cand.prefetch_depth,
                               device_augment=cand.device_augment)
    model = dataclasses.replace(base_cfg.model, remat_stages=tuple(cand.remat_stages))
    if cand.compute_dtype:
        model = dataclasses.replace(model, compute_dtype=cand.compute_dtype)
    em = dataclasses.replace(base_cfg.em, async_bank=cand.async_bank)
    return base_cfg.replace(data=data, model=model, em=em)


apply_plan = plan_config  # the public name run_training uses


def _world_size() -> int:
    return world()[1]


def data_axis_size(cfg) -> int:
    """Ranks on the mesh's data axis for this config."""
    n_model = max(int(cfg.mesh.model), 1)
    if cfg.mesh.data == -1:
        return max(_world_size() // n_model, 1)
    return max(int(cfg.mesh.data), 1)


def batch_shard_size(cfg) -> int:
    """Ranks one global batch splits over: batch rows shard over both mesh
    axes (parallel/sharding.py), so the whole mesh."""
    return data_axis_size(cfg) * max(int(cfg.mesh.model), 1)


# ------------------------------------------------------------ state builds
def _model_on(mcfg, device, init: bool):
    """The model of `mcfg` on `device`: initialized there by the modules'
    own default init (`init`), or with storage only (no kernel runs)."""
    route = torch.device(device) if torch.device(device).type != "meta" else torch.device("cpu")
    if init:
        with torch.device(device):
            model = make_features(mcfg, route)
    else:
        with torch.device("meta"):
            model = make_features(mcfg, route)
        if torch.device(device).type != "meta":
            model = model.to_empty(device=device)
    return model


def _state_from(cfg, model, gmm, memory, proxies):
    """A TrainState around the given tensors with fresh optimizers."""
    if next(model.parameters()).device.type != "meta":
        model = model.to(memory_format=torch.channels_last)
    model = model.train()
    return TrainState(step=0, model=model, proxies=proxies, gmm=gmm, memory=memory,
                      opt=make_joint_optimizer(cfg, model, proxies),
                      warm_opt=make_warm_optimizer(cfg, model, proxies),
                      mean_opt=make_mean_optimizer(gmm.means, cfg.em))


def meta_state(cfg):
    """A TrainState of `cfg` on the meta device: every shape, no storage."""
    m = cfg.model
    c, k, d = m.num_classes, m.prototypes_per_class, m.proto_dim
    meta = torch.device("meta")
    gmm = GMMState(means=torch.empty(c, k, d, device=meta),
                   sigmas=torch.empty(c, k, d, device=meta),
                   priors=torch.empty(c, k, device=meta),
                   keep=torch.empty(c, k, dtype=torch.bool, device=meta))
    memory = Memory(feats=torch.empty(c, m.mem_capacity, d, device=meta),
                    length=torch.empty(c, dtype=torch.int32, device=meta),
                    cursor=torch.empty(c, dtype=torch.int32, device=meta),
                    updated=torch.empty(c, dtype=torch.bool, device=meta))
    proxies = (torch.empty(c, m.sz_embedding, device=meta).requires_grad_(True)
               if cfg.loss.aux_loss in PROXY_BASED else None)
    return _state_from(cfg, _model_on(m, meta, init=False), gmm, memory, proxies)


class ThrowawayState:
    """One seeded state of a base config with a full bank, on the card:
    the trunk initialized there by the modules' default init (the host's
    random init of a full-width trunk takes seconds), the GMM and the
    proxies drawn from `seed`, every queue full of seeded unit vectors and
    marked updated. `clone(cfg)` is a fresh TrainState of a candidate's
    config holding copies of it."""

    def __init__(self, cfg, device, seed: int = 0):
        self.device = torch.device(device)
        m = cfg.model
        with torch.random.fork_rng(devices=[self.device] if self.device.type == "cuda" else []):
            torch.manual_seed(seed)
            self.weights = _model_on(m, self.device, init=True).state_dict()
        gen = torch.Generator().manual_seed(seed)
        self.gmm = init_gmm(m, gen, self.device)
        self.proxies = (init_proxies(gen, m.num_classes, m.sz_embedding).to(self.device)
                        if cfg.loss.aux_loss in PROXY_BASED else None)
        dgen = torch.Generator(device=self.device).manual_seed(seed + 1)
        c, cap, d = m.num_classes, m.mem_capacity, m.proto_dim
        feats = torch.randn(c, cap, d, generator=dgen, device=self.device)
        self.memory = Memory(feats=torch.nn.functional.normalize(feats, dim=-1),
                             length=torch.full((c,), cap, dtype=torch.int32, device=self.device),
                             cursor=torch.zeros(c, dtype=torch.int32, device=self.device),
                             updated=torch.ones(c, dtype=torch.bool, device=self.device))

    def clone(self, cfg):
        model = _model_on(cfg.model, self.device, init=False)
        model.load_state_dict(self.weights)
        g = self.gmm
        gmm = g._replace(means=g.means.detach().clone(), sigmas=g.sigmas.clone(),
                         priors=g.priors.clone(), keep=g.keep.clone())
        proxies = (None if self.proxies is None
                   else self.proxies.detach().clone().requires_grad_(True))
        return _state_from(cfg, model, gmm, Memory(*(t.clone() for t in self.memory)), proxies)


# ----------------------------------------------------------- state bytes
def state_bytes_per_chip(cfg, model_size: Optional[int] = None, state=None,
                         quant_mode: str = "") -> Dict[str, int]:
    """Per-rank bytes of the train state's groups under the layout of a
    model axis of `model_size` (parallel/sharding.py
    `state_partition_specs`; default `cfg.mesh.model`), shape math on meta
    tensors, no device work:

      bank_bytes_per_chip   the [C, cap, d] bank and its bookkeeping
      opt_bytes_per_chip    the joint, warm and EM-mean Adam moments, and
                            the JAX package's per-group step counters
      param_bytes_per_chip  the master parameters (the model's and the
                            proxies)

    The telemetry gauges of the same names and each candidate's detail.
    `state`: a TrainState holding every class (default: a meta state of
    `cfg`); only shapes are read, and the moments are counted for every
    parameter of each optimizer whether or not a step made them yet.

    `quant_mode` (a perf/quant.py mode, serving only): the parameters as
    the quantized weights hold them (perf/quant.py
    `quantized_param_bytes`); the float figure stays as
    `param_bytes_per_chip_f32` and the mode is echoed."""
    m = max(int(cfg.mesh.model), 1) if model_size is None else int(model_size)
    if state is None:
        state = meta_state(cfg)
    specs = state_partition_specs(state, cfg.model.num_classes, m)
    bank = tree_bytes_per_chip(state.memory._asdict(), specs["memory"], m)
    params = {n: p for n, p in state.model.named_parameters()}
    param_bytes = tree_bytes_per_chip(params, {n: specs["model"][n] for n in params}, m)
    if state.proxies is not None:
        param_bytes += tree_bytes_per_chip({"p": state.proxies}, {"p": specs["proxies"]}, m)
    names = {id(p): n for n, p in params.items()}
    if state.proxies is not None:
        names[id(state.proxies)] = "proxies"
    names[id(state.gmm.means)] = "means"
    opt_bytes = _JAX_COUNTER_BYTES
    for f in ("opt", "warm_opt", "mean_opt"):
        opt, opt_specs = getattr(state, f), specs[f]
        for group in opt.param_groups:
            for p in group["params"]:
                nbytes = int(math.prod(full_shape(p))) * p.element_size()
                spec = opt_specs[f"{names[id(p)]}/exp_avg"]
                opt_bytes += 2 * (nbytes // spec_shard_factor(spec, m))
    out = {"bank_bytes_per_chip": int(bank), "opt_bytes_per_chip": int(opt_bytes),
           "param_bytes_per_chip": int(param_bytes)}
    if quant_mode:
        # the parameters stay whole on every serving replica, so the
        # per-rank figure scales by the tree's quantized / float ratio
        quantized = quantized_param_bytes(out["param_bytes_per_chip"], state.model,
                                          state.proxies, quant_mode)
        if quantized is not None:
            out["param_bytes_per_chip_f32"] = out["param_bytes_per_chip"]
            out["param_bytes_per_chip"] = quantized
            out["quant_mode"] = quant_mode
    return out


# ---------------------------------------------------------------- measure
def _cuda_device(device):
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else None)
    if dev is None or dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            "the planner's default measure runs the candidate on a CUDA device, and there is "
            f"none here ({device or 'no device given'}): pass measure= to plan without one")
    return dev


def _release(device) -> None:
    gc.collect()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()


def _release_if_cuda(device) -> None:
    if torch.cuda.is_available() and (device is None or torch.device(device).type == "cuda"):
        _release(device)


def measure_candidate(base_cfg, cand: PlanCandidate, device=None,
                      shared: Optional[Dict] = None) -> Tuple[int, Dict]:
    """The default measure: one training step of the candidate on the card
    (module docstring). Returns (peak_bytes, detail); raises without a CUDA
    device and on an out-of-memory error (after emptying the cache).
    `shared`: a dict that keeps the ThrowawayState of `base_cfg` across
    calls (`make_cached_measure`'s); None builds one for this call.

    Per rank: the global batch is stepped at its per-rank share (global /
    the mesh's size) on a whole state (class-sharded state is charged
    unsharded, a conservative over-count beside `state_bytes_per_chip`)."""
    dev = _cuda_device(device)
    cfg = plan_config(base_cfg, cand)
    m = cfg.model
    per_chip = max(cand.batch // batch_shard_size(cfg), 1)
    steps = 2 if cfg.em.async_bank else 1  # async: the fill step, then a steady one
    shared = {} if shared is None else shared
    t0 = time.perf_counter()

    def run() -> Tuple[int, int]:
        """(program peak, baseline); every tensor it makes dies with it."""
        if "base" not in shared:
            shared["base"] = ThrowawayState(base_cfg, dev)
        trainer = Trainer(cfg, steps_per_epoch=100, device=dev)
        _release(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        baseline = torch.cuda.memory_allocated(dev)
        state = shared["base"].clone(cfg)
        gen = torch.Generator(device=dev).manual_seed(cand.batch)
        shape = (per_chip, m.img_size, m.img_size, 3)
        labels = torch.arange(per_chip, device=dev) % m.num_classes
        if trainer.device_augment:
            images = torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)
            draws = torch.from_numpy(augment_draws(np.arange(per_chip, dtype=np.uint32))).to(dev)
        else:
            images, draws = torch.randn(shape, generator=gen, device=dev), None
        batch = DeviceBatch(images, labels, draws, None, None, 0, 0)
        for _ in range(steps):
            state, met = trainer.train_step(state, batch, None, use_mine=True, update_gmm=True)
            if met.nonfinite:
                raise RuntimeError(f"{cand.name}: the measured step was not finite")
        if trainer.async_bank:
            state, _ = trainer.flush_bank(state)
        torch.cuda.synchronize(dev)
        return int(torch.cuda.max_memory_allocated(dev)) - int(baseline), int(baseline)

    oom = None
    try:
        program_peak, baseline = run()
    except torch.cuda.OutOfMemoryError as e:
        oom = str(e)  # the traceback, and the tensors its frames hold, go here
    finally:
        _release(dev)
    if oom is not None:
        raise torch.cuda.OutOfMemoryError(oom)
    prefetch = cand.prefetch_depth * batch_bytes(per_chip, m.img_size, cand.device_augment)
    c, cap, d = m.num_classes, m.mem_capacity, m.proto_dim
    detail: Dict = {
        "per_chip_batch": per_chip,
        "baseline_bytes": int(baseline),
        "program_peak_bytes": int(program_peak),
        "prefetch_headroom_bytes": int(prefetch),
        "bank_bytes_analytic": c * cap * d * 4 + c * (4 + 4 + 1),
        "steps": steps,
        "measure_s": time.perf_counter() - t0,
    }
    detail.update(state_bytes_per_chip(cfg, max(int(cfg.mesh.model), 1)))
    return int(program_peak + prefetch), detail


def make_cached_measure(base_cfg, device=None) -> Callable:
    """The default `autotune` measure: `measure_candidate` on one
    ThrowawayState (built at the first call), memoized on the program
    identity (batch, remat, augment, async, dtype). Candidates that differ
    only in prefetch_depth run the same step: their peaks differ by
    arithmetic, so the prefetch ladder costs no extra step."""
    cache: Dict[Tuple, Tuple[int, Dict]] = {}
    shared: Dict = {}

    def measure(cand: PlanCandidate) -> Tuple[int, Dict]:
        key = (cand.batch, tuple(cand.remat_stages), cand.device_augment, cand.async_bank,
               cand.compute_dtype)
        if key not in cache:
            cache[key] = measure_candidate(base_cfg, dataclasses.replace(cand, prefetch_depth=0),
                                           device=device, shared=shared)
        peak0, det0 = cache[key]
        if cand.prefetch_depth <= 0:
            return peak0, det0
        prefetch = cand.prefetch_depth * batch_bytes(det0["per_chip_batch"],
                                                     base_cfg.model.img_size, cand.device_augment)
        detail = dict(det0, prefetch_headroom_bytes=int(prefetch))
        return int(det0["program_peak_bytes"] + prefetch), detail

    return measure


class HBMPlanner:
    """Selects the largest candidate whose peak fits budget * (1 - margin).

    Preference: the larger batch, then the base config's own dtype, then
    fewer remat stages, then deeper prefetch. A candidate whose measure
    raises (an out-of-memory error included) is rejected with the error
    string."""

    def __init__(self, budget_bytes: Optional[int] = None, margin: Optional[float] = None,
                 measure: Optional[Callable] = None,
                 log: Optional[Callable[[str], None]] = None, device=None):
        if budget_bytes is None:
            budget_bytes, self.budget_source = default_budget_bytes(device)
        else:
            self.budget_source = "explicit"
        self.budget_bytes = int(budget_bytes)
        self.margin = resolve_margin(margin)
        self.device = device
        self._measure = measure
        self._log = log or (lambda s: None)

    @property
    def effective_budget(self) -> int:
        return int(self.budget_bytes * (1.0 - self.margin))

    def plan(self, base_cfg, candidates: Sequence[PlanCandidate]) -> PlanOutcome:
        """The outcome over `candidates`. Under several ranks this is a
        collective (every rank calls it with the same candidates): each
        rank measures on its own card, and one plan is chosen for the
        world from the smallest rank's budget and each candidate's largest
        peak, a failure on any rank rejecting it on all."""
        measure = self._measure or make_cached_measure(base_cfg, self.device)
        world_size = _world_size()
        if world_size > 1:
            self.budget_bytes = int(-max_across_hosts([-self.budget_bytes])[0])
        reports: List[PlanReport] = []
        for cand in candidates:
            try:
                measured = measure(cand)
                peak, detail = measured if isinstance(measured, tuple) else (int(measured), {})
                err = ""
            except Exception as e:  # a failed measure (an OOM) == does not fit
                peak, detail, err = 0, {}, f"{type(e).__name__}: {e}"
            if world_size > 1:
                worst, failed = max_across_hosts([peak, 1.0 if err else 0.0])
                if failed and not err:
                    err = "the measure failed on another rank"
                peak = 0 if err else int(worst)
            fits = not err and peak <= self.effective_budget
            reports.append(PlanReport(candidate=cand, peak_bytes=int(peak), fits=fits,
                                      detail=detail, error=err))
            self._log(f"autotune: {cand.name} peak={peak / 1e9:.2f} GB "
                      f"{'fits' if fits else 'REJECTED'}" + (f" ({err})" if err else ""))
        if self._measure is None:  # the default measure's throwaway state goes now
            del measure
            _release_if_cuda(self.device)
        chosen = max(
            (r for r in reports if r.fits),
            key=lambda r: (
                r.candidate.batch,
                # at equal batch keep the run's own numerics: a dtype
                # override wins only where it buys a larger batch
                not r.candidate.compute_dtype,
                -len(r.candidate.remat_stages),
                r.candidate.prefetch_depth,
            ),
            default=None,
        )
        return PlanOutcome(chosen=chosen, reports=tuple(reports), budget_bytes=self.budget_bytes,
                           margin=self.margin)


def candidate_plans(cfg, batches: Optional[Sequence[int]] = None,
                    device_augment: Optional[bool] = None, async_bank: Optional[bool] = None,
                    dtypes: Optional[Sequence[str]] = None, device=None) -> List[PlanCandidate]:
    """The default ladder of a base config: the global batch and its 2x
    and 4x, each with the configured remat plus, for resnet and densenet
    trunks, the first stage alone rematted, each at the configured
    prefetch depth and at 0 (free to measure, see `make_cached_measure`),
    and each again under every extra dtype of `dtypes` (default
    MGPROTO_AUTOTUNE_DTYPES). Augment and async default to what the run
    will resolve on `device` (None: CUDA)."""
    b0 = cfg.data.train_batch_size * _world_size()
    batches = list(batches) if batches else [b0, 2 * b0, 4 * b0]
    if device_augment is None:
        dev = torch.device(device) if device is not None else torch.device("cuda")
        device_augment = resolve_device_augment(cfg.data.device_augment, dev)
    if async_bank is None:
        async_bank = bool(cfg.em.async_bank)  # auto is off (engine/train.py)
    remat_options: List[Tuple[str, ...]] = [tuple(cfg.model.remat_stages)]
    if cfg.model.arch.startswith(_REMAT_ARCH_PREFIXES) and not cfg.model.remat:
        l1 = ("denseblock1",) if "densenet" in cfg.model.arch else ("layer1",)
        if l1 not in remat_options:
            remat_options.append(l1)
    prefetch_options = sorted({int(cfg.data.prefetch_depth), 0}, reverse=True)
    if dtypes is None:
        raw = os.environ.get(DTYPES_ENV, "")
        dtypes = tuple(s.strip() for s in raw.split(",") if s.strip())
    dtype_options = [""] + [d for d in dtypes if d and d != cfg.model.compute_dtype]
    out: List[PlanCandidate] = []
    for b in sorted(set(batches)):
        for dt in dtype_options:
            for stages in remat_options:
                for pf in prefetch_options:
                    out.append(PlanCandidate(batch=int(b), remat_stages=stages,
                                             prefetch_depth=pf,
                                             device_augment=bool(device_augment),
                                             async_bank=bool(async_bank), compute_dtype=dt))
    return out


def serve_bucket_measure(engine) -> Callable:
    """The default serve-bucket measure: one dispatch of zeros at the
    bucket through the engine's own model (`infer_fn`) on its CUDA device;
    the peak less what was allocated before (the loaded model) is the
    program peak. The dispatch also warms the bucket. Without a CUDA
    device each call raises (the planner's rejection)."""
    def measure(cand: PlanCandidate):
        dev = _cuda_device(engine.device)
        _release(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        baseline = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        engine.infer_fn(np.zeros((cand.batch, engine.img_size, engine.img_size, 3), np.float32))
        torch.cuda.synchronize(dev)
        peak = int(torch.cuda.max_memory_allocated(dev)) - int(baseline)
        _release(dev)
        return peak, {"baseline_bytes": int(baseline), "measure_s": time.perf_counter() - t0}

    return measure


def plan_serve_buckets(engine, budget_bytes: Optional[int] = None,
                       margin: Optional[float] = None, measure: Optional[Callable] = None,
                       log: Optional[Callable[[str], None]] = None,
                       weight_bytes: int = 0) -> Tuple[List[int], PlanOutcome]:
    """`cli.serve --auto_tune`: the engine's buckets that fit the budget,
    and the outcome. Each bucket's program peak (`serve_bucket_measure`)
    plus `weight_bytes`, the artifact's resident weight bytes (its
    quant_config's `total_weight_bytes` for a quantized artifact,
    `total_f32_bytes` otherwise), as the JAX package models the weights
    its compiled programs do not count. Each report's detail keeps both
    terms (program_peak_bytes, weight_resident_bytes). No prefetch
    headroom: serving holds one batch."""
    inner = measure or serve_bucket_measure(engine)

    def with_weights(cand: PlanCandidate):
        measured = inner(cand)
        peak, detail = measured if isinstance(measured, tuple) else (int(measured), {})
        detail = dict(detail, program_peak_bytes=int(peak),
                      weight_resident_bytes=int(weight_bytes))
        return int(peak) + int(weight_bytes), detail

    planner = HBMPlanner(budget_bytes=budget_bytes, margin=margin, measure=with_weights, log=log,
                         device=getattr(engine, "device", None))
    cands = [PlanCandidate(batch=int(b), prefetch_depth=0) for b in sorted(engine.buckets)]
    outcome = planner.plan(None, cands)
    return [r.candidate.batch for r in outcome.reports if r.fits], outcome


def autotune(cfg, budget_bytes: Optional[int] = None, margin: Optional[float] = None,
             candidates: Optional[Sequence[PlanCandidate]] = None,
             measure: Optional[Callable] = None, log: Optional[Callable[[str], None]] = None,
             device=None):
    """`--auto_tune` in one call: candidates, plan, apply. Returns (cfg,
    PlanOutcome); when nothing fits the base config comes back unchanged,
    with the rejections in the outcome."""
    planner = HBMPlanner(budget_bytes=budget_bytes, margin=margin, measure=measure, log=log,
                         device=device)
    cands = list(candidates) if candidates is not None else candidate_plans(cfg, device=device)
    outcome = planner.plan(cfg, cands)
    if outcome.chosen is None:
        return cfg, outcome
    chosen = outcome.chosen.candidate
    # candidate batches are global; DataConfig's batch is per rank
    per_process = dataclasses.replace(chosen, batch=max(chosen.batch // _world_size(), 1))
    return apply_plan(cfg, per_process), outcome
