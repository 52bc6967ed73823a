"""Checkpoint and resume of the whole train state (counterpart of
mgproto_tpu/utils/checkpoint.py, in the port's own format).

A checkpoint is a directory named `{epoch}{stage}{accuracy:.4f}` (the
reference's scheme, e.g. `104nopush0.8224`) holding
  * state.pt: one `torch.save` of the model's state_dict (parameters and
    BatchNorm buffers), the proxies, the GMM, the memory bank, the joint,
    warm and mean Adam state_dicts, `step` and `joint_updates`;
  * mgproto_manifest.json: every tensor's name, shape and dtype, and
    `step` (the JAX package's manifest schema, so its listings read these
    directories too);
  * mgproto_meta.json: epoch, stage, accuracy and config metadata.

A save writes `<name>.tmp` and renames it into place, so an interrupted save
never leaves a directory any listing trusts; failed writes are retried.
`restore_checkpoint` checks the manifest against the restore target and
the loaded tensors against the manifest (`CheckpointIntegrityError`), then
copies the tensors into the target's own parameter objects, the ones its
optimizers hold, and loads the optimizer states, which torch maps onto the
parameters' device: a checkpoint written on the card restores on the CPU
and the other way round.

The JAX package's orbax and sharded multi-host formats are not ported.
"""

from __future__ import annotations

import itertools
import json
import os
import pickle
import re
import shutil
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from mgproto_tpu_torch.core.memory import Memory
from mgproto_tpu_torch.core.state import TrainState
from mgproto_tpu_torch.utils.retry import backoff_delays

_NAME_RE = re.compile(r"^(\d+)([a-z_]+)(\d+\.\d+)$")

MANIFEST_FILE = "mgproto_manifest.json"
MANIFEST_FORMAT = 1
META_FILE = "mgproto_meta.json"
STATE_FILE = "state.pt"
TMP_SUFFIX = ".tmp"
SAVE_RETRIES = 2  # a failed write is retried this often, with backoff
_OPTIMIZERS = ("opt", "warm_opt", "mean_opt")


class CheckpointIntegrityError(RuntimeError):
    """Manifest missing or corrupt, a payload that does not match it, or a
    checkpoint that does not match the restore target."""


def checkpoint_name(epoch: int, stage: str, accuracy: float) -> str:
    """`{epoch}{stage}{acc:.4f}` (the reference's file name scheme)."""
    return f"{epoch}{stage}{accuracy:.4f}"


def parse_checkpoint_name(name: str) -> Optional[Tuple[int, str, float]]:
    m = _NAME_RE.match(name)
    if not m:
        return None
    return int(m.group(1)), m.group(2), float(m.group(3))


def state_payload(state: TrainState) -> Dict[str, Any]:
    """What state.pt holds: tensors (detached, on their device) and the two
    counters."""
    return {
        "model": state.model.state_dict(),
        "proxies": state.proxies.detach(),
        "gmm": {k: t.detach() for k, t in state.gmm._asdict().items()},
        "memory": dict(state.memory._asdict()),
        **{name: getattr(state, name).state_dict() for name in _OPTIMIZERS},
        "step": int(state.step),
        "joint_updates": int(state.joint_updates),
    }


def _tensors(tree: Any, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) for every tensor in nested dicts and lists."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{prefix}/{i}")


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _leaves(payload: Dict[str, Any]) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    return {p: (tuple(t.shape), _dtype_name(t)) for p, t in _tensors(payload)}


def _manifest(payload: Dict[str, Any]) -> dict:
    leaves = [{"path": p, "shape": list(s), "dtype": d} for p, (s, d) in _leaves(payload).items()]
    return {"format": MANIFEST_FORMAT, "num_leaves": len(leaves), "step": payload["step"],
            "leaves": leaves}


def load_manifest(path: str) -> Optional[dict]:
    """The checkpoint's manifest, or None when absent. Raises
    CheckpointIntegrityError on an unreadable or unknown manifest."""
    mpath = os.path.join(path, MANIFEST_FILE)
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointIntegrityError(f"unreadable manifest in {path}: {e}")
    if manifest.get("format") != MANIFEST_FORMAT or "leaves" not in manifest:
        raise CheckpointIntegrityError(
            f"manifest in {path} has unknown format {manifest.get('format')!r}")
    return manifest


def _target_leaves(state: TrainState):
    """(exact, optional): the leaves a checkpoint of `state`'s shapes must
    hold, and the Adam state leaves it may hold (torch creates a
    parameter's moments at its first update)."""
    payload = state_payload(state)
    opt_free = {k: v for k, v in payload.items() if k not in _OPTIMIZERS}
    exact = _leaves(opt_free)
    optional = {}
    for name in _OPTIMIZERS:
        opt = getattr(state, name)
        params = [p for g in opt.param_groups for p in g["params"]]
        for i, p in enumerate(params):
            optional[f"{name}/state/{i}/step"] = ((), "float32")
            for moment in ("exp_avg", "exp_avg_sq"):
                optional[f"{name}/state/{i}/{moment}"] = (tuple(p.shape), _dtype_name(p))
    return exact, optional


def _verify_manifest(manifest: dict, target: TrainState, path: str) -> None:
    exact, optional = _target_leaves(target)
    got = {e["path"]: (tuple(e["shape"]), e["dtype"]) for e in manifest["leaves"]}
    missing = sorted(set(exact) - set(got))[:3]
    extra = sorted(set(got) - set(exact) - set(optional))[:3]
    diff = sorted(k for k in got if got[k] != exact.get(k, optional.get(k, got[k])))[:3]
    if not (missing or extra or diff):
        return
    detail = []
    if missing:
        detail.append(f"missing from checkpoint: {missing}")
    if extra:
        detail.append(f"unexpected in checkpoint: {extra}")
    for k in diff:
        detail.append(f"{k}: checkpoint {got[k]} vs target {exact.get(k, optional.get(k))}")
    raise CheckpointIntegrityError(
        f"checkpoint {path} does not match the restore target; " + "; ".join(detail))


def save_checkpoint(ckpt_dir: str, state: TrainState, name: str,
                    metadata: Optional[dict] = None) -> str:
    """Write `state` to `ckpt_dir/name` through `name.tmp` and a rename; an
    OSError retries the whole write up to SAVE_RETRIES times with backoff.
    Returns the checkpoint's path."""
    path = os.path.abspath(os.path.join(ckpt_dir, name))
    tmp = path + TMP_SUFFIX
    payload = state_payload(state)

    def write() -> None:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, MANIFEST_FILE), "w") as f:
            json.dump(_manifest(payload), f)
        if metadata is not None:
            with open(os.path.join(tmp, META_FILE), "w") as f:
                json.dump(metadata, f)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.rename(tmp, path)

    for delay in itertools.chain(backoff_delays(SAVE_RETRIES, 0.1, 2.0), [None]):
        try:
            write()
            return path
        except OSError:
            if delay is None:
                raise
            time.sleep(delay)
    raise AssertionError("unreachable")


def restore_checkpoint(path: str, target: TrainState) -> TrainState:
    """Load a checkpoint into `target` (a state built for the same config,
    e.g. `Trainer.init_state`) in place and return it."""
    path = os.path.abspath(path)
    manifest = load_manifest(path)
    if manifest is None:
        raise CheckpointIntegrityError(f"{path} has no manifest")
    _verify_manifest(manifest, target, path)
    try:
        payload = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                             weights_only=True)
    except (OSError, RuntimeError, EOFError, ValueError, pickle.UnpicklingError) as e:
        raise CheckpointIntegrityError(f"unreadable {STATE_FILE} in {path}: {e}")
    want = {e["path"]: (tuple(e["shape"]), e["dtype"]) for e in manifest["leaves"]}
    if _leaves(payload) != want or payload.get("step") != manifest["step"]:
        raise CheckpointIntegrityError(f"{path}: {STATE_FILE} does not match its manifest")

    dev = target.gmm.means.device
    target.model.load_state_dict(payload["model"], strict=True)
    g = payload["gmm"]
    with torch.no_grad():
        target.proxies.copy_(payload["proxies"])
        target.gmm.means.copy_(g["means"])
    target.gmm = target.gmm._replace(
        sigmas=g["sigmas"].to(dev), priors=g["priors"].to(dev), keep=g["keep"].to(dev))
    target.memory = Memory(**{k: t.to(dev) for k, t in payload["memory"].items()})
    for name in _OPTIMIZERS:
        getattr(target, name).load_state_dict(payload[name])
    target.step = payload["step"]
    target.joint_updates = payload["joint_updates"]
    return target


def load_metadata(path: str) -> Optional[dict]:
    meta = os.path.join(path, META_FILE)
    if not os.path.exists(meta):
        return None
    with open(meta) as f:
        return json.load(f)


def save_state_w_condition(ckpt_dir: str, state: TrainState, epoch: int, stage: str,
                           accuracy: float, target_accuracy: float,
                           metadata: Optional[dict] = None) -> Optional[str]:
    """Save only when `accuracy >= target_accuracy` (equality saves: the
    default target 0.0 keeps every stage checkpoint); the name encodes
    epoch, stage and accuracy."""
    if accuracy < target_accuracy:
        return None
    meta = dict(metadata or {})
    meta.update(epoch=epoch, stage=stage, accuracy=accuracy)
    return save_checkpoint(ckpt_dir, state, checkpoint_name(epoch, stage, accuracy),
                           metadata=meta)


# Within one epoch the reference saves nopush, then push, then prune: resume
# picks the latest STAGE, not the highest accuracy. "preempt" checkpoints
# (the JAX package's mid-epoch saves) order first.
_STAGE_ORDER = {"preempt": -1, "nopush": 0, "push": 1, "prune": 2}


def _manifest_state(path: str) -> str:
    """'ok' (a valid manifest), 'missing' (none) or 'bad' (corrupt)."""
    try:
        manifest = load_manifest(path)
    except CheckpointIntegrityError:
        return "bad"
    return "ok" if manifest is not None else "missing"


def list_checkpoints(ckpt_dir: str, require_manifest: bool = False):
    """Every parseable checkpoint in `ckpt_dir` as (epoch, stage, acc, path),
    in (epoch, stage) order. `.tmp` saves and corrupt manifests are always
    skipped; `require_manifest` also skips directories without one."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.endswith(TMP_SUFFIX):
            continue
        parsed = parse_checkpoint_name(name)
        if not parsed or not os.path.isdir(os.path.join(ckpt_dir, name)):
            continue
        mstate = _manifest_state(os.path.join(ckpt_dir, name))
        if mstate == "bad" or (require_manifest and mstate != "ok"):
            continue
        out.append((*parsed, os.path.join(ckpt_dir, name)))
    out.sort(key=lambda t: (t[0], _STAGE_ORDER.get(t[1], -2), t[2]))
    return out


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The last checkpoint by (epoch, stage)."""
    ckpts = list_checkpoints(ckpt_dir)
    return ckpts[-1][3] if ckpts else None


def find_latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest checkpoint safe to resume from: the last by (epoch, stage)
    among those with a valid manifest (`resume="auto"`)."""
    ckpts = list_checkpoints(ckpt_dir, require_manifest=True)
    return ckpts[-1][3] if ckpts else None


def apply_retention(ckpt_dir: str, keep_last: int, keep_best: int = 1) -> List[str]:
    """Delete all but the newest `keep_last` checkpoints by (epoch, stage)
    and the `keep_best` most accurate ones, and the `.tmp` directories of
    dead saves. `keep_last <= 0` keeps everything. Returns what it
    deleted."""
    if keep_last <= 0:
        return []
    ckpts = list_checkpoints(ckpt_dir)
    keep = {c[3] for c in ckpts[-keep_last:]}
    if keep_best > 0:
        keep.update(c[3] for c in sorted(ckpts, key=lambda c: c[2], reverse=True)[:keep_best])
    removed = []
    for c in ckpts:
        if c[3] not in keep:
            shutil.rmtree(c[3], ignore_errors=True)
            removed.append(c[3])
    # a live save clears its own staging first, so a .tmp here is a dead one
    for name in os.listdir(ckpt_dir):
        path = os.path.join(ckpt_dir, name)
        if (os.path.isdir(path) and name.endswith(TMP_SUFFIX)
                and parse_checkpoint_name(name[: -len(TMP_SUFFIX)])):
            shutil.rmtree(path, ignore_errors=True)
            removed.append(path)
    return removed


def select_checkpoint(ckpt_dir: str, stage: str = "nopush", policy: str = "best"):
    """(epoch, stage, acc, path) of the requested stage, or None: the most
    accurate ('best') or the last ('latest')."""
    if policy not in ("best", "latest"):
        raise ValueError(f"unknown policy {policy!r}")
    ckpts = [c for c in list_checkpoints(ckpt_dir) if c[1] == stage]
    if not ckpts:
        return None
    return max(ckpts, key=lambda c: c[2]) if policy == "best" else ckpts[-1]
