"""Checkpoint and resume of the whole train state (counterpart of
mgproto_tpu/utils/checkpoint.py, in the port's own format).

A checkpoint is a directory named `{epoch}{stage}{accuracy:.4f}` (the
reference's scheme, e.g. `104nopush0.8224`) holding
  * state.pt: one `torch.save` of the model's state_dict (parameters and
    BatchNorm buffers), the proxies (a proxy-based aux loss only), the GMM,
    the memory bank, the joint, warm and mean Adam state_dicts, `step` and
    `joint_updates`;
  * mgproto_manifest.json: every tensor's name, shape and dtype, and
    `step` (the JAX package's manifest schema, so its listings read these
    directories too);
  * mgproto_meta.json: epoch, stage, accuracy and config metadata: the
    training settings a restore must be built with (`compute_dtype`,
    `aux_loss`, `em_reference_stepping`), which
    `adopt_checkpoint_train_config` carries into a caller's config.

A save writes `<name>.tmp` and renames it into place, so an interrupted save
never leaves a directory any listing trusts; failed writes are retried.
`restore_checkpoint` checks the manifest against the restore target and
the loaded tensors against the manifest (`CheckpointIntegrityError`), then
copies the tensors into the target's own parameter objects, the ones its
optimizers hold, and loads the optimizer states, which torch maps onto the
parameters' device: a checkpoint written on the card restores on the CPU
and the other way round.

The sharded format (`sharded=True`; the default under several ranks, as
in the JAX package) is the JAX package's coordinated protocol with its
files: every rank writes only what it owns (when it is the first rank of
its model column, its class slab of the GMM, the bank and the mean
optimizer's moments where the model axis splits the classes, and its
slices of the parameters, the proxies and their joint and warm moments
where the model axis cuts them, parallel/sharding.py; rank 0 every leaf
held whole) as `shard_<rank:05d>.npz` + `shard_<rank:05d>.idx.json`
(each chunk's leaf, key and global [start, stop) span per dimension) into
the staging directory `<name>.tmp`; rank 0 adds the manifest (global
shapes, `sharded`, the saving world size), the metadata, `skeleton.pt`
(the payload's non-tensor parts: optimizer settings, counters) and last
the COMMIT marker, the one publish point, then swaps staging into place.
Five barriers (`begin`, `shards`, `commit`, `publish`, `verified`,
parallel/multihost.py `checkpoint_barrier`) keep the ranks in lockstep,
every rank verifies the publish from the file system, and a failed
attempt is retried by every rank together (`retry_call`; the chaos knob
MGPROTO_CHAOS_CKPT_FAILS fails an attempt just before COMMIT). Every
listing treats a sharded directory without COMMIT as absent, so a crash at
any moment of a save leaves nothing `resume="auto"` trusts, and retention
never deletes the last committed checkpoint for it. A restore reassembles
each leaf whole on the host from the chunks of every rank, refusing a
torn or overlapping cover, and loads it into a whole-state target, which
`parallel/trainer.py` then cuts to the restoring rank's slab and slices:
N ranks restore onto M (`elastic_restores_total` counts N != M).

The replicated format under several ranks: the trainer gathers the class
slabs, rank 0 writes, and every rank joins the publish and verify
barriers, so a retry stays in lockstep there too.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import re
import shutil
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from mgproto_tpu_torch.core.memory import Memory
from mgproto_tpu_torch.core.state import TrainState

_NAME_RE = re.compile(r"^(\d+)([a-z_]+)(\d+\.\d+)$")

MANIFEST_FILE = "mgproto_manifest.json"
MANIFEST_FORMAT = 1
META_FILE = "mgproto_meta.json"
STATE_FILE = "state.pt"
TMP_SUFFIX = ".tmp"
COMMIT_FILE = "COMMIT"
SKELETON_FILE = "skeleton.pt"
_SHARD_NPZ = "shard_{pid:05d}.npz"
_SHARD_IDX = "shard_{pid:05d}.idx.json"
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
    proxies = {} if state.proxies is None else {"proxies": state.proxies.detach()}
    return {
        "model": state.model.state_dict(),
        **proxies,
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


def _world() -> Tuple[int, int]:
    from mgproto_tpu_torch.parallel.mesh import world

    return world()


def _atomic_json(path: str, payload: dict) -> None:
    tmp = path + TMP_SUFFIX
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def _chaos_fail(name: str) -> None:
    """The chaos knob's simulated crash just before a publish point."""
    from mgproto_tpu_torch.resilience.chaos import get_active

    chaos = get_active()
    if chaos is not None and chaos.checkpoint_should_fail():
        raise IOError(f"chaos: injected checkpoint write failure ({name})")


def _skeleton(tree: Any) -> Any:
    """The payload with every tensor replaced by None."""
    if isinstance(tree, torch.Tensor):
        return None
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_skeleton(v) for v in tree)
    return tree


def _fill(tree: Any, leaves: Dict[str, torch.Tensor], prefix: str = "") -> Any:
    """`_skeleton`'s inverse: the tensors put back by their path."""
    if tree is None and prefix in leaves:
        return leaves[prefix]
    if isinstance(tree, dict):
        return {k: _fill(v, leaves, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(v, leaves, f"{prefix}/{i}") for i, v in enumerate(tree))
    return tree


def _sharded_leaves(payload: Dict[str, Any], mesh, axes: Dict[str, int]) -> List[dict]:
    """Every tensor of `payload` with its global shape and the [start,
    stop) span this rank holds of it, and whether this rank writes it: a
    leaf of `axes` (cut on that axis over `mesh`'s model axis, by
    parallel/sharding.py's specs) its model column's first rank (data
    index 0), every other leaf rank 0."""
    rank = _world()[0]
    out = []
    for path, t in _tensors(payload):
        shape, span, writes = list(t.shape), [[0, d] for d in t.shape], rank == 0
        axis = axes.get(path)
        if axis is not None:
            start = mesh.model_index * shape[axis]
            span[axis] = [start, start + shape[axis]]
            shape[axis] *= mesh.model
            writes = mesh.data_index == 0
        out.append({"path": path, "tensor": t, "shape": shape, "span": span, "writes": writes})
    return out


def _write_rank_shards(staging: str, leaves: List[dict], rank: int) -> None:
    """This rank's chunks as one npz and its index sidecar, each through a
    temporary file and a rename, the sidecar last: a restore reads the
    sidecars, so an npz without one is invisible."""
    arrays, chunks = {}, []
    for i, leaf in enumerate(leaves):
        if not leaf["writes"]:
            continue
        key = f"c{i}_0"
        arrays[key] = leaf["tensor"].detach().cpu().numpy()
        chunks.append({"leaf": i, "path": leaf["path"], "key": key, "index": leaf["span"]})
    npz = os.path.join(staging, _SHARD_NPZ.format(pid=rank))
    with open(npz + TMP_SUFFIX, "wb") as f:
        np.savez(f, **arrays)
    os.replace(npz + TMP_SUFFIX, npz)
    _atomic_json(os.path.join(staging, _SHARD_IDX.format(pid=rank)),
                 {"process": rank, "chunks": chunks})


def _save_sharded(path: str, payload: Dict[str, Any], name: str, metadata: Optional[dict],
                  mesh, axes: Dict[str, int]) -> None:
    """One attempt of the coordinated sharded save, called in lockstep by
    every rank (the JAX package's `_save_sharded`, step for step):

      1. rank 0 clears a stale staging directory at this name;
      2. barrier `begin`: every rank sees a clean staging directory;
      3. every rank writes its shard npz and index sidecar into staging;
      4. barrier `shards`: every shard file is on the shared file system;
      5. rank 0 writes the manifest, the metadata, the skeleton, then the
         COMMIT marker, all in staging (the chaos knob fails the attempt
         just before COMMIT);
      6. barrier `commit`, then rank 0 alone swaps staging into place
         (removing a committed checkpoint of the same name at the last
         moment);
      7. barrier `publish`, then every rank verifies from the file system
         that THIS attempt published: staging gone and COMMIT present (a
         same-name checkpoint's old COMMIT cannot fake it: only the swap
         removes staging), then barrier `verified`, so no rank starts a
         retry (which clears staging) before every peer has read the
         outcome. A failure raises on every rank alike."""
    from mgproto_tpu_torch.parallel.multihost import checkpoint_barrier

    rank, size = _world()
    primary = rank == 0
    staging = path + TMP_SUFFIX
    leaves = _sharded_leaves(payload, mesh, axes)
    if primary:
        if os.path.isdir(staging):
            shutil.rmtree(staging)
        os.makedirs(staging, exist_ok=True)
    checkpoint_barrier(f"{name}.begin")
    os.makedirs(staging, exist_ok=True)
    _write_rank_shards(staging, leaves, rank)
    checkpoint_barrier(f"{name}.shards")
    commit_error: Optional[Exception] = None
    if primary:
        try:
            entries = [{"path": lf["path"], "shape": lf["shape"],
                        "dtype": _dtype_name(lf["tensor"])} for lf in leaves]
            _atomic_json(os.path.join(staging, MANIFEST_FILE), {
                "format": MANIFEST_FORMAT, "sharded": True, "num_hosts": size,
                "num_devices": size, "num_leaves": len(entries), "step": payload["step"],
                "leaves": entries})
            if metadata is not None:
                _atomic_json(os.path.join(staging, META_FILE), metadata)
            torch.save(_skeleton(payload), os.path.join(staging, SKELETON_FILE))
            _chaos_fail(name)
            _atomic_json(os.path.join(staging, COMMIT_FILE),
                         {"committed_at": time.time(), "num_hosts": size, "num_devices": size})
        except Exception as e:  # join the barrier first; raise after
            commit_error = e
    checkpoint_barrier(f"{name}.commit")
    if commit_error is None and primary:
        try:
            if os.path.isdir(path):
                shutil.rmtree(path)
            os.rename(staging, path)
        except Exception as e:  # a swap failure must not strand the peers
            commit_error = e
    checkpoint_barrier(f"{name}.publish")
    failure: Optional[Exception] = commit_error
    if failure is None and (os.path.isdir(staging)
                            or not os.path.exists(os.path.join(path, COMMIT_FILE))):
        failure = IOError(f"sharded checkpoint {path} was not committed by rank 0; treating "
                          "the save as failed on every rank")
    checkpoint_barrier(f"{name}.verified")
    if failure is not None:
        raise failure


def _save_replicated(path: str, payload: Dict[str, Any], name: str,
                     metadata: Optional[dict]) -> None:
    """One attempt of the replicated save: rank 0 writes `<name>.tmp` and
    renames it into place (the publish point; the chaos knob fails the
    attempt just before it); under several ranks every rank then joins
    the `publish` barrier, verifies the rename from the file system (a
    `.tmp` left behind means this attempt failed) and joins `verified`."""
    from mgproto_tpu_torch.parallel.multihost import checkpoint_barrier

    tmp = path + TMP_SUFFIX
    write_error: Optional[Exception] = None
    if _world()[0] == 0:
        try:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            torch.save(payload, os.path.join(tmp, STATE_FILE))
            with open(os.path.join(tmp, MANIFEST_FILE), "w") as f:
                json.dump(_manifest(payload), f)
            if metadata is not None:
                with open(os.path.join(tmp, META_FILE), "w") as f:
                    json.dump(metadata, f)
            _chaos_fail(name)
            if os.path.isdir(path):
                shutil.rmtree(path)
            os.rename(tmp, path)
        except Exception as e:  # join the barrier first; raise after
            write_error = e
            try:  # the .tmp left behind is the peers' failure signal
                os.makedirs(tmp, exist_ok=True)
            except OSError:
                pass
    checkpoint_barrier(f"{name}.publish")
    failure: Optional[Exception] = write_error
    if failure is None and (os.path.isdir(tmp) or not os.path.isdir(path)):
        failure = IOError(f"checkpoint {path} was not published by rank 0; treating the save "
                          "as failed on every rank")
    checkpoint_barrier(f"{name}.verified")
    if failure is not None:
        raise failure


def save_checkpoint(ckpt_dir: str, state: TrainState, name: str,
                    metadata: Optional[dict] = None, retries: int = SAVE_RETRIES,
                    sharded: Optional[bool] = None, mesh=None,
                    num_classes: Optional[int] = None) -> str:
    """Write `state` as the checkpoint `ckpt_dir/name`; returns its path.

    `sharded=None` is the sharded format under several ranks and the
    replicated one in one process; True or False is honored as given
    (`--ckpt_format`). Sharded: every rank calls this with its own state
    and `mesh` (parallel/mesh.py; None: every leaf whole), the model's
    `num_classes`: the leaves the model axis splits (a class slab, the
    cut parameters and moments) are written by the first rank of each
    model column with their span. Replicated: every rank calls it with
    the whole state and rank 0 writes. A failed attempt is
    counted (`checkpoint_write_failures_total`) and retried up to
    `retries` times with backoff, by every rank in lockstep; a barrier
    timeout is not retried (the dead peer cannot join a retry)."""
    from mgproto_tpu_torch.parallel.multihost import BarrierTimeoutError
    from mgproto_tpu_torch.resilience import metrics as _m
    from mgproto_tpu_torch.resilience.retry import retry_call

    if sharded is None:
        sharded = _world()[1] > 1
    path = os.path.abspath(os.path.join(ckpt_dir, name))
    payload = state_payload(state)
    axes: Dict[str, int] = {}
    if sharded and mesh is not None and mesh.model > 1:
        from mgproto_tpu_torch.parallel.sharding import sharded_payload_axes

        axes = sharded_payload_axes(state, num_classes, mesh.model)

    def attempt() -> None:
        try:
            if sharded:
                _save_sharded(path, payload, name, metadata, mesh, axes)
            else:
                _save_replicated(path, payload, name, metadata)
        except Exception:
            _m.counter(_m.CKPT_WRITE_FAILURES).inc()
            raise

    retry_call(attempt, retries=retries, base_delay=0.1, max_delay=2.0, scope="checkpoint",
               no_retry_on=(BarrierTimeoutError,))
    return path


def has_shard_files(path: str) -> bool:
    """True when `path` holds per-rank shard files (a sharded save,
    committed or not)."""
    try:
        names = os.listdir(path)
    except OSError:
        return False
    return any(n.startswith("shard_") and (n.endswith(".npz") or n.endswith(".idx.json"))
               for n in names)


def is_committed(path: str) -> bool:
    """True when the sharded protocol's COMMIT marker exists (a replicated
    save's publish point is its rename)."""
    return os.path.exists(os.path.join(path, COMMIT_FILE))


def _load_sharded(path: str, manifest: dict) -> Dict[str, Any]:
    """The payload of a committed sharded checkpoint, every leaf
    reassembled whole on the host from the chunks of every rank's
    sidecar; a cover with a hole or an overlap raises. Counts an elastic
    restore when the saving world size differs from this one."""
    if not is_committed(path):
        raise CheckpointIntegrityError(
            f"sharded checkpoint {path} has no COMMIT marker (crashed mid-save); it must not "
            "be restored")
    entries = manifest["leaves"]
    bufs = [np.empty(e["shape"], np.dtype(e["dtype"])) for e in entries]
    covered = [np.zeros(e["shape"], bool) for e in entries]
    for sidecar in sorted(os.path.join(path, n) for n in os.listdir(path)
                          if n.startswith("shard_") and n.endswith(".idx.json")):
        with open(sidecar) as f:
            chunks = json.load(f)["chunks"]
        if not chunks:
            continue
        with np.load(sidecar[: -len(".idx.json")] + ".npz") as npz:
            for c in chunks:
                i = int(c["leaf"])
                if c.get("path", entries[i]["path"]) != entries[i]["path"]:
                    raise CheckpointIntegrityError(
                        f"sharded checkpoint {path}: chunk {c['key']} of {c['path']} is "
                        f"filed under leaf {i} ({entries[i]['path']})")
                sl = tuple(slice(int(a), int(b)) for a, b in c["index"])
                if covered[i][sl].any():
                    raise CheckpointIntegrityError(
                        f"sharded checkpoint {path}: leaf {i} ({entries[i]['path']}) has "
                        "overlapping chunks")
                bufs[i][sl] = npz[c["key"]]
                covered[i][sl] = True
    leaves = {}
    for e, buf, cov in zip(entries, bufs, covered):
        got, total = int(cov.sum()), int(cov.size)
        if got != total:
            raise CheckpointIntegrityError(
                f"sharded checkpoint {path}: leaf {e['path']} chunks cover {got} of {total} "
                "elements")
        leaves[e["path"]] = torch.from_numpy(buf)
    try:
        skeleton = torch.load(os.path.join(path, SKELETON_FILE), weights_only=True)
    except (OSError, RuntimeError, EOFError, ValueError, pickle.UnpicklingError) as e:
        raise CheckpointIntegrityError(f"unreadable {SKELETON_FILE} in {path}: {e}")
    saved = int(manifest.get("num_hosts", 1))
    here = _world()[1]
    if saved != here:
        from mgproto_tpu_torch.obs.flightrec import record_event
        from mgproto_tpu_torch.resilience import metrics as _m

        _m.counter(_m.ELASTIC_RESTORES).inc()
        record_event("elastic_restore", path=path, saved_hosts=saved, restore_hosts=here)
    return _fill(skeleton, leaves)


def restore_checkpoint(path: str, target: TrainState) -> TrainState:
    """Load a checkpoint, replicated or sharded (its manifest says which),
    into `target` (a state of every class built for the same config, e.g.
    `Trainer.init_state`) in place and return it."""
    path = os.path.abspath(path)
    manifest = load_manifest(path)
    if manifest is None:
        if has_shard_files(path):
            raise CheckpointIntegrityError(
                f"{path} holds uncommitted shard files and no manifest (crashed mid-save); "
                "it cannot be restored")
        raise CheckpointIntegrityError(f"{path} has no manifest")
    _verify_manifest(manifest, target, path)
    if manifest.get("sharded"):
        payload = _load_sharded(path, manifest)
    else:
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
        if target.proxies is not None:
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


def state_digest(state: TrainState) -> str:
    """sha256 over every tensor of the state (the `state_payload` tree in
    its order: each tensor's path, shape, dtype and exact bytes) and the two
    counters; the port's own counterpart of JAX's `pytree_digest`, so the
    two packages' digests never equal. Two states with one digest serve and
    step identically."""
    import hashlib

    payload = state_payload(state)
    h = hashlib.sha256(f"mgproto_tpu_torch.TrainState step={payload['step']} "
                       f"joint_updates={payload['joint_updates']}".encode())
    for path, t in _tensors(payload):
        arr = t.detach().cpu().contiguous()
        h.update(f"{path}{tuple(arr.shape)}{_dtype_name(arr)}".encode())
        h.update(arr.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def load_metadata(path: str) -> Optional[dict]:
    meta = os.path.join(path, META_FILE)
    if not os.path.exists(meta):
        return None
    with open(meta) as f:
        return json.load(f)


def adopt_checkpoint_train_config(cfg, path: str, log=None):
    """`cfg` with the training settings a checkpoint's metadata records
    adopted for a restore (the JAX package's function of the same name):

    - `model.compute_dtype`: evaluating under other numerics shifts the
      p(x) scale the OoD thresholds ride on;
    - `loss.aux_loss`: the proxy-based losses carry proxies and their Adam
      state, so a restore target built with another aux loss has another
      structure and the restore refuses it;
    - `em.reference_stepping`: resuming without it would switch the EM
      math mid-training, and nothing else would catch it.

    A checkpoint whose metadata predates a key keeps `cfg`'s value. `log`
    (e.g. print) is told of every override."""
    meta = load_metadata(path) or {}
    overrides = (
        ("compute_dtype", "model", "compute_dtype"),
        ("aux_loss", "loss", "aux_loss"),
        ("em_reference_stepping", "em", "reference_stepping"),
    )
    for key, section, field in overrides:
        value = meta.get(key)
        current = getattr(getattr(cfg, section), field)
        # an empty string or a missing key keeps cfg's value
        if value is None or value == "" or value == current:
            continue
        if log is not None:
            log(f"note: checkpoint was trained with {section}.{field}={value}; "
                f"overriding {current}")
        cfg = cfg.replace(**{section: dataclasses.replace(getattr(cfg, section), **{field: value})})
    return cfg


def save_state_w_condition(ckpt_dir: str, state: TrainState, epoch: int, stage: str,
                           accuracy: float, target_accuracy: float,
                           metadata: Optional[dict] = None, save=None) -> Optional[str]:
    """Save only when `accuracy >= target_accuracy` (equality saves: the
    default target 0.0 keeps every stage checkpoint); the name encodes
    epoch, stage and accuracy. `save` (default `save_checkpoint`, same
    arguments) writes it: under a mesh, the trainer's `save`."""
    if accuracy < target_accuracy:
        return None
    meta = dict(metadata or {})
    meta.update(epoch=epoch, stage=stage, accuracy=accuracy)
    return (save or save_checkpoint)(ckpt_dir, state, checkpoint_name(epoch, stage, accuracy),
                                     metadata=meta)


# Within one epoch the reference saves nopush, then push, then prune: resume
# picks the latest STAGE, not the highest accuracy. "preempt" checkpoints
# (the JAX package's mid-epoch saves) order first.
_STAGE_ORDER = {"preempt": -1, "nopush": 0, "push": 1, "prune": 2}


def _manifest_state(path: str) -> str:
    """'ok' (a valid manifest), 'missing' (none) or 'bad' (corrupt). A
    sharded directory (its manifest says so, or it holds shard files) is
    'bad' until its COMMIT marker exists."""
    try:
        manifest = load_manifest(path)
    except CheckpointIntegrityError:
        return "bad"
    sharded = bool((manifest or {}).get("sharded")) or has_shard_files(path)
    if sharded and not is_committed(path):
        return "bad"
    return "ok" if manifest is not None else "missing"


def list_checkpoints(ckpt_dir: str, require_manifest: bool = False):
    """Every parseable checkpoint in `ckpt_dir` as (epoch, stage, acc, path),
    in (epoch, stage) order. `.tmp` saves, corrupt manifests and sharded
    directories without COMMIT are always skipped; `require_manifest` also
    skips directories without a manifest."""
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
    and the `keep_best` most accurate ones, the `.tmp` directories of dead
    saves and the sharded directories without COMMIT (nothing resumes from
    them; the listing never counted them, so the last committed checkpoint
    is never deleted for one). `keep_last <= 0` keeps everything. Returns
    what it deleted. Under several ranks rank 0 alone calls it."""
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
    trusted = {c[3] for c in ckpts}
    for name in os.listdir(ckpt_dir):
        path = os.path.join(ckpt_dir, name)
        if not os.path.isdir(path) or path in trusted:
            continue
        if name.endswith(TMP_SUFFIX):
            orphan = parse_checkpoint_name(name[: -len(TMP_SUFFIX)])
        else:
            orphan = (parse_checkpoint_name(name) and has_shard_files(path)
                      and not is_committed(path))
        if orphan:
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
