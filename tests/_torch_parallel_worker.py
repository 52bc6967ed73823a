"""One rank of the port's multi-process parity runs (tests/test_torch_parallel.py,
tests/test_torch_cuda.py). Imports torch and the port only, never JAX.

    python tests/_torch_parallel_worker.py SPEC.json RANK

SPEC: {"init": "tcp://127.0.0.1:PORT", "world": n, "mesh": [data, model],
"device": "cpu" | "cuda:0", "backend": "gloo", "batches": npz path,
"scenarios": [...]}. Each scenario restores `ckpt` (a whole state) onto
the mesh, runs `steps` train steps on this rank's rows of batches x{i},
y{i} (a global batch each), and writes `out/rank{r}.npz`: the per-step
loss, accuracy and EM count, the gathered means, priors and bank, every
parameter flattened, the kernel launches of the steps (score_pool, its
backward, the epilogue, the E-step), the eval logits of batch ex before
and after the steps gathered in rank order, the rank's at-rest layout of
the parameters and moments after the restore (`layout0_*`) and after the
steps (`layout_*`: the bytes of their storage, the specs' per-rank and
replicated counts, the leaves held cut and whether each equals its slice
of the gathered whole), and (with `save`) a checkpoint written
through `Trainer.save` (sharded, or replicated with `"save_format": "replicated"`).
With `"async_bank": true` the steps run the async bank pipeline, flushed
after the last. A scenario of `"kind": "interp"` restores `ckpt` and writes
`trust/interp_sharded.py::interp_metrics_sharded` of the CUB-layout tree
`cub` (global batches of `batch`) as `out/rank{r}.json`; one of `"kind":
"wire"` writes there the float64 sum and the row gather of
parallel/multihost.py over the ranks, and dumps a flight recorder into
`out` (its host identity).
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mgproto_tpu_torch.config import EMConfig, LossConfig, tiny_test_config  # noqa: E402
from mgproto_tpu_torch.ops.em_kernels import em_estep_stats  # noqa: E402
from mgproto_tpu_torch.ops.fused_epilogue import fused_bn_epilogue  # noqa: E402
from mgproto_tpu_torch.ops.fused_scoring import score_pool, score_pool_bwd  # noqa: E402
from mgproto_tpu_torch.parallel.mesh import initialize_distributed, make_mesh  # noqa: E402
from mgproto_tpu_torch.parallel.multihost import allgather_rows  # noqa: E402
from mgproto_tpu_torch.parallel import sharding  # noqa: E402
from mgproto_tpu_torch.parallel.sharding import put_batch  # noqa: E402
from mgproto_tpu_torch.parallel.trainer import ShardedTrainer  # noqa: E402


def scenario_config(sc, batch):
    """The tiny config of a scenario at `batch` rows a process (f32 batches:
    device augmentation off on every device): its aux loss, EM stepping and
    width, and the scoring and E-step routes (None = the device's
    default)."""
    cfg = tiny_test_config(num_classes=sc.get("num_classes", 4))
    model = dataclasses.replace(cfg.model, fused_scoring=sc.get("fused_scoring"))
    em = EMConfig(reference_stepping=sc.get("reference_stepping", False),
                  fused_estep=sc.get("fused_estep"),
                  max_active_classes=sc.get("max_active_classes", -1),
                  async_bank=sc.get("async_bank", False))
    return cfg.replace(model=model, em=em,
                       loss=LossConfig(aux_loss=sc.get("aux_loss", "proxy_anchor")),
                       data=dataclasses.replace(cfg.data, train_batch_size=batch,
                                                device_augment=False))


def layout(trainer, state, prefix):
    """The rank's at-rest layout of the parameters and moments: the bytes
    of their storage, `param_bytes_per_rank` at the mesh's model axis and
    at 1, the leaves held cut, and whether each equals its slice of the
    whole gathered by `full_params` (a collective of the model group)."""
    c, m = trainer.cfg.model.num_classes, trainer.mesh.model
    tree = sharding.param_tensors(state)
    leaves = [t for sub in tree.values() for t in (sub.values() if isinstance(sub, dict) else [sub])]
    rest = [t.detach().clone() for t in leaves]
    with trainer.full_params(state, moments=True):
        whole = sharding.param_tensors(state)
        wleaves = [t for sub in whole.values()
                   for t in (sub.values() if isinstance(sub, dict) else [sub])]
        params = dict(state.model.named_parameters())
        owner = dict(params, **({"proxies": state.proxies} if state.proxies is not None else {}))
        names = [n for f, sub in tree.items() for n in (sub if isinstance(sub, dict) else [f])]
        cut, equal = 0, True
        for name, r, w in zip(names, rest, wleaves):
            shard = sharding.param_shard(owner[name.split("/")[0]])
            if shard is None:
                equal &= torch.equal(r, w)
                continue
            cut += 1
            equal &= tuple(r.shape) != tuple(w.shape) and torch.equal(r, shard.slice_of(w))
    return {f"{prefix}_bytes": sharding.held_bytes(tree),
            f"{prefix}_spec": sharding.param_bytes_per_rank(state, c, m),
            f"{prefix}_replicated": sharding.param_bytes_per_rank(state, c, 1),
            f"{prefix}_cut": cut, f"{prefix}_leaves": len(leaves),
            f"{prefix}_equal": bool(equal)}


def run_scenario(sc, mesh, batches, device):
    cfg = scenario_config(sc, len(batches["y0"]) // mesh.size)
    trainer = ShardedTrainer(cfg, steps_per_epoch=4, mesh=mesh, device=device)
    state = trainer.restore(sc["ckpt"])
    out = layout(trainer, state, "layout0")
    if "ex" in batches:
        (ex,) = put_batch((batches["ex"],), mesh)
        out["eval0"] = allgather_rows(trainer.eval_step(state, ex).logits.cpu().numpy())
    losses, accs, em = [], [], []
    kernels = (score_pool, score_pool_bwd, fused_bn_epilogue, em_estep_stats)
    for fn in kernels:
        fn.launches = 0
    for i in range(sc["steps"]):
        x, y = put_batch((batches[f"x{i}"], batches[f"y{i}"]), mesh)
        state, m = trainer.train_step(state, x, y, use_mine=True, update_gmm=True)
        losses.append(float(m.loss))
        accs.append(float(m.accuracy))
        em.append(m.em_active)
    if trainer.async_bank:
        state, _ = trainer.flush_bank(state)
    launches = [fn.launches for fn in kernels]
    out.update(layout(trainer, state, "layout"))
    with trainer.full_params(state, moments=True):
        full = trainer.full_state(state)
        out.update(
            launches=np.array(launches),
            loss=np.array(losses), accuracy=np.array(accs), em_active=np.array(em),
            means=full.gmm.means.detach().cpu().numpy(), priors=full.gmm.priors.cpu().numpy(),
            length=full.memory.length.cpu().numpy(), cursor=full.memory.cursor.cpu().numpy(),
            feats=full.memory.feats.cpu().numpy(),
            params=torch.cat([p.detach().reshape(-1)
                              for p in trainer.params(state)]).cpu().numpy(),
            trunk0=next(state.model.features.parameters()).detach().cpu().numpy(),
            running_mean=next(b for n, b in state.model.named_buffers()
                              if n.endswith("running_mean")).cpu().numpy(),
        )
    if "ex" in batches:
        out["eval_logits"] = allgather_rows(trainer.eval_step(state, ex).logits.cpu().numpy())
    if sc.get("save"):
        trainer.ckpt_sharded = sc.get("save_format", "sharded") == "sharded"
        trainer.save(sc["save"], state, "1nopush0.5000", metadata={"epoch": 1, "stage": "nopush"})
    return out


def run_interp(sc, mesh, device):
    from mgproto_tpu_torch.cli.interpret import build_eval_loader
    from mgproto_tpu_torch.data.cub_parts import CubParts
    from mgproto_tpu_torch.trust.interp_sharded import interp_metrics_sharded

    cfg = scenario_config(sc, sc["batch"])
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, test_batch_size=sc["batch"],
                                               num_workers=0))
    trainer = ShardedTrainer(cfg, steps_per_epoch=1, mesh=mesh, device=device)
    state = trainer.restore(sc["ckpt"])
    return interp_metrics_sharded(
        trainer, state, lambda: iter(build_eval_loader(cfg, sc["cub"])), CubParts(sc["cub"]),
        cfg.model.num_classes, consistency_half_size=sc["half_size"],
        purity_half_size=sc["purity_half_size"], top_k=sc["top_k"])


def run_wire(sc):
    from mgproto_tpu_torch.obs.flightrec import FlightRecorder
    from mgproto_tpu_torch.parallel.multihost import allgather_sum

    rank = torch.distributed.get_rank()
    rec = FlightRecorder(dump_dir=sc["out"])
    rec.record("probe", value=rank)
    rows = allgather_rows(np.array([[rank, 2.0 ** 53 - 1 - rank]], np.float64))
    return {"sum": allgather_sum(float(2 ** 24 + 1) + rank), "rows": rows.tolist(),
            "dump": rec.maybe_dump("probe"), "event": rec.events()[-1]}


def main(argv):
    with open(argv[1]) as f:
        spec = json.load(f)
    rank = int(argv[2])
    device = spec.get("device", "cpu")
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    initialize_distributed(backend=spec.get("backend", "gloo"), init_method=spec["init"],
                           rank=rank, world_size=spec["world"], device=device, timeout_s=90)
    mesh = make_mesh(*spec["mesh"], timeout_s=90)
    batches = dict(np.load(spec["batches"])) if spec.get("batches") else {}
    for sc in spec["scenarios"]:
        os.makedirs(sc["out"], exist_ok=True)
        if sc.get("kind") in ("interp", "wire"):
            res = run_interp(sc, mesh, device) if sc["kind"] == "interp" else run_wire(sc)
            with open(os.path.join(sc["out"], f"rank{rank}.json"), "w") as f:
                json.dump(res, f)
            continue
        res = run_scenario(sc, mesh, batches, device)
        np.savez(os.path.join(sc["out"], f"rank{rank}.npz"), **res)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
