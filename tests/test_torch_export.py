"""The port's serving artifact (mgproto_tpu_torch/engine/export.py,
cli/export.py) against the JAX package's `.mgproto`, on the CPU.

One tiny JAX state (its priors drawn at random, then the top-2 prune, so
some prototypes are dead) is exported by the JAX package (`export_eval`,
StableHLO) and carried into the port, whose artifact holds the same
weights. Tolerances: logits and log p(x) of the two artifacts within 1e-5;
calibration thresholds within 1e-5; explanations `proto_idx` equal and
`proto_logd` within 1e-5 (the two packages' CPU convolutions differ by
~1e-6 at this size). Also: the artifact is a plain zip with its meta.json,
a static batch is enforced, a JAX `.mgproto` and an uncalibrated artifact
are refused typed, the export main end to end (calibration from the config's
test folder against JAX's `calibrate_from_config`, the explanation table
with push provenance), and `state_digest`.
"""

import dataclasses
import functools
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_states import port_state, write_jpeg_tree
from mgproto_tpu.config import DataConfig as JaxDataConfig
from mgproto_tpu.config import tiny_test_config as jax_tiny_config
from mgproto_tpu.core.mgproto import prune_top_m as jax_prune
from mgproto_tpu.engine import export as jexport
from mgproto_tpu.engine.train import Trainer as JaxTrainer
from mgproto_tpu.serving import calibration as jcal
from mgproto_tpu_torch.cli import export as texport_main
from mgproto_tpu_torch.config import Config, DataConfig, tiny_test_config
from mgproto_tpu_torch.engine import export as texport
from mgproto_tpu_torch.serving import metrics as sm
from mgproto_tpu_torch.serving.calibration import calibrate, calibrate_from_config, gmm_fingerprint
from mgproto_tpu_torch.serving.engine import ServingEngine, UncalibratedArtifactError
from mgproto_tpu_torch.utils.checkpoint import save_checkpoint, state_digest

ATOL = 1e-5
IMG = 32
TOP_E = 5


@pytest.fixture(autouse=True)
def fresh_registry():
    prev = sm.set_current_registry(None)
    yield
    sm.set_current_registry(prev)


def _images(n, seed):
    return np.random.default_rng(seed).normal(size=(n, IMG, IMG, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax():
    """(JAX trainer, its state with random priors pruned to the top 2 of 3)."""
    cfg = jax_tiny_config()
    trainer = JaxTrainer(cfg, steps_per_epoch=1)
    state = trainer.init_state(jax.random.PRNGKey(0))
    m = cfg.model
    priors = np.random.default_rng(7).dirichlet(np.ones(m.prototypes_per_class),
                                                size=m.num_classes).astype(np.float32)
    gmm = jax_prune(state.gmm._replace(priors=jnp.asarray(priors)), 2)
    return trainer, state.replace(gmm=gmm)


@functools.lru_cache(maxsize=None)
def _port():
    """(port trainer, the JAX state carried into the port)."""
    return port_state(_jax()[1], tiny_test_config())


def _port_artifact(path, static_batch=None, calibration=None, explain=None):
    trainer, state = _port()
    cfg = trainer.cfg
    meta = texport.artifact_meta(cfg, "ckpt/path", gmm_fingerprint(state.gmm), static_batch)
    texport.save_artifact(path, state.model, state.gmm, meta, calibration=calibration,
                          explain=explain)
    return path


def _jax_artifact(path):
    trainer, state = _jax()
    jexport.save_artifact(path, jexport.export_eval(trainer, state),
                          jexport.artifact_meta(trainer.cfg, None, True))
    return path


@pytest.mark.parametrize("batch", [2, 5])
def test_artifact_matches_the_jax_export(tmp_path, batch):
    jinfer, _ = jexport.load_artifact(_jax_artifact(str(tmp_path / "j.mgproto")))
    art = texport.load_artifact(_port_artifact(str(tmp_path / "t.mgproto")), device="cpu")
    x = _images(batch, seed=batch)
    want, got = jinfer(jnp.asarray(x)), art.infer(x)
    np.testing.assert_allclose(got["logits"], np.asarray(want["logits"]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got["log_px"], np.asarray(want["log_px"]), rtol=0, atol=ATOL)
    # the artifact serves the state it was exported from, bit for bit
    live = _port()[0].eval_step(_port()[1], x)
    np.testing.assert_array_equal(got["log_px"], live.log_px.numpy())


def test_calibration_thresholds_match_jax():
    jtrainer, jstate = _jax()
    batches = [_images(6, seed=20), _images(6, seed=21)]
    want = jcal.calibrate(jtrainer, jstate, [jnp.asarray(b) for b in batches])
    trainer, state = _port()
    from mgproto_tpu_torch.engine.eval import Evaluator

    got = calibrate(Evaluator(state.model, state.gmm, trainer.cfg, device="cpu"), batches)
    assert got.num_id_samples == want.num_id_samples == 12
    assert set(got.thresholds) == set(want.thresholds)
    for k in want.thresholds:
        assert abs(got.thresholds[k] - want.thresholds[k]) <= ATOL, k
    np.testing.assert_allclose(got.quantile_log_px, want.quantile_log_px, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.per_class_temperature, want.per_class_temperature,
                               rtol=1e-4, atol=0)


def test_explanations_match_jax_and_never_list_a_pruned_prototype():
    jtrainer, jstate = _jax()
    trainer, state = _port()
    priors = np.asarray(jstate.gmm.priors).reshape(-1)
    assert (priors == 0).sum() == 4  # one of three pruned in each of the 4 classes
    x = _images(6, seed=30)
    want = jexport.make_explain_fn(jtrainer, jstate, top_e=TOP_E)(jnp.asarray(x))
    from mgproto_tpu_torch.engine.eval import Evaluator

    ev = Evaluator(state.model, state.gmm, trainer.cfg, device="cpu")
    got = texport.make_explain_fn(ev, TOP_E)(x)
    np.testing.assert_array_equal(got["proto_idx"], np.asarray(want["proto_idx"]))
    np.testing.assert_allclose(got["proto_logd"], np.asarray(want["proto_logd"]), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got["log_px"], np.asarray(want["log_px"]), rtol=0, atol=ATOL)
    assert (priors[got["proto_idx"]] > 0).all()
    # the explain forward's peaks are each prototype's dense maximum over patches
    from mgproto_tpu_torch.core.mgproto import patch_log_densities

    with torch.inference_mode():
        pm, _ = ev.model(torch.from_numpy(x))
        lp, _ = patch_log_densities(pm, ev.gmm)
    dense = lp.amax(dim=(3, 4)).reshape(6, -1).numpy()
    np.testing.assert_array_equal(np.take_along_axis(dense, got["proto_idx"], 1),
                                  got["proto_logd"].astype(np.float32))


def test_served_explanations_carry_the_table(tmp_path):
    trainer, state = _port()
    prov = {"image_id": list(range(12)), "spatial_idx": [3] * 12, "log_prob": [-1.5] * 12}
    table = texport.explain_table(state.gmm, provenance=prov, top_e=3)
    path = _port_artifact(str(tmp_path / "e.mgproto"), explain=table)
    eng = ServingEngine.from_artifact(path, allow_uncalibrated=True, explain=True, device="cpu")
    eng.warmup()
    resps = eng.serve_all(list(_images(3, seed=31)))
    assert all(r.outcome == "predict" and len(r.explain) == 3 for r in resps)
    row = resps[0].explain[0]
    assert set(row) == {"prototype", "class", "k", "prior", "log_density", "source_patch"}
    assert row["class"] == row["prototype"] // 3 and row["k"] == row["prototype"] % 3
    assert row["source_patch"] == {"image_id": row["prototype"], "spatial_idx": 3,
                                   "log_prob": -1.5}
    assert sm.counter(sm.EXPLANATIONS).value() == 3
    # without --explain the response has no explain key
    plain = ServingEngine.from_artifact(path, allow_uncalibrated=True, device="cpu")
    plain.warmup()
    assert "explain" not in plain.serve_all(list(_images(1, seed=31)))[0].to_dict()
    with pytest.raises(ValueError, match="explanation table"):
        ServingEngine.from_artifact(_port_artifact(str(tmp_path / "n.mgproto")),
                                    allow_uncalibrated=True, explain=True, device="cpu")


def test_artifact_is_a_plain_zip_with_meta(tmp_path):
    path = _port_artifact(str(tmp_path / "zip.mgproto"))
    with zipfile.ZipFile(path) as z:
        assert set(z.namelist()) == {"weights.pt", "meta.json"}
        meta = json.loads(z.read("meta.json"))
        torch.load(__import__("io").BytesIO(z.read("weights.pt")), weights_only=True)
        assert z.getinfo("weights.pt").compress_type == zipfile.ZIP_STORED
    # a recalibration rewrites the zip and keeps each member's compression
    texport.embed_calibration(path, {"threshold": 1.0})
    with zipfile.ZipFile(path) as z:
        assert set(z.namelist()) == {"weights.pt", "meta.json", "calibration.json"}
        assert z.getinfo("weights.pt").compress_type == zipfile.ZIP_STORED
        assert z.getinfo("meta.json").compress_type == zipfile.ZIP_DEFLATED
        assert json.loads(z.read("meta.json")) == meta
    jmeta = jexport.artifact_meta(_jax()[0].cfg, "ckpt/path", True)
    assert set(jmeta) - {"jax_version"} <= set(meta)
    assert meta["format"] == texport.FORMAT == "mgproto-torch-artifact-v1"
    assert meta["checkpoint"] == "ckpt/path" and meta["static_batch"] is None
    assert meta["model_config"] == json.loads(json.dumps(dataclasses.asdict(_port()[0].cfg.model)))
    assert texport.model_config_of(meta) == dataclasses.replace(
        _port()[0].cfg.model, fused_scoring=None, fused_epilogue=None)
    assert meta["gmm_fingerprint"] == gmm_fingerprint(_port()[1].gmm)


def test_static_batch_export_rejects_other_batch_sizes(tmp_path):
    path = _port_artifact(str(tmp_path / "static.mgproto"), static_batch=4)
    art = texport.load_artifact(path, device="cpu")
    assert art.meta["dynamic_batch"] is False and art.static_batch == 4
    assert art.infer(np.zeros((4, IMG, IMG, 3), np.float32))["logits"].shape == (4, 4)
    with pytest.raises(ValueError, match="static_batch=4"):
        art.infer(np.zeros((2, IMG, IMG, 3), np.float32))
    eng = ServingEngine.from_loaded(art, allow_uncalibrated=True, buckets=(1, 2, 8))
    assert eng.buckets == (4,)
    eng.warmup()
    assert [r.outcome for r in eng.serve_all(list(_images(3, seed=1)))] == ["predict"] * 3


def test_a_jax_artifact_is_refused_typed(tmp_path):
    path = _jax_artifact(str(tmp_path / "jax.mgproto"))
    with pytest.raises(texport.ArtifactFormatError, match="JAX artifact.*mgproto-stablehlo-v1"):
        texport.load_artifact(path, device="cpu")
    with pytest.raises(texport.ArtifactFormatError):
        ServingEngine.from_artifact(path, device="cpu")
    (tmp_path / "junk").write_bytes(b"not a zip")
    with pytest.raises(texport.ArtifactFormatError, match="not an artifact zip"):
        texport.read_meta(str(tmp_path / "junk"))


def test_uncalibrated_refused_and_jax_calibration_degrades(tmp_path):
    path = _port_artifact(str(tmp_path / "u.mgproto"))
    with pytest.raises(UncalibratedArtifactError, match="no calibration.json"):
        ServingEngine.from_artifact(path, device="cpu")
    eng = ServingEngine.from_artifact(path, allow_uncalibrated=True, device="cpu")
    assert eng.gate.degraded and not eng.gate.fingerprint_mismatch
    # a JAX calibration of the same GMM carries the JAX digest: it degrades
    jtrainer, jstate = _jax()
    jc = jcal.calibrate(jtrainer, jstate, [jnp.asarray(_images(6, seed=3))])
    texport.embed_calibration(path, jc)
    eng = ServingEngine.from_artifact(path, device="cpu")
    assert eng.gate.degraded and eng.gate.fingerprint_mismatch
    assert sm.counter(sm.FINGERPRINT_MISMATCHES).value() == 1


TINY_FLAGS = ["--arch", "tiny", "--img_size", "32", "--num_classes", "4", "--protos_per_class",
              "3", "--proto_dim", "8", "--aux_emb_sz", "8", "--mine_level", "4", "--mem_sz", "16",
              "--no_pretrained", "--batch_size", "6", "--num_workers", "0", "--device", "cpu"]


def test_export_main_calibrates_from_the_test_folder_as_jax_does(tmp_path, capsys):
    imgs = write_jpeg_tree(str(tmp_path / "imgs"), 4, 5, seed=4)
    run = str(tmp_path / "run")
    trainer, state = _port()
    save_checkpoint(run, state, "3prune0.5000", metadata={"epoch": 3, "stage": "prune"})
    prov = {"image_id": list(range(12)), "spatial_idx": [1] * 12, "log_prob": [-2.0] * 12}
    with open(os.path.join(run, "push_provenance.json"), "w") as f:
        json.dump(prov, f)
    out = str(tmp_path / "m.mgproto")
    texport_main.main(TINY_FLAGS + ["--train_dir", imgs, "--test_dir", imgs, "--push_dir", imgs,
                                    "--model_dir", run, "--out", out, "--calibrate", "--explain",
                                    "--explain_top", "4", "--calib_percentile", "10"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["artifact"] == out and line["bytes"] == os.path.getsize(out)
    assert line["calibrated"] and line["explain"] and line["dynamic_batch"]
    assert line["checkpoint"] == os.path.join(run, "3prune0.5000")
    art = texport.load_artifact(out, device="cpu")
    assert art.explain_table["top_e"] == 4
    assert art.explain_table["provenance"]["image_id"] == prov["image_id"]
    assert art.calibration.percentile == 10.0 and art.calibration.num_id_samples == 20
    # JAX's calibrate_from_config on the same weights and folder
    jtrainer, jstate = _jax()
    jcfg = jtrainer.cfg.replace(data=JaxDataConfig(
        train_dir=imgs, test_dir=imgs, train_push_dir=imgs, train_batch_size=6,
        test_batch_size=6, train_push_batch_size=6, num_workers=0))
    want = jcal.calibrate_from_config(jcfg, jtrainer, jstate, percentile=10.0)
    for k in want.thresholds:
        assert abs(art.calibration.thresholds[k] - want.thresholds[k]) <= ATOL, k
    assert art.calibration.source == want.source == f"test_dir={imgs}"
    # the port's calibrate_from_config is what the main embedded
    tcfg = Config(model=trainer.cfg.model, data=DataConfig(
        train_dir=imgs, test_dir=imgs, train_push_dir=imgs, train_batch_size=6,
        test_batch_size=6, train_push_batch_size=6, num_workers=0))
    again = calibrate_from_config(tcfg, trainer, state, percentile=10.0, device="cpu")
    assert again.thresholds == art.calibration.thresholds


def test_state_digest_is_stable_and_sees_every_tensor():
    trainer, state = _port()
    d = state_digest(state)
    assert d == state_digest(state) and len(d) == 64
    orig = state.memory.feats[0, 0, 0].clone()
    with torch.no_grad():
        state.memory.feats[0, 0, 0] += 1.0
    try:
        assert state_digest(state) != d
    finally:
        with torch.no_grad():
            state.memory.feats[0, 0, 0] = orig
    assert state_digest(state) == d
